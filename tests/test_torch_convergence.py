"""`bemstokes_tpu_torch/convergence.py` against the JAX package's
`bemstokes_tpu/convergence.py`, f64: the fundamental-solution recovery
study on create_sphere(0) (8 nodes) refined onto the unit sphere twice
(26, 98 nodes), source inside at (0.3, 0.3, 0.3).  Errors and rates agree
to 1e-10 relative (the same assembly and the same unpreconditioned GMRES
of the Dirichlet-to-Neumann map, rounded in different orders), and the
printed tables are equal character for character."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.convergence as conv_j
import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.mesh.refine import SphericalManifold as SphereJ
import bemstokes_tpu_torch.convergence as conv_t
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.mesh.refine import SphericalManifold as SphereT
import torch_threads  # noqa: F401  (one torch thread a test process)

SOURCE = (0.3, 0.3, 0.3)


@pytest.fixture(scope="module")
def studies():
    rows_j = conv_j.convergence_study(
        fac_j.create_sphere(refinements=0), 3, SOURCE, n_cycles=3, manifold=SphereJ((0.0, 0.0, 0.0))
    )
    rows_t = conv_t.convergence_study(
        fac_t.create_sphere(refinements=0), 3, SOURCE, n_cycles=3, manifold=SphereT((0.0, 0.0, 0.0)), device="cpu"
    )
    return rows_j, rows_t


def test_study_matches_jax(studies):
    rows_j, rows_t = studies
    assert [(r.cycle, r.n_nodes) for r in rows_t] == [(r.cycle, r.n_nodes) for r in rows_j] == [
        (0, 8), (1, 26), (2, 98)
    ]
    for rj, rt in zip(rows_j, rows_t):
        assert abs(rt.error - rj.error) <= 1e-10 * rj.error
        assert (rt.rate is None) == (rj.rate is None)
        if rj.rate is not None:
            assert abs(rt.rate - rj.rate) <= 1e-10 * max(1.0, abs(rj.rate))
    # the recovery error falls with refinement
    assert rows_t[2].error < rows_t[1].error and rows_t[2].rate > 0


def test_format_table_matches_jax(studies):
    rows_j, rows_t = studies
    table = conv_t.format_table(rows_t)
    assert table == conv_j.format_table(rows_j)
    assert table.splitlines()[0] == "cycle  nodes     L2 error      rate"


@pytest.mark.parametrize("component", [0, 2])
def test_green_recovery_error_matches_jax(component):
    """One cycle with another Stokeslet direction and quadrature orders."""
    kw = dict(component=component, quad_order=3, sing_order=6)
    err_j, n_j = conv_j.green_recovery_error(fac_j.create_sphere(refinements=1), 3, (0.1, -0.2, 0.15), **kw)
    err_t, n_t = conv_t.green_recovery_error(
        fac_t.create_sphere(refinements=1), 3, (0.1, -0.2, 0.15), device="cpu", **kw
    )
    assert n_t == n_j == 26
    assert abs(err_t - err_j) <= 1e-10 * err_j


def test_default_device_is_the_card():
    mesh = fac_t.create_sphere(refinements=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            conv_t.green_recovery_error(mesh, 3, SOURCE)


# ---- 2D: the fundamental-solution recovery on the circle --------------------
# (tests/test_green_recovery.py:76-87 on its 10-cell circle read from the
# reference's mesh files; here the same circle is built in code, ordered clockwise,
# and refined once onto the circle; source (0.1, 0.2), quadrature orders 8
# and 10)

CIRCLE_SOURCE = (0.1, 0.2)


def _circle(Mesh, cells=10):
    th = -2.0 * np.pi * np.arange(cells) / cells
    lines = np.stack([np.arange(cells), (np.arange(cells) + 1) % cells], axis=1)
    return Mesh(np.stack([np.cos(th), np.sin(th)], axis=1), lines, np.zeros(cells, np.int32))


@pytest.fixture(scope="module")
def circle_studies():
    from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
    from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh as MeshT

    kw = dict(n_cycles=2, quad_order=8, sing_order=10)
    rows_j = conv_j.convergence_study(_circle(MeshJ), 2, CIRCLE_SOURCE, manifold=SphereJ((0.0, 0.0)), **kw)
    rows_t = conv_t.convergence_study(
        _circle(MeshT), 2, CIRCLE_SOURCE, manifold=SphereT((0.0, 0.0)), device="cpu", **kw
    )
    return rows_j, rows_t


@pytest.mark.parametrize("cycle", [0, 1], ids=["10_cells", "20_cells"])
def test_circle_green_recovery_matches_jax(circle_studies, cycle):
    rows_j, rows_t = circle_studies
    rj, rt = rows_j[cycle], rows_t[cycle]
    assert rt.n_nodes == rj.n_nodes == 10 * 2**cycle
    assert abs(rt.error - rj.error) <= 1e-10 * rj.error
    if cycle == 0:
        assert rt.error < 0.15, rt.error  # the 10-cell circle
    else:
        assert rt.error < 0.5 * rows_t[0].error  # the refined circle converges
        assert abs(rt.rate - rj.rate) <= 1e-10 * abs(rj.rate)


def test_circle_table_matches_jax(circle_studies):
    rows_j, rows_t = circle_studies
    assert conv_t.format_table(rows_t) == conv_j.format_table(rows_j)

