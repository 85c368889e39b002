"""The 2D assembly of the port (`bemstokes_tpu_torch/ops/assemble.py` with
the plain-torch bulk of `ops/bulk_2d.py`) against the JAX package's
`assemble_V_K` (`backend="jax"`, its XLA path, which is where it keeps 2D on
every platform), f64 on the CPU.

The mesh is the 10-cell unit circle built in code, ordered clockwise (the
reference's `tests/grid_test/circle_0.inp`; the 2D normal is the left
rotation of the tangent and points outward only on a clockwise circle),
refined onto the circle.  V and K agree to 1e-12 of max|.| in node, gather
and scatter modes, Q1 and Q2 (iterated Gauss singular rule), with the
`Telles` and `Duffy` singular types, with adaptive quadrature (the near-pair
upgrade of `_near_coo`) and on a row range.  The 2D matvec
(`ops.matfree_node.sweep_matvec_2d`) equals the JAX package's XLA sweep and
the dense bulk.  The 3D CUDA wrappers refuse points of the plane, and the
image kernels are 3D only."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.ops.assemble as asm_j
import bemstokes_tpu.ops.matfree_node as mfn_j
from bemstokes_tpu.mesh.refine import SphericalManifold as CircleJ, refine_uniform as refine_j
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
import bemstokes_tpu_torch.fem.geometry as geo_t
import bemstokes_tpu_torch.mesh.dofs as dofs_t
import bemstokes_tpu_torch.ops.assemble as asm_t
import bemstokes_tpu_torch.ops.matfree_node as mfn_t
from bemstokes_tpu_torch.mesh.refine import SphericalManifold as CircleT, refine_uniform as refine_t
from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh as MeshT
from bemstokes_tpu_torch.ops import bulk_2d, node_kernel, slot_kernel
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-12


def circle(Mesh, Circle, refine, refinements):
    """The 10-cell unit circle, clockwise, refined onto the circle."""
    th = -2.0 * np.pi * np.arange(10) / 10
    cells = np.stack([np.arange(10), (np.arange(10) + 1) % 10], axis=1)
    mesh = Mesh(np.stack([np.cos(th), np.sin(th)], axis=1), cells, np.zeros(10, np.int32))
    return refine(mesh, Circle((0.0, 0.0)), times=refinements) if refinements else mesh


#: a shear that breaks the circle's exact ties between panel-centre
#: distances (`jax.lax.top_k` breaks such ties otherwise than a stable sort)
SHEAR = np.array([[1.0, 0.13], [-0.05, 1.07]])


def _inputs(mode, degree=1, refinements=2, shear=False, **kw):
    """((euler, support points, tables) of the JAX package, the same of the
    port) on the circle refined `refinements` times (sheared with
    `shear`)."""
    mj = circle(MeshJ, CircleJ, refine_j, refinements)
    mt = circle(MeshT, CircleT, refine_t, refinements)
    sj, st = dofs_j.build_scalar_space(mj, degree), dofs_t.build_scalar_space(mt, degree)
    # one row tile and one column chunk: the JAX package's XLA loops then
    # compile in a fraction of a second (the port reads neither field)
    cfg = dict(dim=2, column_mode=mode, row_tile=128, cell_chunk=128, **kw)
    tj = asm_j.build_assembly_tables(sj, sj, asm_j.AssemblyConfig(backend="jax", dtype=jnp.float64, **cfg))
    tt = asm_t.build_assembly_tables(st, st, asm_t.AssemblyConfig(**cfg))
    e = geo_t.euler_from_mesh(mt.vertices, st, CircleT((0.0, 0.0)))
    if shear:
        e = e @ SHEAR.T
    ej, et = jnp.asarray(e), torch.as_tensor(e)
    return (ej, geo_j.support_points(ej, sj, sj), tj), (et, geo_t.support_points(et, st, st), tt)


def _close(a_j, a_t, tol=TOL):
    a_j, a_t = np.asarray(a_j), a_t.numpy()
    assert a_j.shape == a_t.shape
    err = np.max(np.abs(a_j - a_t)) / np.max(np.abs(a_j))
    assert err <= tol, err


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("mode", ["node", "gather", "scatter"])
def test_V_K_match_jax(mode, degree):
    jax_in, port_in = _inputs(mode, degree)
    Vj, Kj = asm_j.assemble_V_K(*jax_in)
    Vt, Kt = asm_t.assemble_V_K(*port_in)
    assert Vt.shape == (2 * port_in[2].n_nodes,) * 2
    _close(Vj, Vt)
    _close(Kj, Kt)


@pytest.mark.parametrize("singular_type", ["Telles", "Duffy"])
def test_singular_types_match_jax(singular_type):
    jax_in, port_in = _inputs("gather", singular_quadrature_type=singular_type, singular_quadrature_order=7)
    for a_j, a_t in zip(asm_j.assemble_V_K(*jax_in), asm_t.assemble_V_K(*port_in)):
        _close(a_j, a_t)


@pytest.mark.parametrize("degree", [1, 2])
def test_adaptive_quadrature_matches_jax(degree):
    """quad_order_far set: a far rule of order 2 everywhere, each row's 4
    nearest panels upgraded to order 5 (`_near_coo`), on the sheared circle
    (on the circle itself the panels beside a node tie in distance)."""
    jax_in, port_in = _inputs("gather", degree, shear=True, quad_order=5, quad_order_far=2, near_panels=4)
    assert port_in[2].hq_weights is not None
    for a_j, a_t in zip(asm_j.assemble_V_K(*jax_in), asm_t.assemble_V_K(*port_in)):
        _close(a_j, a_t)


def test_row_range_matches_jax():
    jax_in, port_in = _inputs("gather", degree=2, refinements=1)
    for a_j, a_t in zip(asm_j.assemble_V_K(*jax_in, row_range=(7, 23)), asm_t.assemble_V_K(*port_in, row_range=(7, 23))):
        _close(a_j, a_t)


def test_bulk_tiles_change_no_result(monkeypatch):
    """Row tiles of one row and column chunks of one node give the one-tile
    result, in every mode."""
    _, (e, sp, tables) = _inputs("node", refinements=1)
    space = dofs_t.build_scalar_space(circle(MeshT, CircleT, refine_t, 1), 1)
    whole = {}
    for mode in ("node", "gather", "scatter"):
        t = asm_t.build_assembly_tables(space, space, asm_t.AssemblyConfig(dim=2, column_mode=mode))
        whole[mode] = (t, asm_t.assemble_V_K(e, sp, t))
    monkeypatch.setattr(bulk_2d, "TILE_ELEMS", 12)
    assert bulk_2d._tiles(20, 20, 8) == (1, 1)
    for mode, (t, (V, K)) in whole.items():
        V1, K1 = asm_t.assemble_V_K(e, sp, t)
        torch.testing.assert_close(V1, V, rtol=1e-14, atol=1e-14)
        torch.testing.assert_close(K1, K, rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("widths", [(1, 1), (1, 0), (0, 1), (2, 5)])
def test_sweep_matvec_2d_matches_jax_and_the_bulk(widths):
    """The 2D operator action against the JAX package's XLA sweep on the same
    seeded columns, and against the node-mode bulk times the columns."""
    (ej, spj, tj), (et, spt, tt) = _inputs("node", refinements=2)
    BV, BK = widths
    n = tt.n_nodes
    rng = np.random.default_rng(4)
    XV, XK = rng.normal(size=(2 * n, BV)), rng.normal(size=(2 * n, BK))
    geom_j = geo_j.panel_geometry(
        ej[jnp.asarray(tj.cells_nodes_map)], jnp.asarray(tj.phi_map), jnp.asarray(tj.dphi_map),
        jnp.asarray(tj.q_weights), jnp.asarray(tj.flip_sign), ambient_dim=2,
    )
    st_j, arrs_j = mfn_j.build_sweep(tj, spj, *geom_j, backend="xla")
    VX_j, KX_j = mfn_j.sweep_matvec(st_j, arrs_j, jnp.asarray(XV), jnp.asarray(XK))
    st_t, arrs_t = mfn_t.build_sweep(tt, spt, *asm_t.smooth_panel_geometry(et, tt))
    VX_t, KX_t = mfn_t.sweep_matvec_2d(st_t, arrs_t, torch.as_tensor(XV), torch.as_tensor(XK))
    assert VX_t.shape == (2 * n, BV) and KX_t.shape == (2 * n, BK)
    V, K = bulk_2d.node_bulk(*asm_t.node_sweep_inputs(et, spt, tt))
    for a_j, a_t, M, X in ((VX_j, VX_t, V, XV), (KX_j, KX_t, K, XK)):
        if X.shape[1]:
            _close(a_j, a_t)
            _close(M.numpy() @ X, a_t)
    # one column as a 1-D vector comes back 1-D
    v, k = mfn_t.sweep_matvec_2d(st_t, arrs_t, torch.as_tensor(XV[:, 0] if BV else XK[:, 0]), torch.zeros((2 * n, 0), dtype=torch.float64))
    assert v.shape == (2 * n,) and k.shape == (2 * n, 0)


def test_image_kernels_are_3d_only():
    """The JAX package asserts dim == 3 in its image kernels
    (`bemstokes_tpu/kernels/images.py:72`); the port raises ValueError."""
    _, (e, sp, tables) = _inputs("node", refinements=1)
    space = dofs_t.build_scalar_space(circle(MeshT, CircleT, refine_t, 1), 1)
    for kernel in ("free_surface", "no_slip"):
        t = asm_t.build_assembly_tables(space, space, asm_t.AssemblyConfig(dim=2, kernel=kernel))
        with pytest.raises(ValueError, match="3D only"):
            asm_t.assemble_V_K(e, sp, t)
        with pytest.raises(ValueError, match="no 2D sweep"):
            mfn_t.sweep_static(t, 20)


def test_3d_wrappers_refuse_points_of_the_plane():
    """`node_sweep`, `tile_slots`, `tile_nodes` and `sweep_matvec` are 3D:
    a 2D input raises, naming the 2D route, and never runs the plain
    version."""
    _, (e, sp, tables) = _inputs("node", refinements=1)
    xi, Yj, Nj, Wj = asm_t.node_sweep_inputs(e, sp, tables)
    with pytest.raises(ValueError, match="ops/bulk_2d.py"):
        node_kernel.node_sweep(xi, Yj, Nj, Wj)
    xq, nrm, wphi = asm_t.slot_inputs(e, tables)
    keep = slot_kernel.own_cell_keep(tables.cells_nodes_fe, torch.arange(xi.shape[0]), xi)
    with pytest.raises(ValueError, match="ops/bulk_2d.py"):
        slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)
    st, arrs = mfn_t.build_sweep(tables, sp, *asm_t.smooth_panel_geometry(e, tables))
    with pytest.raises(ValueError, match="ops/bulk_2d.py"):
        mfn_t.sweep_matvec(st, arrs, torch.zeros(2 * st.n), torch.zeros(2 * st.n))


@pytest.mark.cuda
def test_node_sweep_on_the_card_refuses_points_of_the_plane():
    """On a CUDA tensor a 2D input raises before anything launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, (e, sp, tables) = _inputs("node", refinements=1)
    xi, Yj, Nj, Wj = (t.cuda() for t in asm_t.node_sweep_inputs(e, sp, tables))
    before = dict(node_kernel.launches)
    with pytest.raises(ValueError, match="ops/bulk_2d.py"):
        node_kernel.node_sweep(xi, Yj, Nj, Wj)
    assert node_kernel.launches == before
