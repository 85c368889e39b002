"""The port's assembly (node-mode bulk through `node_sweep` + singular and
near COO deltas) against the JAX package's, f64 on the CPU, where
`node_sweep` runs its plain torch version:

- against JAX `assemble_V_K` on its default gather path: atol 1e-11, the
  node-vs-gather class of tests/test_pallas_assemble.py:37 (the two
  summation orders round differently);
- against JAX with backend="pallas_interpret", column_mode="node", i.e. the
  Pallas K1 kernel in interpret mode: atol 1e-12;
- the singular and near COO triplets on two spheres closer than a panel
  diameter (auto-promotion fires), scattered into dense blocks: atol 1e-13.

The K1 kernel itself is tested in tests/test_torch_node_kernel.py."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.ops.assemble as asm_j
from bemstokes_tpu.config import ProblemConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.fem.geometry as geo_t
import bemstokes_tpu_torch.mesh.dofs as dofs_t
import bemstokes_tpu_torch.mesh.factories as fac_t
import bemstokes_tpu_torch.ops.assemble as asm_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT
import torch_threads  # noqa: F401  (one torch thread a test process)


def _setup(refinements):
    mj = fac_j.create_sphere(refinements=refinements)
    mt = fac_t.create_sphere(refinements=refinements)
    sj, st = dofs_j.build_scalar_space(mj, 1), dofs_t.build_scalar_space(mt, 1)
    tj = asm_j.build_assembly_tables(sj, sj, asm_j.AssemblyConfig())
    tt = asm_t.build_assembly_tables(st, st, asm_t.AssemblyConfig())
    ej = jnp.asarray(geo_j.euler_from_mesh(mj.vertices, sj))
    et = torch.as_tensor(geo_t.euler_from_mesh(mt.vertices, st))
    return (ej, geo_j.support_points(ej, sj, sj), tj), (et, geo_t.support_points(et, st, st), tt)


@pytest.fixture(scope="module", params=[2, 3], ids=["sphere2", "sphere3"])
def operators(request):
    jax_in, torch_in = _setup(request.param)
    V, K = asm_t.assemble_V_K(*torch_in)
    return jax_in, torch_in, V.numpy(), K.numpy()


def test_support_points_match(operators):
    (_, spj, _), (_, spt, _), _, _ = operators
    assert np.max(np.abs(np.asarray(spj) - spt.numpy())) < 1e-15


def test_node_column_samples_match(operators):
    (ej, _, tj), (et, _, tt), _, _ = operators
    geo_args = lambda t, e, conv: (
        e[conv(t.cells_nodes_map)],
        conv(t.phi_map), conv(t.dphi_map), conv(t.q_weights), conv(t.flip_sign),
    )
    xj = geo_j.panel_geometry(*geo_args(tj, ej, jnp.asarray))
    xt = geo_t.panel_geometry(*geo_args(tt, et, lambda a: torch.as_tensor(np.asarray(a))))
    sj = asm_j.node_column_samples(tj, *xj)
    st = asm_t.node_column_samples(tt, *xt)
    assert sj[3:] == st[3:] == (4, 16)  # vmax, nq: m = 64 samples per column
    # unit normals and weights round differently in the two packages' norm
    # and cross product: a few ulp of O(1) values
    for a, b in zip(sj[:3], st[:3]):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) < 1e-14


def test_assemble_matches_jax_gather(operators):
    jax_in, _, V, K = operators
    Vj, Kj = asm_j.assemble_V_K(*jax_in)
    assert np.allclose(np.asarray(Vj), V, rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kj), K, rtol=0, atol=1e-11)


def test_assemble_matches_pallas_node_kernel(operators):
    (ej, spj, tj), _, V, K = operators
    pcfg = dataclasses.replace(tj.cfg, backend="pallas_interpret", column_mode="node")
    Vp, Kp = asm_j.assemble_V_K(ej, spj, dataclasses.replace(tj, cfg=pcfg))
    assert np.allclose(np.asarray(Vp), V, rtol=0, atol=1e-12)
    assert np.allclose(np.asarray(Kp), K, rtol=0, atol=1e-12)


@pytest.mark.parametrize("row_range", [(0, 40), (17, 98)])
def test_row_block_matches_full(operators, row_range):
    """A row block assembles the same rows as the whole operator (the
    singular triplets of other rows are dropped by the scatter)."""
    _, (et, spt, tt), V, K = operators
    r0, r1 = row_range
    Vb, Kb = asm_t.assemble_V_K(et, spt, tt, row_range=row_range)
    n, nr = tt.n_nodes, r1 - r0
    rows = np.concatenate([a * n + np.arange(r0, r1) for a in range(3)])
    assert Vb.shape == (3 * nr, 3 * n)
    assert np.allclose(Vb.numpy(), V[rows], rtol=0, atol=1e-15)
    assert np.allclose(Kb.numpy(), K[rows], rtol=0, atol=1e-15)


def _dense(coo, shape):
    ri, ci, dV, dK = (np.asarray(a) for a in coo)
    keep = (ri < shape[0]) & (ci < shape[1])
    out = []
    for vals in (dV, dK):
        M = np.zeros(shape)
        np.add.at(M, (ri[keep], ci[keep]), vals[keep])
        out.append(M)
    return out


@pytest.fixture(scope="module")
def near_contact():
    """Two refinement-2 spheres 0.2 apart: the gap is below the local panel
    diameter, so both problems promote to the adaptive two-level rule."""
    cfg = ProblemConfig()
    mesh_j = fac_j.create_sphere(refinements=2).merged_with(
        fac_j.create_sphere(center=(2.2, 0.0, 0.0), refinements=2)
    )
    mesh_t = fac_t.create_sphere(refinements=2).merged_with(
        fac_t.create_sphere(center=(2.2, 0.0, 0.0), refinements=2)
    )
    pj = ProblemJ(mesh_j, cfg)
    pt = ProblemT(mesh_t, from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert pj.quadrature_promoted and pt.quadrature_promoted
    assert pt.tables.hq_weights is not None
    ej = pj.initial_euler()
    et = pt.initial_euler()
    spj = geo_j.support_points(ej, pj.map_space, pj.fe_space)
    spt = geo_t.support_points(et, pt.map_space, pt.fe_space)
    return (ej, spj, pj), (et, spt, pt)


@pytest.mark.parametrize("row_range", [None, (30, 130)])
def test_near_coo_matches_jax(near_contact, row_range):
    (ej, spj, pj), (et, spt, pt) = near_contact
    n = pt.n
    r0, r1 = row_range or (0, n)
    nr = r1 - r0
    ids_j = jnp.arange(r0, r1, dtype=jnp.int32)
    ids_t = torch.arange(r0, r1)
    cj = asm_j._near_coo(ej, spj, spj[r0:r1], ids_j, pj.tables, nr)
    ct = asm_t._near_coo(et, spt, spt[r0:r1], ids_t, pt.tables, nr)
    shape = (3 * nr, 3 * n)
    for a, b in zip(_dense(cj, shape), _dense(ct, shape)):
        assert np.abs(a).max() > 0
        assert np.allclose(a, b, rtol=0, atol=1e-13)


@pytest.mark.parametrize("subtract_smooth", [False, True])
@pytest.mark.parametrize("row_range", [None, (30, 130)])
def test_singular_coo_matches_jax(near_contact, subtract_smooth, row_range):
    (ej, spj, pj), (et, spt, pt) = near_contact
    n = pt.n
    r0, r1 = row_range or (0, n)
    nr = r1 - r0
    cj = asm_j._singular_coo(ej, spj, pj.tables, r0, nr, subtract_smooth=subtract_smooth)
    ct = asm_t._singular_coo(et, spt, pt.tables, r0, nr, subtract_smooth=subtract_smooth)
    shape = (3 * nr, 3 * n)
    for a, b in zip(_dense(cj, shape), _dense(ct, shape)):
        assert np.abs(a).max() > 0
        assert np.allclose(a, b, rtol=0, atol=1e-13)


def test_near_contact_assembly_matches_jax(near_contact):
    """The whole promoted assembly (far-rule bulk + near + singular deltas)
    against JAX's gather path at the same adaptive rule."""
    (ej, spj, pj), (et, spt, pt) = near_contact
    Vj, Kj = asm_j.assemble_V_K(ej, spj, pj.tables)
    Vt, Kt = asm_t.assemble_V_K(et, spt, pt.tables)
    assert np.allclose(np.asarray(Vj), Vt.numpy(), rtol=0, atol=1e-11)
    assert np.allclose(np.asarray(Kj), Kt.numpy(), rtol=0, atol=1e-11)


def test_scatter_coo_drops_out_of_range():
    M = torch.zeros((3, 4), dtype=torch.float64)
    ri = torch.tensor([0, 2, 3, 1, 0])
    ci = torch.tensor([1, 3, 0, 4, 1])
    asm_t.scatter_coo(M, ri, ci, torch.tensor([1.0, 2.0, 5.0, 7.0, 0.5], dtype=torch.float64))
    expect = np.zeros((3, 4))
    expect[0, 1], expect[2, 3] = 1.5, 2.0
    assert np.array_equal(M.numpy(), expect)
