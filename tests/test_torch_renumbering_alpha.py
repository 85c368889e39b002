"""The JAX package's tests/test_renumbering_alpha.py (the reference's
`dof_renumbering.cc` and `alpha_test_quad_order.cc`), which read a reference
grid file, rebuilt on create_sphere(2) (98 nodes, 294 unknowns, the size of
that file) and run on the port, f64 on the CPU, each result held against the
JAX package's on the same inputs:

- the assembled V and K are invariant under a renumbering of the mesh's
  vertices: the permuted operators equal the original ones to 1e-12 (as
  there), and each equals the JAX package's `assemble_V_K` to 1e-11 (the
  class of tests/test_torch_assemble.py: the summation orders differ);
- K . e = 1 after the solid-angle correction at quadrature orders 2, 4 and 6
  (to 1e-12, as there), and the V null-space residual before the
  correction stable in the order (within 10 % from order 4 to 6, as there;
  2.32e-3 / 2.36e-3 / 2.36e-3, measured), equal to the JAX package's to 1e-9
  relative;
- the drag under the Mixed, Duffy and Telles singular rules (order 7)
  agrees to 2e-3 (as there), each equal to the JAX package's to 1e-10.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.mesh.factories as fac_j
import bemstokes_tpu.ops.assemble as asm_j
from bemstokes_tpu.config import ProblemConfig, QuadratureConfig, SolverConfig
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
from bemstokes_tpu_torch.mesh import build_scalar_space
from bemstokes_tpu_torch.mesh.factories import create_sphere
from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh
from bemstokes_tpu_torch.ops import AssemblyConfig, assemble_V_K, build_assembly_tables
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

ASSEMBLY = dict(quad_order=3, singular_quadrature_type="Mixed", singular_quadrature_order=5)


def _assemble(mesh):
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(space, space, AssemblyConfig(**ASSEMBLY))
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space))
    V, K = assemble_V_K(euler, support_points(euler, space, space), tables)
    return V.numpy(), K.numpy(), space.n_nodes


def _assemble_jax(mesh):
    mesh = MeshJ(mesh.vertices, mesh.cells, mesh.material_id)
    space = dofs_j.build_scalar_space(mesh, 1)
    tables = asm_j.build_assembly_tables(space, space, asm_j.AssemblyConfig(**ASSEMBLY))
    euler = jnp.asarray(geo_j.euler_from_mesh(mesh.vertices, space))
    V, K = asm_j.assemble_V_K(euler, geo_j.support_points(euler, space, space), tables)
    return np.asarray(V), np.asarray(K)


def _permuted(mesh, seed=5):
    perm = np.random.default_rng(seed).permutation(mesh.n_vertices)  # old id -> new id
    verts = np.empty_like(mesh.vertices)
    verts[perm] = mesh.vertices
    return SurfaceMesh(verts, perm[mesh.cells].astype(np.int32), mesh.material_id.copy()), perm


@pytest.mark.parametrize("renumbered", [False, True], ids=["original", "renumbered"])
def test_assembly_invariant_under_renumbering(renumbered):
    mesh = create_sphere(refinements=2)
    V0, K0, n = _assemble(mesh)
    if not renumbered:
        Vj, Kj = _assemble_jax(mesh)
        assert np.allclose(V0, Vj, rtol=0, atol=1e-11) and np.allclose(K0, Kj, rtol=0, atol=1e-11)
        return
    mesh2, perm = _permuted(mesh)
    V1, K1, n2 = _assemble(mesh2)
    assert n2 == n
    # component-blocked flat index map: (a, i) -> a * n + perm[i]
    p = np.concatenate([a * n + perm for a in range(3)])
    assert np.allclose(V1[np.ix_(p, p)], V0, atol=1e-12)
    assert np.allclose(K1[np.ix_(p, p)], K0, atol=1e-12)
    Vj, Kj = _assemble_jax(mesh2)
    assert np.allclose(V1, Vj, rtol=0, atol=1e-11) and np.allclose(K1, Kj, rtol=0, atol=1e-11)


def _frame(quadrature):
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        quadrature=quadrature,
        solver=SolverConfig(solve_directly=True),
    )
    pj = ProblemJ(fac_j.create_sphere(refinements=2), cfg)
    rj = pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))
    pt = ProblemT(create_sphere(refinements=2), from_dict(dataclasses.asdict(cfg)), device="cpu")
    rt = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
    return rj, rt


@pytest.fixture(scope="module")
def by_order():
    return {order: _frame(QuadratureConfig(order=order)) for order in (2, 4, 6)}


@pytest.mark.parametrize("order", [2, 4, 6])
def test_k_versor_check_across_quad_orders(by_order, order):
    rj, rt = by_order[order]
    k_check = np.asarray(rt["diagnostics"]["k_solid_angle_check"])
    assert np.allclose(k_check, 1.0, atol=1e-12), k_check
    r_t = float(rt["diagnostics"]["v_null_residual_pre"])
    r_j = float(rj["diagnostics"]["v_null_residual_pre"])
    assert abs(r_t - r_j) <= 1e-9 * r_j
    assert 1e-3 < r_t < 4e-3
    r4 = float(by_order[4][1]["diagnostics"]["v_null_residual_pre"])
    r6 = float(by_order[6][1]["diagnostics"]["v_null_residual_pre"])
    assert abs(r6 - r4) < 0.1 * r4


@pytest.fixture(scope="module")
def by_rule():
    return {
        rule: _frame(QuadratureConfig(order=4, singular_type=rule, singular_order=7))
        for rule in ("Mixed", "Duffy", "Telles")
    }


@pytest.mark.parametrize("rule", ["Mixed", "Duffy", "Telles"])
def test_drag_stable_across_singular_rules(by_rule, rule):
    rj, rt = by_rule[rule]
    drag_t = abs(float(rt["rigid_forces_pole"][0]))
    drag_j = abs(float(np.asarray(rj["rigid_forces_pole"])[0]))
    assert abs(drag_t - drag_j) <= 1e-10 * drag_j
    drag_mixed = abs(float(by_rule["Mixed"][1]["rigid_forces_pole"][0]))
    assert drag_t == pytest.approx(drag_mixed, rel=2e-3)
