"""The torus families of the JAX package's tests/test_torus_spiral_parity.py
(the reference's `baricenter_torus.cc` and `origin_rigid_modes.cc`), which
read the reference's torus_0.inp, on a torus built here: major radius 12,
minor radius 3, f64 on the CPU, each result held against the
JAX package's on the same inputs.

- Surface measure and centre of mass (Q1 map, quadrature 4) on 64 x 24 and
  128 x 48 quads: the port's are the JAX package's to 1e-12 relative; the
  flat quads cut the tube's curvature, so the measure lies below the exact
  4 pi^2 R r by 3.85e-3 and 9.6e-4 (measured; second order in the cell
  size), held to 5e-3 and to the JAX test's 2e-3; the centre of mass is the
  origin to 1e-12 of R.
- The six rigid modes about the origin at the support points are exactly
  (1,0,0), (0,1,0), (0,0,1), (0,-z,y), (z,0,-x), (-y,x,0), to 1e-12, in both
  packages.
- One imposed-velocity frame of the torus translating along its axis (a
  closed surface of genus one: the V null-space and K solid-angle
  corrections and the L2 normal off the sphere), against the JAX package's
  to 1e-10 relative.

The spiral gait of that file waits for the reference's spiral_*.msh frames.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.fem.geometry as geo_j
import bemstokes_tpu.mesh.dofs as dofs_j
import bemstokes_tpu.ops.assemble as asm_j
import bemstokes_tpu.physics.rigid as rigid_j
from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.physics.rigid as rigid_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
from bemstokes_tpu_torch.mesh import build_scalar_space
from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh
from bemstokes_tpu_torch.ops import AssemblyConfig, build_assembly_tables
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

R, RT = 12.0, 3.0  # major and minor radius
EXACT_MASS = 4.0 * np.pi**2 * R * RT


def make_torus(nu=64, nv=24, major=R, minor=RT):
    """A closed quad torus about the z axis; each cell's corners in the
    lexicographic order (0,0), (1,0), (0,1), (1,1) of its (u, v) patch, with
    u along the tube and v around it, so that t_u x t_v points outward."""
    u = 2 * np.pi * np.arange(nu) / nu
    v = 2 * np.pi * np.arange(nv) / nv
    U, Vv = np.meshgrid(u, v, indexing="ij")
    ring = major + minor * np.cos(Vv)
    verts = np.stack([ring * np.cos(U), ring * np.sin(U), minor * np.sin(Vv)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    ip, jp = (i + 1) % nu, (j + 1) % nv
    cells = np.stack([i * nv + j, ip * nv + j, i * nv + jp, ip * nv + jp], 1).astype(np.int32)
    return verts, cells


def _meshes(nu=64, nv=24):
    verts, cells = make_torus(nu, nv)
    mat = np.zeros(len(cells), np.int32)
    return MeshJ(verts, cells, mat), SurfaceMesh(verts, cells, mat)


def mass_and_com(nu, nv):
    """(mass, com) of each package on the nu x nv torus, Q1 map."""
    mj, mt = _meshes(nu, nv)
    out = []
    for mesh, dofs, asm, geo, rigid, arr in (
        (mj, dofs_j, asm_j, geo_j, rigid_j, jnp.asarray),
        (mt, None, None, None, rigid_t, torch.as_tensor),
    ):
        if dofs is None:
            space = build_scalar_space(mesh, 1)
            tables = build_assembly_tables(space, space, AssemblyConfig(quad_order=4))
            euler = arr(euler_from_mesh(mesh.vertices, space))
        else:
            space = dofs.build_scalar_space(mesh, 1)
            tables = asm.build_assembly_tables(space, space, asm.AssemblyConfig(quad_order=4, dtype=jnp.float64))
            euler = arr(geo.euler_from_mesh(mesh.vertices, space))
        _, (xq, _, jxw) = rigid.build_mass_operator(euler, tables)
        mass, com = rigid.surface_mass_and_com(xq, jxw)
        out.append((float(mass), np.asarray(com)))
    return out


@pytest.mark.parametrize("nu,nv,tol", [(64, 24, 5e-3), (128, 48, 2e-3)])
def test_torus_mass_and_centre(nu, nv, tol):
    (mass_j, com_j), (mass_t, com_t) = mass_and_com(nu, nv)
    assert abs(mass_t - mass_j) <= 1e-12 * mass_j
    assert np.max(np.abs(com_t - com_j)) <= 1e-12 * R
    assert 0 < (EXACT_MASS - mass_t) / EXACT_MASS < tol
    assert np.max(np.abs(com_t)) <= 1e-12 * R


def test_torus_is_closed_and_outward():
    """One closed component, and the divergence theorem gives the solid
    torus's volume 2 pi^2 R r^2 (positive: the normals point outward)."""
    from bemstokes_tpu_torch.mesh.surface_mesh import cell_components_and_closedness

    _, mesh = _meshes()
    _, closed = cell_components_and_closedness(mesh)
    assert closed.tolist() == [True]
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(space, space, AssemblyConfig(quad_order=4))
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space))
    _, (xq, nrm, jxw) = rigid_t.build_mass_operator(euler, tables)
    volume = float(torch.einsum("cq,cqd,cqd->", jxw, xq, nrm)) / 3.0
    assert volume == pytest.approx(2 * np.pi**2 * R * RT**2, rel=2e-2)


def test_origin_rigid_modes_exact():
    mj, mt = _meshes()
    sj = dofs_j.build_scalar_space(mj, 1)
    ej = jnp.asarray(geo_j.euler_from_mesh(mj.vertices, sj))
    pts_j = np.asarray(geo_j.support_points(ej, sj, sj))
    Nj = np.asarray(rigid_j.rigid_modes(jnp.asarray(pts_j), jnp.zeros(3)))
    st = build_scalar_space(mt, 1)
    et = torch.as_tensor(euler_from_mesh(mt.vertices, st))
    pts = support_points(et, st, st)
    N = rigid_t.rigid_modes(pts, torch.zeros(3, dtype=torch.float64)).numpy()
    x, y, z = pts.numpy().T
    zero, one = np.zeros_like(x), np.ones_like(x)
    exact = np.stack(
        [
            np.stack([one, zero, zero], -1),
            np.stack([zero, one, zero], -1),
            np.stack([zero, zero, one], -1),
            np.stack([zero, -z, y], -1),
            np.stack([z, zero, -x], -1),
            np.stack([-y, x, zero], -1),
        ]
    )
    assert np.max(np.abs(N - exact)) < 1e-12
    assert np.max(np.abs(Nj - exact)) < 1e-12
    assert np.max(np.abs(N - Nj)) < 1e-12


def test_torus_translation_frame_matches_jax():
    """The torus translating along its axis, one frame on a coarser torus
    (24 x 6 quads, 144 nodes)."""
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=2,
        force_pole="Origin",
        solver=SolverConfig(solve_directly=True),
    )
    mj, mt = _meshes(24, 6)
    pj = ProblemJ(mj, cfg)
    rj = pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))
    pt = ProblemT(mt, from_dict(dataclasses.asdict(cfg)), device="cpu")
    rt = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
    for key in ("rigid_forces_pole", "rigid_velocities", "stokes_forces"):
        a = np.asarray(rj[key])
        assert np.max(np.abs(a - rt[key])) <= 1e-10 * np.max(np.abs(a)), key
    F = rt["rigid_forces_pole"]
    # axial drag only: no side force or torque by symmetry
    assert abs(F[2]) > 1.0
    assert np.max(np.abs(F[[0, 1, 3, 4, 5]])) <= 1e-8 * abs(F[2])
