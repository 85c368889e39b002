"""Meshed walls of every boundary-condition kind on the port, f64 on the CPU,
against the JAX package on the same inputs: the twins of the JAX package's
tests/test_image_kernel_solves.py:170-300 (which read a reference grid file
absent here), on meshes built in code.

The column mask (`ops/monolithic.py:operator_column_mask`) picks, per flat
column, the unknown the boundary condition leaves free:
- body, no-slip and dirichlet wall: the traction (V columns);
- neumann wall: the velocity (-K columns);
- free-surface wall: the traction along the wall normal, the velocity along
  the wall (V for the normal component, -K for the tangential ones);
- do-nothing wall: the reverse of the free surface.

The body is create_sphere(2) (98 nodes) where the JAX tests take the
reference's unrefined sphere; each wall is `create_wall`'s 2 x 2 plate (9
nodes).  Each solve runs in both packages from the same ProblemConfig
(`from_dict`) on the same mesh: rigid forces and velocities, the traction
and wall-velocity unknowns to 1e-10 relative, the masks equal.  The physical
checks are the JAX tests' own, with their bounds.

The coarse plates' panels are wider than their gap to the sphere, so the
quadrature auto-promotes and the near-pair delta runs.  Its panel selection
meets exact distance ties on these symmetric meshes, which the JAX
package's jitted `lax.top_k` breaks otherwise than the port's stable sort
(1.8e-9 in K): every vertex is moved by a seeded 1e-6 jitter, which leaves
no tie and no visible change in the physics.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bemstokes_tpu.config import ProblemConfig, SolverConfig, WallConfig
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.mesh.surface_mesh import (
    MATERIAL_WALL_DIRICHLET,
    MATERIAL_WALL_DO_NOTHING,
    MATERIAL_WALL_FREE_SURFACE,
    MATERIAL_WALL_NEUMANN,
    SurfaceMesh,
)
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-10
KEYS = ("rigid_forces_pole", "rigid_velocities", "stokes_forces", "wall_velocities")
STOKES = 6.0 * np.pi


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def wall(kind, position, span):
    return WallConfig(enabled=True, wall_type=kind, position=position, span=span)


def config(*walls, **kw):
    """The sphere translating along x (ImposedVelocity) beside `walls`."""
    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        walls=walls,
        solver=SolverConfig(solve_directly=True),
        **kw,
    )


#: the three walls of the JAX package's mixed-BC test, and a free surface
MIXED = (
    wall("dirichlet", (0.0, -8.0, 0.0), (8.0, 0.0, 8.0)),
    wall("neumann", (0.0, 8.0, 0.0), (8.0, 0.0, 8.0)),
    wall("do_nothing", (8.0, 0.0, 0.0), (0.0, 8.0, 8.0)),
)
FREE_SURFACE_Z = wall("free_surface", (0.0, 0.0, -8.0), (8.0, 8.0, 0.0))


def meshes(cfg_t):
    """create_sphere(2) with the walls of the port's config attached, every
    vertex jittered by 1e-6 (seeded), as each package's SurfaceMesh."""
    m = fac_t.add_walls_to_mesh(fac_t.create_sphere(refinements=2), cfg_t)
    v = m.vertices + 1e-6 * np.random.default_rng(7).standard_normal(m.vertices.shape)
    return (
        MeshJ(v, m.cells, m.material_id, m.flip_normal, m.edge_midpoints),
        SurfaceMesh(v, m.cells, m.material_id, m.flip_normal, m.edge_midpoints),
    )


def solve_both(cfg):
    """One frame of each package on `meshes(cfg)`; the port's problem and
    both results."""
    cfg_t = from_dict(dataclasses.asdict(cfg))
    mj, mt = meshes(cfg_t)
    pj = ProblemJ(mj, cfg)
    pt = ProblemT(mt, cfg_t, device="cpu")
    assert pt.quadrature_promoted == pj.quadrature_promoted
    rj = pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))
    rt = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
    assert pt.n == pj.n
    np.testing.assert_array_equal(pt.node_material, np.asarray(pj.node_material))
    sel_j = np.asarray(rj["operators"]["sel_V"])
    sel_t = np.asarray(rt["operators"]["sel_V"])
    np.testing.assert_array_equal(sel_t, sel_j)
    for key in KEYS:
        assert _rel(rt[key], rj[key]) <= TOL, key
    assert rt["residual"] < 1e-8 and float(rj["residual"]) < 1e-8
    return pt, rj, rt


def drag(res):
    return abs(float(np.asarray(res["rigid_forces_pole"])[0]))


def test_resolved_no_slip_wall_monotonicity():
    """A meshed no-slip wall: the drag exceeds free space's and falls
    monotonically toward it as the wall recedes, and is within 5 % of
    Stokes' law at distance 30.  Free space is the same sphere without a
    wall (the JAX test takes 6 pi; the 98-node sphere's own drag is 0.45 %
    under it, and the wall at 30 adds less than that)."""
    _, rj, rt = solve_both(config())
    assert abs(drag(rt) - drag(rj)) <= TOL * drag(rj)
    free = drag(rt)
    drags = []
    for dist in (8.0, 16.0, 30.0):
        _, rj, rt = solve_both(config(wall("no_slip", (0.0, -dist, 0.0), (8.0, 0.0, 8.0))))
        assert abs(drag(rt) - drag(rj)) <= TOL * drag(rj)
        drags.append(drag(rt))
    assert drags[0] > drags[1] > drags[2] > free
    assert drags[2] == pytest.approx(STOKES, rel=0.05)


@pytest.mark.parametrize("free_surface", [False, True], ids=["three_walls", "four_walls"])
def test_mixed_bc_wall_column_branches(free_surface):
    """Dirichlet, neumann and do-nothing walls (and a meshed free surface)
    in one solve: every branch of the column mask is populated, tractions
    are the unknown on V columns and velocities on -K columns, and the
    distant walls leave the drag above free space's and below twice it."""
    walls = MIXED + ((FREE_SURFACE_Z,) if free_surface else ())
    prob, rj, rt = solve_both(config(*walls))
    sel = np.asarray(rt["operators"]["sel_V"])
    forces, wall_vel = rt["stokes_forces"], rt["wall_velocities"]
    assert np.all(forces[~sel] == 0) and np.all(wall_vel[sel] == 0)
    mats = np.tile(prob.node_material, 3)
    assert np.any(sel & (mats == MATERIAL_WALL_DIRICHLET))
    assert np.any(~sel & (mats == MATERIAL_WALL_NEUMANN))
    assert np.any(sel & (mats == MATERIAL_WALL_DO_NOTHING))
    assert np.any(~sel & (mats == MATERIAL_WALL_DO_NOTHING))
    if free_surface:
        assert np.any(sel & (mats == MATERIAL_WALL_FREE_SURFACE))
        assert np.any(~sel & (mats == MATERIAL_WALL_FREE_SURFACE))
    assert np.all(np.isfinite(wall_vel)) and np.abs(wall_vel).max() > 1e-8
    assert STOKES < drag(rt) < 2.0 * STOKES


@pytest.fixture(scope="module")
def single_walls():
    """Each meshed wall kind alone at distance 8, in both packages."""
    return {
        kind: solve_both(config(wall(kind, (0.0, -8.0, 0.0), (8.0, 0.0, 8.0))))
        for kind in ("dirichlet", "neumann", "do_nothing", "free_surface")
    }


@pytest.mark.parametrize("kind", ["dirichlet", "neumann", "do_nothing", "free_surface"])
def test_single_wall_type_drags_physical(single_walls, kind):
    """Each wall kind alone: the drag stays in a physical band above Stokes'
    law, and the rigid (dirichlet) wall blocks more than the traction-free
    (neumann) one."""
    _, rj, rt = single_walls[kind]
    assert abs(drag(rt) - drag(rj)) <= TOL * drag(rj)
    assert STOKES < drag(rt) < 1.25 * STOKES, (kind, drag(rt))
    assert drag(single_walls["dirichlet"][2]) > drag(single_walls["neumann"][2])


def test_matrix_free_mixed_walls_match_jax():
    """The four wall kinds, matrix-free (blocks of 64, GMRES to 1e-11): the
    matvec sweeps V and K together (the two-sided launch on the card), the
    port equals the JAX package's matrix-free frame (1e-8, equal
    iterations, as tests/test_torch_matfree.py holds it) and its own
    materialized frame (1e-7)."""
    from bemstokes_tpu_torch.matfree import MatfreeSolver

    walls = MIXED + (FREE_SURFACE_Z,)
    out = {}
    for name, mf in (("jax", True), ("mf", True), ("mat", False)):
        cfg = ProblemConfig(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            walls=walls,
            matrix_free=mf,
            matfree_block_nodes=64,
            solver=SolverConfig(preconditioner_type="Direct", tolerance=1e-11),
        )
        cfg_t = from_dict(dataclasses.asdict(cfg))
        mj, mt = meshes(cfg_t)
        if name == "jax":
            pj = ProblemJ(mj, cfg)
            out[name] = pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))
            continue
        pt = ProblemT(mt, cfg_t, device="cpu")
        out[name] = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
        if mf:
            assert isinstance(pt._matfree, MatfreeSolver)
            sys, _, _ = pt._matfree._setup(pt.initial_euler(), np.zeros(3 * pt.n), None)
            assert sys["side"] == "both"
    rj, rt, rm = out["jax"], out["mf"], out["mat"]
    for key in ("rigid_velocities", "stokes_forces", "wall_velocities"):
        assert _rel(rt[key], rj[key]) <= 1e-8, key
        assert _rel(rt[key], rm[key]) <= 1e-7, key
    assert rt["iterations"] == int(rj["iterations"])
    assert rt["converged"] and rj["converged"]
