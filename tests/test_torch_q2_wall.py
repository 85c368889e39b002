"""A Q2 map on the refined (hanging-node) no-slip wall of
tests/test_torch_walls_refined.py without an exact-radius manifold (the JAX
package's tests/test_wall_refinement.py:121-156, which reads a reference grid
file): the constraint-distributed map keeps the geometry conforming, and the
drag is the exact-radius snap's to 5e-3 and Lorentz's wall-corrected drag to
5e-2 (measured 0.34 % below it), each frame held against the JAX package's
to 1e-10 relative (`solve_both`).  The body's vertices lie on the unit
sphere, so both configurations describe the same surface and the comparison
isolates the map's closure on the hanging edges, as there.  And the frame
loop with such a map, which the JAX package cannot run (ROADMAP queue 3)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from bemstokes_tpu.config import ProblemConfig, WallConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
from bemstokes_tpu.swimmer import SwimmerSimulation as SimJ
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.swimmer import SwimmerSimulation as SimT
from test_torch_walls_refined import LORENTZ, drag, solve_both, wall_config
import torch_threads  # noqa: F401  (one torch thread a test process)


def test_q2_map_without_exact_manifold():
    drags = {}
    for radius in (1.0, None):
        pt, _, rt = solve_both(wall_config(map_degree=2, body_manifold_radius=radius))
        assert pt.hanging.n > 0
        drags[radius] = drag(rt)
    F_snap, F_proj = drags[1.0], drags[None]
    assert abs(F_proj - F_snap) / F_snap < 5e-3, (F_proj, F_snap)
    assert abs(F_snap - LORENTZ) / LORENTZ < 5e-2


def test_frame_loop_with_a_higher_order_map_moves_the_map_nodes(tmp_path):
    """The frame loop with rigid displacements and a Q2 map over Q1 unknowns
    (a sphere pushed towards the no-slip image wall): the port advances the
    body's map nodes by dt U, where the JAX package's `_advance_state` adds
    the FE-space translation to the map-space displacements and raises
    (reference behaviour, not matched).  Frame 0 is the JAX package's frame
    0 to 1e-10."""
    cfg = ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=1,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=1,
        no_slip_kernel=True,
        walls=(WallConfig(enabled=False, position=(0.0, -2.0, 0.0), span=(10.0, 0.0, 10.0)),),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        map_degree=2,
    )
    sim_j = SimJ(cfg, str(tmp_path / "jax"))
    with pytest.raises(ValueError, match="broadcast"):
        sim_j.run(0, 1)
    pj = ProblemJ(sim_j.mesh, cfg)
    U0_j = np.asarray(pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))["rigid_velocities"])

    sim = SimT(from_dict(dataclasses.asdict(cfg)), str(tmp_path / "torch"), device="cpu")
    e0 = sim.euler_for_frame(0)
    (h0,) = sim.run(0, 1)
    U0 = np.asarray(h0["rigid_velocities"])
    assert np.max(np.abs(U0 - U0_j)) <= 1e-10 * np.max(np.abs(U0_j))
    assert U0[1] > 0  # pushed away from the wall along +y
    # after frame 0 every body map node moved by dt U0[:3]; frame 1 solves there
    body = sim.map_body_mask[:, 0] > 0
    moved = sim.euler_for_frame(1) - e0
    assert sim.problem.map_space.n_nodes > sim.problem.n
    np.testing.assert_allclose(moved[body], np.broadcast_to(cfg.time_step * U0[:3], moved[body].shape), rtol=0, atol=1e-12)
    h1 = sim.run(1, 2)[-1]
    assert h1["frame"] == 1
    # further from the wall, the sphere moves faster
    assert h1["rigid_velocities"][1] > U0[1]
