"""The JAX package's tests/test_wall_refinement.py and the dilated sphere of
tests/test_cube_and_dilated.py, which read reference grid files, rebuilt on
meshes built in code and run on the port, f64 on the CPU, each frame held
against the JAX package's on the same inputs (forces, rigid velocities and
drag to 1e-10 relative: the summation orders of the two assemblies differ,
the solve amplifies that by the conditioning).

The body is create_sphere(2) with the sphere manifold; the no-slip wall 2
radii below its centre is a resolved 12 x 12 plate (`add_walls_to_mesh`),
refined near the body by `refine_walls` (threshold 2, within 4 of the
centre: 291 nodes, 32 of them hanging) where the JAX test refines a finer
sphere to threshold 1 within 6 (1,335 nodes): the plain torch sweep on the
CPU pays n^2 x 64 samples, and this size keeps the file within seconds.  Auto-promotion is off: on these symmetric meshes
exact ties between panel distances make the near-panel sets of the JAX
package's jitted `lax.top_k` differ from the eager order the port follows
(1e-9 in the forces with it on, 1e-14 off).  The checks are the JAX test's,
with its bounds (measured here: the coarse wall's drag 4.35 % below Lorentz's
wall-corrected drag, the refined one 1.78 % below, the full-row solid angle
36.87 % above):

- the refined wall recovers the Lorentz drag far better than the coarse one,
  and a finite wall cannot out-block the infinite one;
- the per-component solid angle (alpha 1 on the closed body, 1/2 on the open
  wall) against the reference's full-row correction, which inflates the drag;
  on a closed single body the two agree to 1e-12;
- (the Q2 map on the refined wall without an exact-radius manifold:
  tests/test_torch_q2_wall.py, on this file's wall)
- a radius-10 sphere far from the origin under a unit imposed torque about x
  turns at T / (8 pi L^3) to 3e-2, about the Baricenter pole.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import (
    ProblemConfig,
    QuadratureConfig,
    SolverConfig,
    WallConfig,
    WallRefinementConfig,
)
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

H = 2.0
LAM = 1.0 / H
LORENTZ = 6.0 * np.pi / (
    1.0 - 9.0 / 16.0 * LAM + LAM**3 / 8.0 - 45.0 / 256.0 * LAM**4 - LAM**5 / 16.0
)
REFINED = WallRefinementConfig(enabled=True, threshold=2.0, distance_from_center=4.0)
TOL = 1e-10
KEYS = ("rigid_forces_pole", "rigid_velocities", "stokes_forces")


def wall_config(wall_refinement=REFINED, alpha_row_sum="component", **kw):
    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        body_manifold="sphere",
        alpha_row_sum=alpha_row_sum,
        walls=(
            WallConfig(enabled=True, wall_type="no_slip", position=(0.0, -H, 0.0), span=(12.0, 0.0, 12.0)),
        ),
        wall_refinement=wall_refinement,
        quadrature=QuadratureConfig(auto_promote=False),
        solver=SolverConfig(solve_directly=True),
        **kw,
    )


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(a))


def solve_both(cfg, body=None):
    """One frame of each package on the same mesh (create_sphere(2), or
    `body` (vertices, cells)) with the walls of `cfg` attached; returns the
    port's problem and both results."""
    if body is None:
        mj, mt = fac_j.create_sphere(refinements=2), fac_t.create_sphere(refinements=2)
    else:
        mj = MeshJ(body[0], body[1], np.zeros(len(body[1]), np.int32))
        mt = SurfaceMesh(body[0], body[1], np.zeros(len(body[1]), np.int32))
    cfg_t = from_dict(dataclasses.asdict(cfg))
    pj = ProblemJ(fac_j.add_walls_to_mesh(mj, cfg), cfg)
    pt = ProblemT(fac_t.add_walls_to_mesh(mt, cfg_t), cfg_t, device="cpu")
    rj = pj.solve_frame(pj.initial_euler(), jnp.zeros(3 * pj.n))
    rt = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
    for key in KEYS:
        assert _rel(rj[key], rt[key]) <= TOL, key
    assert pt.hanging.n == pj.hanging.n
    return pt, rj, rt


def drag(res):
    return abs(float(res["rigid_forces_pole"][0]))


@pytest.fixture(scope="module")
def walls():
    return {
        "coarse": solve_both(wall_config(WallRefinementConfig())),
        "refined": solve_both(wall_config()),
        "full": solve_both(wall_config(alpha_row_sum="full")),
    }


def test_refined_wall_drag_beats_unrefined_vs_lorentz(walls):
    (pc, rjc, rtc), (pf, rjf, rtf) = walls["coarse"], walls["refined"]
    assert pc.hanging.n == 0 and pf.hanging.n > 0
    assert pf.n == 291
    assert rtf["residual"] < 1e-8
    F_coarse, F_fine = drag(rtc), drag(rtf)
    assert abs(F_fine - abs(float(np.asarray(rjf["rigid_forces_pole"])[0]))) <= TOL * F_fine
    err_coarse = abs(F_coarse - LORENTZ) / LORENTZ
    err_fine = abs(F_fine - LORENTZ) / LORENTZ
    assert err_fine < 0.5 * err_coarse, (F_coarse, F_fine, LORENTZ)
    assert err_fine < 2e-2
    assert F_fine < LORENTZ and F_coarse < LORENTZ


def test_component_alpha_fixes_open_wall_diagonal(walls):
    F_full, F_comp = drag(walls["full"][2]), drag(walls["refined"][2])
    assert F_full > 1.2 * LORENTZ
    assert abs(F_comp - LORENTZ) / LORENTZ < 2e-2


def test_component_alpha_noop_on_closed_single_body():
    res = {}
    for mode in ("full", "component"):
        cfg = ProblemConfig(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            alpha_row_sum=mode,
            solver=SolverConfig(solve_directly=True),
        )
        _, _, res[mode] = solve_both(cfg)
    assert np.allclose(res["full"]["rigid_velocities"], res["component"]["rigid_velocities"], atol=1e-12)


def test_dilated_sphere_imposed_torque():
    """`imposed_rotation_test_on_dilated_sphere.cc`: L = 10, shift 34.913639."""
    L, shift = 10.0, 34.913639
    sphere = fac_t.create_sphere(refinements=2)
    cfg = ProblemConfig(
        grid_type="ImposedForce",
        imposed_component=3,  # torque about x
        force_pole="Baricenter",
        solver=SolverConfig(preconditioner_type="Direct", tolerance=1e-10),
    )
    _, rj, rt = solve_both(cfg, body=(sphere.vertices * L + shift, sphere.cells))
    U = rt["rigid_velocities"]
    exact = 1.0 / (8.0 * np.pi * L**3)
    assert abs(U[3] - exact) / exact < 3e-2, (U[3], exact)
    assert np.all(np.abs(U[[0, 1, 2, 4, 5]]) < 1e-2 * abs(U[3]))
    assert rt["iterations"] == rj["iterations"]


def test_hanging_rows_match_jax():
    """`apply_hanging_constraints_monolithic` on the refined wall's
    constraints and a seeded system: the JAX package's rows exactly, written
    into the system itself (the JAX package returns new arrays; the frame
    solve's system is its own, and a copy would add a second one to the
    peak)."""
    import torch
    from bemstokes_tpu.mesh.constraints import apply_hanging_constraints_monolithic as apply_j
    from bemstokes_tpu_torch.mesh.constraints import apply_hanging_constraints_monolithic as apply_t

    cfg = from_dict(dataclasses.asdict(wall_config()))
    prob = ProblemT(fac_t.add_walls_to_mesh(fac_t.create_sphere(refinements=2), cfg), cfg, device="cpu")
    hc, n = prob.hanging, prob.n
    assert hc.n > 0
    rng = np.random.default_rng(13)
    A0, b0 = rng.standard_normal((3 * n + 6, 3 * n + 6)), rng.standard_normal(3 * n + 6)
    Aj, bj = apply_j(jnp.asarray(A0), jnp.asarray(b0), hc, n, 3)
    A, b = torch.as_tensor(A0.copy()), torch.as_tensor(b0.copy())
    At, bt = apply_t(A, b, hc, n, 3)
    assert At is A and bt is b
    np.testing.assert_array_equal(A.numpy(), np.asarray(Aj))
    np.testing.assert_array_equal(b.numpy(), np.asarray(bj))
