"""The higher-order 3D element paths of the port against the JAX package, f64
on the CPU (every kernel wrapper runs its plain torch version), on meshes
built in code, with the SAME ProblemConfig converted by `from_dict`.  These
are the JAX package's tests that read reference grid files
(tests/test_sphere_solve.py), rebuilt on `create_sphere`:

- "q4_sphere": a Q4 map snapped to the sphere manifold, quadrature 6 / 9 (the
  JAX package's drag gate, bench.py's accuracy configuration) on
  create_sphere(2): drag error 5.505e-8, at most 1e-6;
- "q2map_q1": a Q2 map with Q1 unknowns, grid Real, two frames under the
  Direct preconditioner (fresh LU, then the stale one), their shape
  velocities through the degree-mismatch interpolation
  (`StokesBEMProblem.shape_velocities_fd`): a translation by 1/120 a frame,
  which the force-free body's rigid velocity cancels, U_x = -1 / (120 dt);
  then the same translation with a pear-shaped stroke, whose tractions do
  not vanish;
- "q0": piecewise-constant unknowns at the 96 panel centres, Q1 map;
- "q2q2_sphere": Q2 unknowns on a Q2 map snapped to the sphere (386 nodes).

Each holds forces and rigid velocities to 1e-10 relative (the summation
orders of the two packages' assemblies differ, the solve amplifies that by
the conditioning; on the force-free gait, whose net forces vanish and whose
first frame has no traction, to 1e-10 of the larger of the traction scale
and the gait's speed) and the drag error to 1e-12 of the JAX package's.  The
port's gather mode ("gather", the path of K6's `tile_nodes` on the card)
and node mode (K1's) agree on the Q0 and Q2 cases to 1e-9 relative (the
tolerance of tests/test_torch_column_modes.py between column modes).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import ProblemConfig, QuadratureConfig, SolverConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.ops import node_kernel, slot_kernel
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

KEYS = ("rigid_forces_pole", "rigid_velocities", "stokes_forces")
TOL = 1e-10
DRAG_TOL = 1e-12
MODE_TOL = 1e-9
STEP = 1.0 / 120.0  # the translation a frame of the reference's sphere_translation gait

BASE = dict(force_pole="Origin", solver=SolverConfig(solve_directly=True))
DT = 0.1  # ProblemConfig.time_step
CASES = {
    "q4_sphere": dict(
        grid_type="ImposedVelocity",
        imposed_component=0,
        map_degree=4,
        body_manifold="sphere",
        quadrature=QuadratureConfig(order=6, singular_order=9),
    ),
    "q2map_q1": dict(grid_type="Real", fe_degree=1, map_degree=2, solver=SolverConfig()),
    "q0": dict(grid_type="ImposedVelocity", imposed_component=0, fe_degree=0, map_degree=1),
    "q2q2_sphere": dict(
        grid_type="ImposedVelocity", imposed_component=0, fe_degree=2, map_degree=2, body_manifold="sphere"
    ),
}
#: (drag error the JAX package and the port both give, bound it must meet);
#: for "q2map_q1" the error of the recovered translation velocity
EXPECTED = {
    "q4_sphere": (5.505e-8, 1e-6),
    "q2map_q1": (None, 2e-2),
    "q0": (2.640e-2, 3e-2),
    "q2q2_sphere": (8.470e-4, 1e-3),
}


def drag_error(res, case, frame=0):
    """|F_x| against Stokes' 6 pi; on the gait, U_x against -1 / (120 dt) on
    its translating frame 0 (None on the stroke of frame 1)."""
    if case == "q2map_q1":
        if frame:
            return None
        return abs(res["rigid_velocities"][0] + STEP / DT) / (STEP / DT)
    F = np.asarray(res["rigid_forces_pole"])
    return abs(abs(F[0]) - 6 * np.pi) / (6 * np.pi)


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(a))


def _frames(prob_j, prob_t, case):
    """[(euler, sdot JAX, sdot port)]: one frame of an imposed motion, or two
    frames of the translating gait."""
    e0 = np.asarray(prob_j.initial_euler())
    if case != "q2map_q1":
        z = np.zeros(3 * prob_j.n)
        return [(e0, z, z)]
    shift = np.array([STEP, 0.0, 0.0])
    stroke = 0.04 * e0 * e0[:, :1]
    es = [e0, e0 + shift, e0 + 2 * shift + stroke]
    out = []
    for a, b in zip(es[:2], es[1:]):
        sj = np.asarray(prob_j.shape_velocities_fd(jnp.asarray(a), jnp.asarray(b)))
        st = prob_t.shape_velocities_fd(a, b).numpy()
        out.append((a, sj, st))
    return out


def _config(case):
    return ProblemConfig(**{**BASE, **CASES[case]})


def _solve(case):
    cfg = _config(case)
    mj, mt = fac_j.create_sphere(refinements=2), fac_t.create_sphere(refinements=2)
    cfg_t = from_dict(dataclasses.asdict(cfg))
    pj = ProblemJ(mj, cfg)
    pt = ProblemT(mt, cfg_t, device="cpu")
    frames = _frames(pj, pt, case)
    out = []
    for e, sj, st in frames:
        rj = pj.solve_frame(jnp.asarray(e), jnp.asarray(sj))
        rt = result_to_numpy(pt.solve_frame(e, st))
        out.append((rj, rt, sj, st))
    return pt, out


@pytest.fixture(scope="module", params=sorted(CASES))
def solved(request):
    return request.param, *_solve(request.param)


def test_forces_match_jax(solved):
    case, pt, frames = solved
    for rj, rt, sj, st in frames:
        assert np.max(np.abs(sj - st)) <= 1e-15 * max(1.0, np.max(np.abs(sj)))
        for key in KEYS:
            if case == "q2map_q1":
                scale = max(np.max(np.abs(rj["stokes_forces"])), STEP / DT)
                assert np.max(np.abs(rt[key] - np.asarray(rj[key]))) <= TOL * scale, key
            else:
                assert _rel(rj[key], rt[key]) <= TOL, (case, key)
        assert rt["iterations"] == rj["iterations"]
        assert rt["refactored"] == rj["refactored"]
        assert rt["residual"] <= 1e-8


def test_drag_error_is_the_jax_packages(solved):
    case, pt, frames = solved
    expected, bound = EXPECTED[case]
    for frame, (rj, rt, _, _) in enumerate(frames):
        err_t, err_j = drag_error(rt, case, frame), drag_error(rj, case, frame)
        if err_t is None:
            continue
        assert abs(err_t - err_j) <= DRAG_TOL, (case, err_t, err_j)
        assert err_t <= bound, (case, err_t)
        if expected is not None:
            assert err_t == pytest.approx(expected, rel=1e-3), (case, err_t)


def test_spaces_and_shapes(solved):
    """What each configuration exercises: the node count and K1's samples
    per column node (vmax x nq)."""
    case, pt, frames = solved
    n, m = pt.n, pt.tables.inc_slot.shape[1] * len(pt.tables.q_weights)
    assert (n, m) == {
        "q4_sphere": (98, 4 * 36),
        "q2map_q1": (98, 4 * 16),
        "q0": (96, 1 * 16),
        "q2q2_sphere": (386, 4 * 16),
    }[case]
    if case == "q2map_q1":
        assert len(frames) == 2
        assert frames[0][1]["refactored"] and not frames[1][1]["refactored"]
        # the stroke's tractions do not vanish, the force-free body's net force does
        traction = np.max(np.abs(frames[1][1]["stokes_forces"]))
        assert traction > 1e-2
        assert np.max(np.abs(frames[1][1]["rigid_forces_pole"])) <= TOL * traction
    assert not any(node_kernel.launches.values())


@pytest.mark.parametrize("case,refinements", [("q0", 2), ("q2q2_sphere", 1)])
def test_gather_matches_node_mode(case, refinements):
    """Gather mode (K6's `tile_nodes` on the card) against node mode (K1) on
    the Q0 and Q2 spaces, whose slots the kernel takes with LB = 4 and
    EXACT = false (nl = 1) and LB = 3 (nl = 9); Q2 on create_sphere(1) (98
    nodes: the plain slot tensors of 9 local nodes are the CPU's cost)."""
    cfg = _config(case)
    res = {}
    for backend in ("node", "gather"):
        cfg_t = dataclasses.replace(from_dict(dataclasses.asdict(cfg)), assembly_backend=backend)
        pt = ProblemT(fac_t.create_sphere(refinements=refinements), cfg_t, device="cpu")
        res[backend] = result_to_numpy(pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n)))
    for key in KEYS:
        assert _rel(res["node"][key], res["gather"][key]) <= MODE_TOL, key
    assert abs(drag_error(res["gather"], case) - drag_error(res["node"], case)) <= 1e-12
    assert not any(slot_kernel.launches.values())
