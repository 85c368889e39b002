"""The matrix-free frame solve (`bemstokes_tpu_torch/matfree.py`, routed by
`ProblemConfig(matrix_free=True)`), on the CPU in f64, where the fused
sweep-matvec runs its plain torch version.

Every configuration is solved three times with the SAME ProblemConfig
(converted by `from_dict`), GMRES tolerance 1e-11, `matfree_block_nodes=64`:
the JAX package's matrix-free frame, the port's matrix-free frame and the
port's materialized frame.

- Port against JAX, both matrix-free: rigid velocities and forces to 1e-8
  relative (both stop GMRES at 1e-11 of |rhs| after a different rounding
  history; the preconditioned system's conditioning carries that to the
  solution), the diagnostics to 1e-9, equal iteration counts.
- Port matrix-free against port materialized: 1e-7, the bound of
  tests/test_matfree.py:62-74; `converged` true.

Which operators the matvec sweeps (`sys["side"]`, decided once a frame): on
meshes of bodies and no-slip wall panels every column is single-layer and
the matvec sweeps V alone, equal bit for bit to the two-sided matvec; with
free-surface or do-nothing wall panels it stays two-sided.

Meshes are built in code: the unit sphere (98 nodes; sheared by a seeded
linear map for the near-pair quadrature, so that the selection of the
nearest panels meets no exact tie), a sphere above a resolved, locally
refined no-slip wall (111 nodes, 16 of them hanging; per-component solid
angle), and the head-and-tube body of tests/test_torch_swimmer.py for the
motor-torque row (without quadrature auto-promotion, for the jitted
`lax.top_k` tie named there).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.flagella as fl_j
import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import (
    ProblemConfig,
    QuadratureConfig,
    SolverConfig,
    WallConfig,
    WallRefinementConfig,
)
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
from bemstokes_tpu.swimmer import SwimmerSimulation as SimJ
import bemstokes_tpu_torch.flagella as fl_t
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.matfree import MatfreeSolver
from bemstokes_tpu_torch.ops import matfree_node
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
from bemstokes_tpu_torch.swimmer import SwimmerSimulation as SimT
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL_JAX = 1e-8
TOL_MATERIALIZED = 1e-7


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _sphere(fac, cfg):
    return fac.create_sphere(refinements=2)


def _sphere_above_refined_wall(fac, cfg):
    return fac.add_walls_to_mesh(fac.create_sphere(refinements=1), cfg)


def _bacterium(fac, cfg):
    fl = fl_j if fac is fac_j else fl_t
    head = fac.create_sphere(center=(-1.2, 0.0, 0.0), refinements=1)
    tube = fl.create_initial_flagellum_mesh(fl.FlagellumConfig(Lx=3.0, a=0.3), 6, 8)
    return head.merged_with(tube)


def _gait(euler):
    """A seeded smooth deformation rate of the surface, as the flat [3 n]
    gait velocity (FE and mapping spaces are equal)."""
    rng = np.random.default_rng(11)
    A, b = rng.standard_normal((3, 3)), rng.standard_normal(3)
    return (0.1 * (euler @ A.T) + 0.05 * b).T.reshape(-1)


def _sheared(euler):
    """The geometry under a seeded generic linear map: no two panel centres
    stay at exactly the same distance from a node.  (On the symmetric sphere
    the near-pair selection meets exact ties, which `jax.lax.top_k` breaks
    differently under jit than the port's stable sort:
    tests/test_torch_swimmer.py `_problems`.)"""
    rng = np.random.default_rng(5)
    return euler @ (np.eye(3) + 0.1 * rng.standard_normal((3, 3))).T


def _image_wall(y):
    return (WallConfig(enabled=False, position=(0.0, y, 0.0), span=(10.0, 0.0, 10.0)),)


CONFIGS = {
    "free_space_imposed_velocity": (
        _sphere,
        dict(grid_type="ImposedVelocity", imposed_component=0, force_pole="Origin"),
        False,
    ),
    "imposed_force_near_pairs": (
        _sphere,
        dict(
            grid_type="ImposedForce",
            imposed_component=0,
            force_pole="Origin",
            quadrature=QuadratureConfig(order=4, order_far=2, near_panels=8),
        ),
        False,
    ),
    "free_surface_real_gait": (
        _sphere,
        dict(grid_type="Real", force_pole="Origin", reflect_kernel=True, walls=_image_wall(-2.0)),
        True,
    ),
    "no_slip_wall_hanging_nodes": (
        _sphere_above_refined_wall,
        dict(
            grid_type="ImposedVelocity",
            imposed_component=0,
            force_pole="Origin",
            body_manifold="sphere",
            alpha_row_sum="component",
            walls=(
                WallConfig(
                    enabled=True,
                    wall_type="no_slip",
                    position=(0.0, -2.0, 0.0),
                    span=(8.0, 0.0, 8.0),
                ),
            ),
            wall_refinement=WallRefinementConfig(
                enabled=True, threshold=2.0, distance_from_center=3.0
            ),
        ),
        False,
    ),
    "motor_torque": (
        _bacterium,
        dict(
            grid_type="Real",
            force_pole="Origin",
            solve_with_torque=True,
            quadrature=QuadratureConfig(auto_promote=False),
        ),
        False,
    ),
}


@pytest.fixture(scope="module", params=list(CONFIGS))
def solves(request):
    """(JAX matrix-free, port matrix-free, port materialized) results of one
    configuration, and the port's matrix-free problem."""
    mesh_of, kwargs, with_gait = CONFIGS[request.param]
    out = {}
    for name, mf in (("jax", True), ("mf", True), ("mat", False)):
        cfg = ProblemConfig(
            solver=SolverConfig(preconditioner_type="Direct", tolerance=1e-11),
            matrix_free=mf,
            matfree_block_nodes=64,
            **kwargs,
        )
        if name == "jax":
            prob = ProblemJ(mesh_of(fac_j, cfg), cfg)
            e = np.asarray(prob.initial_euler())
            e = _sheared(e) if request.param == "imposed_force_near_pairs" else e
            sdot = _gait(e) if with_gait else np.zeros(3 * prob.n)
            out[name] = prob.solve_frame(jnp.asarray(e), jnp.asarray(sdot))
        else:
            cfg_t = from_dict(dataclasses.asdict(cfg))
            prob = ProblemT(mesh_of(fac_t, cfg_t), cfg_t, device="cpu")
            e = prob.initial_euler().numpy()
            e = _sheared(e) if request.param == "imposed_force_near_pairs" else e
            sdot = _gait(e) if with_gait else np.zeros(3 * prob.n)
            before = dict(matfree_node.launches)
            out[name] = result_to_numpy(prob.solve_frame(e, sdot))
            assert matfree_node.launches == before  # CPU: the plain version
            out[name + "_problem"] = prob
    return request.param, out


def test_frame_matches_jax_matrix_free(solves):
    _, out = solves
    rj, rt = out["jax"], out["mf"]
    for key in ("rigid_velocities", "stokes_forces"):
        assert _rel(rt[key], rj[key]) <= TOL_JAX, key
    # the resultants vanish on a force-free body: held to the forces' scale
    f_scale = np.abs(rj["stokes_forces"]).max()
    for key in ("rigid_forces_pole", "rigid_forces_complete"):
        assert np.abs(rt[key] - np.asarray(rj[key])).max() <= TOL_JAX * max(1.0, f_scale), key
    for key in ("mass_body", "com_body", "v_null_residual_pre", "k_solid_angle_check"):
        assert np.allclose(
            rt["diagnostics"][key], np.asarray(rj["diagnostics"][key]), rtol=1e-9, atol=1e-9
        ), key
    assert _rel(rt["rhs"], rj["rhs"]) <= 1e-9
    assert rt["iterations"] == int(rj["iterations"])
    assert rt["converged"] and rj["converged"]


def test_frame_matches_materialized(solves):
    _, out = solves
    rm, rt = out["mat"], out["mf"]
    assert _rel(rt["rigid_velocities"], rm["rigid_velocities"]) < TOL_MATERIALIZED
    assert _rel(rt["stokes_forces"], rm["stokes_forces"]) < TOL_MATERIALIZED
    dm, df = rm["diagnostics"], rt["diagnostics"]
    assert _rel(df["v_null_residual_pre"], dm["v_null_residual_pre"]) < 1e-9
    assert np.allclose(df["k_solid_angle_check"], dm["k_solid_angle_check"], atol=1e-9)
    # the matrix-free finish reports the TRUE residual of the implicit operator
    assert rt["converged"] and rt["residual"] <= 1e-10 * np.abs(rt["rhs"]).max() * len(rt["rhs"])


def test_result_contract(solves):
    """No dense A and no V, K among the operators; the rest of the result
    is that of the materialized frame."""
    name, out = solves
    rm, rt = out["mat"], out["mf"]
    assert rt["A"] is None and rm["A"] is not None
    assert "V" not in rt["operators"] and "K" not in rt["operators"]
    assert set(rt) == set(rm) and not rt["refactored"]
    assert set(rt["operators"]) == set(rm["operators"]) - {"V", "K"}
    assert isinstance(out["mf_problem"]._matfree, MatfreeSolver)
    assert out["mat_problem"]._matfree is None
    if name == "motor_torque":
        assert rt["flagellum_omega"] == pytest.approx(rm["flagellum_omega"], rel=1e-7)
        assert rt["motor_torque"] == pytest.approx(-2.0, rel=1e-7)
    if name == "no_slip_wall_hanging_nodes":
        prob = out["mf_problem"]
        assert prob.hanging.n > 0 and prob.node_component_label is not None
        # slave rows of the operator are the constraint: x_s - sum w x_m = 0
        x = np.concatenate([rt["stokes_forces"] + rt["wall_velocities"], rt["rigid_velocities"]])
        slaves, masters, wts = prob.hanging.slaves, prob.hanging.masters, prob.hanging.weights
        for a in range(3):
            xa = x[a * prob.n : (a + 1) * prob.n]
            assert np.abs(xa[slaves] - np.sum(wts * xa[masters], axis=1)).max() <= 1e-9


def test_matrix_free_overrides_solve_directly():
    """Matched, not fixed: `matrix_free` silently wins over `solve_directly`
    and `print_matrices`, as in the JAX package."""
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        matrix_free=True,
        matfree_block_nodes=8,
        print_matrices=True,
        solver=SolverConfig(solve_directly=True, tolerance=1e-8),
    )
    cfg_t = from_dict(dataclasses.asdict(cfg))
    prob = ProblemT(fac_t.create_sphere(refinements=1), cfg_t, device="cpu")
    res = prob.solve_frame(prob.initial_euler(), np.zeros(3 * prob.n))
    assert res["A"] is None and res["iterations"] > 1


def test_preconditioner_dtype_float32():
    """`preconditioner_dtype="float32"` factors the blocks in f32 under the
    f64 solve: the same answer, as in the JAX package."""
    out = []
    for fd in ("same", "float32"):
        cfg = ProblemConfig(
            grid_type="ImposedVelocity",
            matrix_free=True,
            matfree_block_nodes=64,
            solver=SolverConfig(tolerance=1e-10, preconditioner_dtype=fd),
        )
        cfg_t = from_dict(dataclasses.asdict(cfg))
        prob = ProblemT(fac_t.create_sphere(refinements=2), cfg_t, device="cpu")
        out.append(result_to_numpy(prob.solve_frame(prob.initial_euler(), np.zeros(3 * prob.n))))
        assert out[-1]["converged"]
    assert prob._matfree.factor_dt == torch.float32
    assert _rel(out[1]["stokes_forces"], out[0]["stokes_forces"]) <= 1e-7


def test_frozen_frame_needs_the_materialized_operators():
    cfg = from_dict(
        dataclasses.asdict(
            ProblemConfig(grid_type="Real", matrix_free=True, matfree_block_nodes=64)
        )
    )
    prob = ProblemT(fac_t.create_sphere(refinements=1), cfg, device="cpu")
    res = prob.solve_frame(prob.initial_euler(), np.zeros(3 * prob.n))
    with pytest.raises(ValueError, match="keep_operators"):
        prob.solve_frame_frozen(res, np.zeros(3 * prob.n))


# ---- the frame loop ---------------------------------------------------------


@pytest.fixture(scope="module")
def loop_runs(tmp_path_factory):
    """Two frames of the sphere sedimenting away from a no-slip image wall,
    matrix-free, in both packages."""
    tmp = tmp_path_factory.mktemp("matfree_loop")
    cfg = ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=2,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=1,
        no_slip_kernel=True,
        walls=_image_wall(-2.0),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        matrix_free=True,
        matfree_block_nodes=64,
        solver=SolverConfig(tolerance=1e-11),
    )
    sj = SimJ(cfg, str(tmp / "jax"))
    st = SimT(from_dict(dataclasses.asdict(cfg)), str(tmp / "torch"), device="cpu")
    return sj, st, sj.run(0, 2), st.run(0, 2)


@pytest.mark.parametrize("frame", [0, 1])
def test_frame_loop_matches_jax(loop_runs, frame):
    sj, st, hj, ht = loop_runs
    a, b = hj[frame], ht[frame]
    assert a["frame"] == b["frame"] == frame
    assert _rel(b["rigid_velocities"], a["rigid_velocities"]) <= TOL_JAX
    assert a["iterations"] == b["iterations"] and not b["refactored"]
    zj = np.load(f"{sj.out}/result_{frame}.npz")
    zt = np.load(f"{st.out}/result_{frame}.npz")
    for key in zj.files:
        assert _rel(zt[key], zj[key]) <= TOL_JAX, key


def test_frame_loop_moves_the_body(loop_runs):
    _, st, _, ht = loop_runs
    U = [h["rigid_velocities"][1] for h in ht]
    assert 0 < U[0] < U[1]  # the wall's drag falls as the sphere moves away
    assert st.state.displacements[:, 1].max() > 0


# ---- which operators the matvec sweeps ---------------------------------------


def _matvec_state(wall_type):
    """(solver, frame state) of the sphere alone (`wall_type` None) or above a
    resolved wall of that type, set up for the matrix-free matvec."""
    walls = ()
    if wall_type is not None:
        walls = (
            WallConfig(enabled=True, wall_type=wall_type, position=(0.0, -2.0, 0.0), span=(8.0, 0.0, 8.0)),
        )
    cfg = from_dict(
        dataclasses.asdict(
            ProblemConfig(
                grid_type="ImposedVelocity",
                imposed_component=0,
                force_pole="Origin",
                matrix_free=True,
                matfree_block_nodes=64,
                walls=walls,
            )
        )
    )
    mesh = fac_t.create_sphere(refinements=1)
    prob = ProblemT(fac_t.add_walls_to_mesh(mesh, cfg) if walls else mesh, cfg, device="cpu")
    solver = MatfreeSolver(prob)
    sys, _, _ = solver._setup(prob.initial_euler(), np.zeros(3 * prob.n), None)
    return solver, sys


def _swept_widths(monkeypatch, mv, x):
    """mv(x), and the (BV, BK) of every sweep it asked for."""
    import bemstokes_tpu_torch.matfree as matfree_t

    seen = []
    inner = matfree_t.sweep_matvec

    def spy(st, arrs, XV, XK):
        seen.append(tuple(1 if X.ndim == 1 else X.shape[1] for X in (XV, XK)))
        return inner(st, arrs, XV, XK)

    monkeypatch.setattr(matfree_t, "sweep_matvec", spy)
    out = mv(x)
    monkeypatch.setattr(matfree_t, "sweep_matvec", inner)
    return out, seen


@pytest.mark.parametrize("wall_type", [None, "no_slip"])
def test_all_single_layer_columns_sweep_V_alone(monkeypatch, wall_type):
    """Bodies and no-slip wall panels: every column is single-layer, the
    matvec sweeps V alone (a zero-width K batch) and equals the two-sided
    matvec bit for bit."""
    solver, sys = _matvec_state(wall_type)
    assert sys["side"] == "V" and bool(sys["sel_V"].all())
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(len(sys["rhs"])))
    one, widths = _swept_widths(monkeypatch, solver._matvec(sys), x)
    two, widths_two = _swept_widths(monkeypatch, solver._matvec(dict(sys, side="both")), x)
    assert widths == [(1, 0)] and widths_two == [(1, 1)]
    assert torch.equal(one, two)


@pytest.mark.parametrize("wall_type", ["free_surface", "do_nothing"])
def test_mixed_columns_keep_the_two_sided_sweep(monkeypatch, wall_type):
    """Free-surface and do-nothing wall panels carry double-layer columns:
    the matvec stays two-sided."""
    solver, sys = _matvec_state(wall_type)
    sel = sys["sel_V"]
    assert sys["side"] == "both" and bool(sel.any()) and not bool(sel.all())
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(len(sys["rhs"])))
    out, widths = _swept_widths(monkeypatch, solver._matvec(sys), x)
    assert widths == [(1, 1)] and bool(torch.isfinite(out).all())


def test_all_double_layer_columns_sweep_K_alone(monkeypatch):
    """A mask with no single-layer column (no mesh gives one; forced here)
    sweeps K alone and equals the two-sided matvec up to the sign of zeros."""
    solver, sys = _matvec_state(None)
    sys = dict(sys, sel_V=torch.zeros_like(sys["sel_V"]))
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(len(sys["rhs"])))
    one, widths = _swept_widths(monkeypatch, solver._matvec(dict(sys, side="K")), x)
    two, _ = _swept_widths(monkeypatch, solver._matvec(dict(sys, side="both")), x)
    assert widths == [(0, 1)]
    assert torch.equal(one, two)  # equal compares -0.0 and 0.0 as equal
