"""The slice as a whole: the port's wall-bounded frame loop
(`bemstokes_tpu_torch/swimmer.py:SwimmerSimulation.run`, on the CPU, where
the node sweeps run their plain torch versions) against the JAX package's,
frame by frame, with the SAME ProblemConfig converted by `from_dict`, f64.

Tolerances: rigid velocities, forces and saved fields agree to 1e-9
relative (node-mode vs gather-mode assembly and different LAPACK/BLAS call
orders round differently, the solves amplify that by the conditioning, and
the state carries it from frame to frame); iteration counts and refactor
flags are equal; the numbers pinned from the JAX package's own run (386
nodes, Direct preconditioner) hold to 1e-6.
"""

import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.flagella as fl_j
import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import ProblemConfig, QuadratureConfig, SolverConfig, WallConfig
from bemstokes_tpu.physics.rigid import flatten as flatten_j
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
from bemstokes_tpu.swimmer import SwimmerSimulation as SimJ, SwimmerState as StateJ
import bemstokes_tpu_torch.flagella as fl_t
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.ops import node_kernel
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
from bemstokes_tpu_torch.swimmer import SwimmerSimulation as SimT, SwimmerState as StateT
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-9


def _wall(y):
    return (WallConfig(enabled=False, position=(0.0, y, 0.0), span=(10.0, 0.0, 10.0)),)


def sphere_cfg(kernel, refinements=3, **kw):
    """The sedimenting (no_slip, force along y) or dragged (free_surface,
    force along x) unit sphere 2 radii above the image plane."""
    return ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=refinements,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=1 if kernel == "no_slip" else 0,
        no_slip_kernel=kernel == "no_slip",
        reflect_kernel=kernel == "free_surface",
        walls=_wall(-2.0),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        **kw,
    )


def helix_cfg(kernel, **kw):
    return ProblemConfig(
        use_flagellum_handler=True,
        imposed_rotation_as_flagellum_shape=True,
        flagellum_params=dict(n_length=24, n_around=8),
        n_frames=8,
        time_step=0.05,
        grid_type="Real",
        no_slip_kernel=kernel == "no_slip",
        reflect_kernel=kernel == "free_surface",
        walls=_wall(-3.0),
        **kw,
    )


def _sims(cfg, tmp_path):
    sj = SimJ(cfg, str(tmp_path / "jax"))
    st = SimT(from_dict(dataclasses.asdict(cfg)), str(tmp_path / "torch"), device="cpu")
    return sj, st


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(a))


def _assert_same_run(sj, st, hj, ht, tol=TOL):
    """Histories, saved results and saved states of the two runs agree."""
    assert [h["frame"] for h in ht] == [h["frame"] for h in hj]
    for a, b in zip(hj, ht):
        assert _rel(a["rigid_velocities"], b["rigid_velocities"]) <= tol
        assert a["iterations"] == b["iterations"]
        assert a["refactored"] == b["refactored"]
        zj = np.load(os.path.join(sj.out, f"result_{a['frame']}.npz"))
        zt = np.load(os.path.join(st.out, f"result_{a['frame']}.npz"))
        assert sorted(zj.files) == sorted(zt.files)
        for key in zj.files:
            assert _rel(zj[key], zt[key]) <= tol, key
        wj = StateJ.load(os.path.join(sj.out, f"state_{a['frame']}.npz"))
        wt = StateT.load(os.path.join(st.out, f"state_{a['frame']}.npz"))
        assert wj.frame == wt.frame == a["frame"]
        assert np.max(np.abs(wj.rotation - wt.rotation)) <= tol
        assert np.max(np.abs(wj.displacements - wt.displacements)) <= tol * max(
            1.0, np.max(np.abs(wj.displacements))
        )
        assert os.path.exists(os.path.join(st.out, f"stokes_{a['frame']}.vtu"))
    for name in ("point_velocities.txt", "origin_velocities.txt", "center_of_mass_position.txt"):
        tj = np.loadtxt(os.path.join(sj.out, name))
        tt = np.loadtxt(os.path.join(st.out, name))
        assert tj.shape == tt.shape
        assert np.max(np.abs(tj - tt)) <= tol * max(1.0, np.max(np.abs(tj)))


# ---- the sphere beside the wall ---------------------------------------------


@pytest.fixture(scope="module", params=["no_slip", "free_surface"])
def sphere_runs(request, tmp_path_factory):
    kernel = request.param
    sj, st = _sims(sphere_cfg(kernel), tmp_path_factory.mktemp(kernel))
    return kernel, sj, st, sj.run(0, 3), st.run(0, 3)


def test_sphere_frames_match_jax(sphere_runs):
    _, sj, st, hj, ht = sphere_runs
    _assert_same_run(sj, st, hj, ht)
    assert [h["refactored"] for h in ht] == [True, False, False]
    assert not any(node_kernel.launches.values())  # CPU tensors: plain versions


def test_sphere_mobility_numbers(sphere_runs):
    """The JAX package's own numbers at 386 nodes: beside a no-slip wall the
    sphere sediments away from it and its mobility 6 pi U_y rises frame by
    frame (frame 0 is 5.6e-3 off Brenner's exact 0.470470 at this mesh);
    beside a free surface 6 pi U_x stays 1.197678."""
    kernel, _, _, _, ht = sphere_runs
    U = np.array([h["rigid_velocities"] for h in ht])
    if kernel == "no_slip":
        assert np.allclose(6 * np.pi * U[:, 1], [0.473085, 0.501933, 0.529295], rtol=0, atol=1e-6)
        assert [h["iterations"] for h in ht] == [1, 4, 5]
    else:
        assert np.allclose(6 * np.pi * U[:, 0], 1.197678, rtol=0, atol=6e-5)
        assert [h["iterations"] for h in ht] == [1, 4, 6]


def test_sphere_state_moves(sphere_runs):
    """With rigid_displacement_axes set the body really moves between
    frames (with the default axes every frame would be the same)."""
    kernel, _, st, _, ht = sphere_runs
    axis = 1 if kernel == "no_slip" else 0
    disp = st.state.displacements[:, axis]
    assert np.ptp(disp) <= 1e-12 and abs(disp[0]) > 0.1
    z0 = np.load(os.path.join(st.out, "result_0.npz"))["euler"]
    z2 = np.load(os.path.join(st.out, "result_2.npz"))["euler"]
    assert np.max(np.abs(z2 - z0)) > 0.1


def test_heun_matches_jax(tmp_path):
    cfg = sphere_cfg("no_slip", refinements=2, time_integration="Heun")
    sj, st = _sims(cfg, tmp_path)
    _assert_same_run(sj, st, sj.run(0, 2), st.run(0, 2))
    # Heun averages the velocities of two solves per frame
    fwd = SimT(
        from_dict(dataclasses.asdict(sphere_cfg("no_slip", refinements=2))),
        str(tmp_path / "fwd"),
        device="cpu",
    ).run(0, 1)
    assert _rel(fwd[0]["rigid_velocities"], st.history[0]["rigid_velocities"]) > 1e-3


def test_state_saved_by_jax_loads_in_port(tmp_path):
    """Frames 0-1 run in the JAX package; the port restarts at frame 2 from
    the JAX state file and lands on the JAX package's frame 2."""
    cfg = sphere_cfg("free_surface", refinements=2, use_previous_state=True)
    sj, st = _sims(cfg, tmp_path)
    hj = sj.run(0, 3)
    shutil.copy(os.path.join(sj.out, "state_1.npz"), os.path.join(st.out, "state_1.npz"))
    ht = st.run(2, 3)
    assert ht[0]["frame"] == 2
    assert _rel(hj[2]["rigid_velocities"], ht[0]["rigid_velocities"]) <= TOL
    loaded = StateT.load(os.path.join(sj.out, "state_2.npz"))
    assert np.max(np.abs(loaded.displacements - st.state.displacements)) <= TOL
    # and the other way round: the JAX package reads the port's state file
    back = StateJ.load(os.path.join(st.out, "state_2.npz"))
    assert back.frame == 2 and np.array_equal(back.rotation, st.state.rotation)


def test_baricenter_pole_outputs_match_jax(tmp_path):
    """force_pole="Baricenter" exercises the pole transform of
    origin_velocities.txt; compose() re-aggregates the saved frames."""
    cfg = sphere_cfg("no_slip", refinements=1, force_pole="Baricenter")
    sj, st = _sims(cfg, tmp_path)
    _assert_same_run(sj, st, sj.run(0, 2), st.run(0, 2))
    assert _rel(sj.compose(0, 2), st.compose(0, 2)) <= TOL
    assert os.path.exists(os.path.join(st.out, "composed_1.vtu"))
    assert os.path.exists(os.path.join(st.out, "mean_velocities_stroke.txt"))


# ---- the bare helix beside the wall -----------------------------------------


@pytest.mark.parametrize("kernel", ["no_slip", "free_surface"])
def test_helix_counter_rotation_matches_jax(kernel, tmp_path):
    """The gait of a bare helix is a rigid mode, so the force-free body
    counter-rotates exactly, wall or not: U[3] = -omega_gait to 1e-10 and
    the other components vanish.  Frame 1 reuses the stale LU across a
    45 degree turn and needs over 100 GMRES iterations in both packages."""
    cfg = helix_cfg(kernel)
    sj, st = _sims(cfg, tmp_path)
    assert np.all(st.problem.flagellum_node_mask == st.problem.body_node_mask)
    assert np.array_equal(st.problem.flagellum_node_mask, sj.problem.flagellum_node_mask)
    hj, ht = sj.run(0, 2), st.run(0, 2)
    omega = -2.0 * np.pi / (cfg.time_step * cfg.n_frames)
    for a, b in zip(hj, ht):
        U = np.array(b["rigid_velocities"])
        assert abs(U[3] + omega) <= 1e-10 * abs(omega)
        assert np.max(np.abs(U[[0, 1, 2, 4, 5]])) <= 1e-10 * abs(omega)
        assert np.max(np.abs(U - np.array(a["rigid_velocities"]))) <= 1e-10 * abs(omega)
        assert b["refactored"] == a["refactored"]
    assert ht[0]["iterations"] == hj[0]["iterations"] == 1
    # a stale-LU solve this long is sensitive to rounding in its last steps
    assert ht[1]["iterations"] > 100 and abs(ht[1]["iterations"] - hj[1]["iterations"]) <= 2
    mt = np.loadtxt(os.path.join(st.out, "motor_torque.txt"))
    mj = np.loadtxt(os.path.join(sj.out, "motor_torque.txt"))
    # the body ends up at rest in the lab frame, so the transmitted torque is
    # zero up to the GMRES tolerance: compare absolutely
    assert mt.shape == mj.shape == (2,) and np.max(np.abs(mt - mj)) <= 1e-9


def test_helix_fd_gait_matches_jax(tmp_path):
    """The finite-difference gait (euler of two frames from the flagellum
    handler) through a direct solve."""
    cfg = dataclasses.replace(
        helix_cfg("no_slip"),
        imposed_rotation_as_flagellum_shape=False,
        flagellum_params=dict(n_length=12, n_around=8),
        n_frames=16,
        solver=SolverConfig(solve_directly=True),
    )
    sj, st = _sims(cfg, tmp_path)
    assert np.max(np.abs(sj.euler_for_frame(3) - st.euler_for_frame(3))) <= 1e-13
    _assert_same_run(sj, st, sj.run(0, 2), st.run(0, 2))


def test_frozen_squirmer_branch_matches_jax(tmp_path):
    """velocity_type="Squirmer" with frozen geometry: frame 0 assembles,
    frames 1-2 only rebuild the rhs from the gait velocity files
    (`solve_frame_frozen`); one file is deal.II block_write binary, the
    others .npy."""
    from bemstokes_tpu_torch.utils.dealii_io import block_write

    vel = tmp_path / "vel"
    vel.mkdir()
    cfg = dataclasses.replace(
        helix_cfg("no_slip"),
        imposed_rotation_as_flagellum_shape=False,
        flagellum_params=dict(n_length=12, n_around=8),
        velocity_type="Squirmer",
        squirmer_change_geometry=False,
        input_velocity_path=str(vel) + "/",
    )
    sj, st = _sims(cfg, tmp_path)
    rng = np.random.default_rng(0)
    for frame in range(3):
        v = rng.normal(size=3 * st.problem.n)
        stem = f"{vel}/{cfg.squirming_velocity_basename}3d_frame_{frame}"
        if frame == 1:
            block_write(stem + ".bin", v)
        else:
            np.save(stem + ".npy", v)
    hj, ht = sj.run(0, 3), st.run(0, 3)
    _assert_same_run(sj, st, hj, ht)
    assert [h["refactored"] for h in ht] == [True, False, False]
    assert _rel(ht[0]["rigid_velocities"], ht[1]["rigid_velocities"]) > 1e-2


# ---- StokesBEMProblem directly ----------------------------------------------


def _bacterium(fac, fl):
    """A spherical head (x < -0.1) and a straight tube behind it (the
    flagellum, x > -0.1), enough for a non-singular motor-torque system."""
    head = fac.create_sphere(center=(-1.2, 0.0, 0.0), refinements=1)
    tube = fl.create_initial_flagellum_mesh(fl.FlagellumConfig(Lx=3.0, a=0.3), 6, 8)
    return head.merged_with(tube)


def _problems(cfg):
    """Both packages' problems on the head + tube mesh, without quadrature
    auto-promotion: head and tube are closer than a panel diameter, and on
    this symmetric mesh one row has an exact tie for its 32nd nearest panel,
    which `jax.lax.top_k` breaks differently under jit than eagerly (the
    port's stable sort follows the eager order).  Promotion itself is
    compared in tests/test_torch_assemble.py and
    tests/test_torch_image_sweep.py."""
    cfg = dataclasses.replace(cfg, quadrature=QuadratureConfig(auto_promote=False))
    pj = ProblemJ(_bacterium(fac_j, fl_j), cfg)
    pt = ProblemT(_bacterium(fac_t, fl_t), from_dict(dataclasses.asdict(cfg)), device="cpu")
    return pj, pt


@pytest.mark.parametrize("kernel", ["free_space", "no_slip"])
def test_solve_with_torque_matches_jax(kernel):
    """The motor-torque unknown: one more row and column of the monolithic
    system, the solved flagellum rate and the transmitted torque."""
    cfg = ProblemConfig(
        solve_with_torque=True,
        grid_type="Real",
        no_slip_kernel=kernel == "no_slip",
        walls=_wall(-3.0),
        solver=SolverConfig(solve_directly=True),
    )
    pj, pt = _problems(cfg)
    assert 0 < pt.flagellum_node_mask.sum() < pt.body_node_mask.sum()
    assert np.array_equal(pt.flagellum_node_mask, pj.flagellum_node_mask)
    assert np.array_equal(pt.head_node_mask, pj.head_node_mask)
    rot = np.asarray(
        [[1.0, 0.0, 0.0], [0.0, np.cos(0.3), -np.sin(0.3)], [0.0, np.sin(0.3), np.cos(0.3)]]
    )
    e = np.asarray(pj.initial_euler()) @ rot.T
    rj = pj.solve_frame(jnp.asarray(e), jnp.zeros(3 * pj.n), jnp.asarray(rot))
    rt = result_to_numpy(pt.solve_frame(e, np.zeros(3 * pt.n), rot))
    assert rt["A"].shape == (3 * pt.n + 7, 3 * pt.n + 7)
    assert _rel(rj["A"], rt["A"]) <= 1e-10
    assert _rel(rj["rhs"], rt["rhs"]) <= 1e-14 and rt["rhs"][-1] == -2.0
    for key in ("rigid_velocities", "stokes_forces", "shape_velocities"):
        assert _rel(rj[key], rt[key]) <= TOL, key
    assert abs(rt["flagellum_omega"] - rj["flagellum_omega"]) <= TOL * abs(rj["flagellum_omega"])
    assert abs(rt["motor_torque"] + 2.0) <= 1e-8 and abs(rj["motor_torque"] + 2.0) <= 1e-8
    for key in ("N_flagellum_torque", "N_flagellum_torque_dual"):
        assert _rel(rj["operators"][key], rt["operators"][key]) <= 1e-12, key
    assert _rel(pj.flagellum_translation_mode(), pt.flagellum_translation_mode().numpy()) == 0


def test_imposed_rotation_reports_motor_torque():
    cfg = ProblemConfig(
        imposed_rotation_as_flagellum_shape=True,
        grid_type="Real",
        force_pole="Point",
        force_arbitrary_point=(0.5, 0.0, 0.0),
    )
    pj, pt = _problems(cfg)
    e = np.asarray(pj.initial_euler())
    sj = flatten_j(-3.0 * pj.flagellum_torque_mode(jnp.asarray(e)))
    rj = pj.solve_frame(jnp.asarray(e), sj)
    rt = result_to_numpy(pt.solve_frame(e, np.asarray(sj)))
    assert "flagellum_omega" not in rt
    assert abs(rt["motor_torque"] - rj["motor_torque"]) <= TOL * abs(rj["motor_torque"])
    assert _rel(rj["rigid_velocities"], rt["rigid_velocities"]) <= TOL
    assert rt["iterations"] == rj["iterations"]


@pytest.mark.parametrize("directly", [True, False], ids=["solve_directly", "stale_lu"])
def test_solve_frame_frozen_matches_jax(directly):
    cfg = ProblemConfig(
        grid_type="Real",
        reflect_kernel=True,
        walls=_wall(-2.0),
        solver=SolverConfig(solve_directly=directly),
    )
    pj, pt = _problems(cfg)
    e = np.asarray(pj.initial_euler())
    rng = np.random.default_rng(3)
    s0, s1 = rng.normal(size=(2, 3 * pt.n))
    rj0 = pj.solve_frame(jnp.asarray(e), jnp.asarray(s0))
    rt0 = pt.solve_frame(e, s0)
    rj1 = pj.solve_frame_frozen(rj0, jnp.asarray(s1))
    rt1 = result_to_numpy(pt.solve_frame_frozen(rt0, s1))
    assert _rel(rj1["rhs"], rt1["rhs"]) <= 1e-12
    for key in ("rigid_velocities", "stokes_forces"):
        assert _rel(rj1[key], rt1[key]) <= TOL, key
    assert rt1["iterations"] == rj1["iterations"]
    assert rt1["refactored"] == rj1["refactored"] is False
    # the frozen solve equals a full solve at the same geometry
    full = result_to_numpy(pt.solve_frame(e, s1))
    assert _rel(full["rigid_velocities"], rt1["rigid_velocities"]) <= TOL


def test_frozen_needs_kept_operators():
    cfg = from_dict(dataclasses.asdict(ProblemConfig(grid_type="Real", keep_operators=False)))
    pt = ProblemT(fac_t.create_sphere(refinements=1), cfg, device="cpu")
    res = pt.solve_frame(pt.initial_euler(), np.zeros(3 * pt.n))
    assert res["operators"]["V"] is None and res["operators"]["K"] is None
    with pytest.raises(ValueError, match="keep_operators"):
        pt.solve_frame_frozen(res, np.zeros(3 * pt.n))


# ---- what is left for later -------------------------------------------------


@pytest.mark.parametrize("change", [dict(distributed=True)], ids=["distributed"])
def test_unported_simulations_raise(change, tmp_path):
    """Gaits read from frame mesh files left this list when the readers were
    ported (tests/test_torch_cli.py, `test_frame_mesh_gait_*` below), 2D
    when it was (tests/test_torch_2d_swimmer.py), and the distributed frame
    loop when `parallel/` was (the test keeps its name): two frames of the
    sphere sedimenting beside the no-slip wall (create_sphere(1)) with
    `distributed`, the port on a row mesh of one rank (a gloo group of one
    in this process) against the JAX package's distributed loop on its 8
    devices, as `test_unported_solves_raise_in_the_loop`; a
    `distributed_devices` other than the group's size raises, since the port
    runs one process per device.  Its ranks in a group of two:
    tests/test_torch_parallel_swimmer.py."""
    import torch.distributed as dist

    created = not dist.is_initialized()
    bad = dataclasses.replace(from_dict(dataclasses.asdict(sphere_cfg("no_slip", 1))), distributed_devices=2, **change)
    with pytest.raises(ValueError, match="one per device|one process per device"):
        SimT(bad, str(tmp_path / "bad"), device="cpu")
    sj, st = _sims(sphere_cfg("no_slip", 1, **change), tmp_path)
    hj, ht = sj.run(0, 2), st.run(0, 2)
    if created:
        dist.destroy_process_group()
    _assert_same_run(sj, st, hj, ht)
    assert [h["refactored"] for h in ht] == [True, False]


@pytest.mark.parametrize(
    "change",
    [dict(monolithic=False), dict(solver=SolverConfig(preconditioner_type="Jacobi"))],
    ids=["resistance", "jacobi"],
)
def test_unported_solves_raise_in_the_loop(change, tmp_path):
    """These solves raised in the frame loop while they waited for their
    modules (the test keeps its name): the grand-resistance strategy
    (`monolithic=False`, whose rigid force sums the loop forms on the host)
    and GMRES under Jacobi.  Two frames of the sphere sedimenting beside the
    no-slip wall (create_sphere(1)) against the JAX package's loop: results,
    states and time series to 1e-9, equal iterations."""
    sj, st = _sims(sphere_cfg("no_slip", 1, **change), tmp_path)
    hj, ht = sj.run(0, 2), st.run(0, 2)
    _assert_same_run(sj, st, hj, ht)
    F = np.loadtxt(os.path.join(st.out, "point_velocities.txt"))[:, 0]
    assert np.all(np.isfinite(F)) and abs(F[1] - 1.0) <= 1e-8  # the imposed unit force along y
    if change.get("monolithic", True):
        assert [h["iterations"] for h in ht] == [h["iterations"] for h in hj] and ht[0]["iterations"] > 1
    else:
        assert [h["iterations"] for h in ht] == [1, 1]


def test_default_device_is_the_card(tmp_path):
    """With no `device` the simulation runs on the CUDA card, and raises
    where there is none."""
    cfg = from_dict(dataclasses.asdict(sphere_cfg("no_slip", 1)))
    if torch.cuda.is_available():
        assert SimT(cfg, str(tmp_path)).problem.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            SimT(cfg, str(tmp_path))
