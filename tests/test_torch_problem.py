"""The slice as a whole: the port's `StokesBEMProblem.solve_frame` (Direct,
fresh then stale LU) against the JAX package's on create_sphere(3) (386
nodes, 1,164 unknowns), with the SAME ProblemConfig converted by
`from_dict`.

Frame 0 factors a fresh LU; frames 1 and 2 are rigidly rotated and
translated copies of the geometry and reuse the stale LU.  In f64 the
results agree to 1e-10 relative (node-mode vs gather-mode assembly and
different LAPACK/BLAS call orders round differently, the solves amplify
that by the conditioning), with equal iteration counts and refactor flags,
and the drag error is the JAX package's 2.6725e-3 (± 1e-6) for the flat Q1
map at this size."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.mesh.factories as fac_j
from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
import bemstokes_tpu_torch.mesh.factories as fac_t
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.ops import node_kernel
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

KEYS = ("rigid_forces_pole", "rigid_velocities", "stokes_forces", "rigid_forces_complete")


def _rot(axis, theta):
    c, s = np.cos(theta), np.sin(theta)
    i, j = [k for k in range(3) if k != axis]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def frames_of(e0):
    """Frame 0 and two rigid motions of it (rotation + translation)."""
    return [
        e0,
        e0 @ _rot(2, 0.3).T + np.array([0.5, -0.2, 0.1]),
        e0 @ (_rot(0, 0.7) @ _rot(1, -0.4)).T + np.array([-1.0, 0.3, 2.0]),
    ]


def drag_error(res):
    F = np.asarray(res["rigid_forces_pole"])
    return abs(abs(F[0]) - 6 * np.pi) / (6 * np.pi)


def _problems(cfg, refinements=3):
    pj = ProblemJ(fac_j.create_sphere(refinements=refinements), cfg)
    pt = ProblemT(
        fac_t.create_sphere(refinements=refinements),
        from_dict(dataclasses.asdict(cfg)),
        device="cpu",
    )
    return pj, pt


def _run(cfg, n_frames=3):
    pj, pt = _problems(cfg)
    e0 = np.asarray(pj.initial_euler())
    sdot = np.zeros(3 * pj.n)
    out = []
    for e in frames_of(e0)[:n_frames]:
        rj = pj.solve_frame(jnp.asarray(e), jnp.asarray(sdot))
        rt = result_to_numpy(pt.solve_frame(e, sdot))
        out.append((rj, rt))
    return out


@pytest.fixture(scope="module")
def f64_frames():
    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0)
    return _run(cfg)


def _rel(a, b):
    a = np.asarray(a)
    return np.max(np.abs(a - np.asarray(b))) / np.max(np.abs(a))


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_frame_matches_jax(f64_frames, frame):
    rj, rt = f64_frames[frame]
    for key in KEYS:
        assert _rel(rj[key], rt[key]) <= 1e-10, key
    assert rt["iterations"] == rj["iterations"]
    assert rt["refactored"] == rj["refactored"] == (frame == 0)
    assert rt["converged"] and rj["converged"]
    assert abs(rt["residual"] - rj["residual"]) <= 1e-12


@pytest.mark.parametrize("frame", [0, 1, 2])
def test_frame_drag(f64_frames, frame):
    rj, rt = f64_frames[frame]
    assert abs(drag_error(rt) - 2.6725e-3) <= 1e-6
    assert abs(drag_error(rt) - drag_error(rj)) <= 1e-10


@pytest.mark.parametrize("frame", [0, 2])
def test_frame_operators_match_jax(f64_frames, frame):
    """The stages under the solve: the monolithic system, its rhs, the
    corrected V and K, the rigid-mode duals and the L2 normal."""
    rj, rt = f64_frames[frame]
    assert _rel(rj["A"], rt["A"]) <= 1e-10
    assert _rel(rj["rhs"], rt["rhs"]) <= 1e-14
    oj, ot = rj["operators"], rt["operators"]
    for key in ("V", "K", "N", "N_dual", "N_dual_complete", "tmp_N", "mass_jxw"):
        assert _rel(oj[key], ot[key]) <= 1e-10, key
    assert np.array_equal(np.asarray(oj["sel_V"]), ot["sel_V"])
    for key in ("normal", "normal_pure", "M_normal", "l2_gamma_pure"):
        assert _rel(oj["normal"][key], ot["normal"][key]) <= 1e-12, key
    for key, val in rj["diagnostics"].items():
        assert np.allclose(val, rt["diagnostics"][key], rtol=1e-9, atol=1e-12), key


def test_port_on_cpu_launches_no_kernel(f64_frames):
    """On CPU tensors the slice runs K1's plain version: no launch."""
    assert not any(node_kernel.launches.values())


def test_float32_frame_matches_jax_float32():
    """One f32 frame against JAX f32 (tolerance 1e-5, as the JAX f32 bench
    config uses): forces agree to 1e-4 relative (f32 rounding of two
    different assembly orders, amplified by the solve)."""
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        dtype="float32",
        solver=SolverConfig(tolerance=1e-5),
    )
    (rj, rt), = _run(cfg, n_frames=1)
    assert rt["stokes_forces"].dtype == np.float32
    assert rt["converged"]
    assert _rel(rj["rigid_forces_pole"], rt["rigid_forces_pole"]) <= 1e-4
    assert _rel(rj["stokes_forces"], rt["stokes_forces"]) <= 1e-4
    assert abs(drag_error(rt) - 2.6725e-3) <= 1e-4


def test_real_grid_gait_matches_jax():
    """grid_type="Real": a non-rigid gait (finite difference of two frames)
    drives the force- and torque-free swimmer; rigid velocities and surface
    tractions match JAX to 1e-10 relative, and the net rigid forces vanish
    in both (to 1e-10 of the traction scale)."""
    cfg = ProblemConfig(grid_type="Real")
    pj, pt = _problems(cfg, refinements=2)
    e0 = np.asarray(pj.initial_euler())
    e1 = e0 + 0.1 * np.stack([e0[:, 1] ** 2, e0[:, 2] * e0[:, 0], 0.0 * e0[:, 0]], axis=1)
    sj = pj.shape_velocities_fd(jnp.asarray(e0), jnp.asarray(e1))
    st = pt.shape_velocities_fd(e0, e1)
    assert np.max(np.abs(np.asarray(sj) - st.numpy())) <= 1e-15
    rj = pj.solve_frame(jnp.asarray(e0), sj)
    rt = result_to_numpy(pt.solve_frame(e0, st))
    for key in ("rigid_velocities", "stokes_forces"):
        assert _rel(rj[key], rt[key]) <= 1e-10, key
    scale = np.max(np.abs(rt["stokes_forces"]))
    assert np.max(np.abs(rt["rigid_forces_pole"])) <= 1e-10 * scale
    assert np.max(np.abs(rt["rigid_velocities"])) > 1e-3
    assert rt["iterations"] == rj["iterations"]


def test_solve_directly_matches_jax():
    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=1,
        force_pole="Baricenter",
        solver=SolverConfig(solve_directly=True),
    )
    (rj, rt), = _run(cfg, n_frames=1)
    for key in KEYS:
        assert _rel(rj[key], rt[key]) <= 1e-10, key
    assert rt["iterations"] == rj["iterations"] == 1
    assert rt["residual"] <= 1e-10


@pytest.mark.parametrize(
    "change",
    [
        dict(monolithic=False),
        dict(print_matrices=True),
        dict(solver=SolverConfig(preconditioner_type="ILU")),
        dict(solver=SolverConfig(preconditioner_type="Jacobi")),
    ],
    ids=["resistance", "print_matrices", "ilu", "jacobi"],
)
def test_unported_solve_branches_raise(change, tmp_path, monkeypatch):
    """These branches raised while they waited for their modules (the test
    keeps its name); each is now a frame of the port against the JAX
    package's on create_sphere(1) (78 + 6 unknowns): the grand-resistance
    strategy, the dumps of `print_matrices` (written into the working
    directory), GMRES under block-Jacobi (ILU) and Jacobi.  1e-10 relative,
    equal iteration counts."""
    monkeypatch.chdir(tmp_path)
    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, **change)
    pj, pt = _problems(cfg, refinements=1)
    e0 = np.asarray(pj.initial_euler())
    rj = pj.solve_frame(jnp.asarray(e0), jnp.zeros(3 * pj.n))
    rt = result_to_numpy(pt.solve_frame(e0, np.zeros(3 * pt.n)))
    assert rt["iterations"] == rj["iterations"]
    for key in ("rigid_velocities", "stokes_forces"):
        assert _rel(rj[key], rt[key]) <= 1e-10, key
    if not cfg.monolithic:
        assert _rel(rj["resistance_matrix"], rt["resistance_matrix"]) <= 1e-10
    else:
        assert rt["converged"] and _rel(rj["rigid_forces_pole"], rt["rigid_forces_pole"]) <= 1e-10
    assert sorted(os.listdir(tmp_path)) == (DUMPS if cfg.print_matrices else [])


DUMPS = sorted(
    ["monolithic_matrix.txt", "V_matrix.txt", "K_matrix.txt", "Mass_matrix.txt", "normals_matrix.txt"]
)


def test_print_matrices_names_what_it_waits_for(tmp_path):
    """`print_matrices` raised while it waited for its port (the test keeps
    its name).  Now the five files of each package, written into the
    working directory of its own, hold the same matrices to 1e-12 relative;
    `Mass_matrix.txt` is the consistent mass matrix (symmetric, its entries
    sum to the surface area), `monolithic_matrix.txt` the frame's `A`.
    Without `keep_operators` it raises ValueError, as in JAX, and
    `matrix_free` overrides it (no file is written)."""
    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, print_matrices=True)
    pj, pt = _problems(cfg, refinements=1)
    e0 = np.asarray(pj.initial_euler())
    out = {}
    for name, run in (
        ("jax", lambda: pj.solve_frame(jnp.asarray(e0), jnp.zeros(3 * pj.n))),
        ("torch", lambda: pt.solve_frame(e0, np.zeros(3 * pt.n))),
    ):
        folder = tmp_path / name
        folder.mkdir()
        cwd = os.getcwd()
        os.chdir(folder)
        try:
            out[name] = run()
        finally:
            os.chdir(cwd)
        assert sorted(os.listdir(folder)) == DUMPS
    for f in DUMPS:
        a = np.loadtxt(tmp_path / "jax" / f)
        b = np.loadtxt(tmp_path / "torch" / f)
        assert a.shape == b.shape and _rel(a, b) <= 1e-12, f
    A = np.loadtxt(tmp_path / "torch" / "monolithic_matrix.txt")
    assert np.array_equal(A, out["torch"]["A"].numpy())
    M = np.loadtxt(tmp_path / "torch" / "Mass_matrix.txt")
    assert M.shape == (pt.n, pt.n) and _rel(M, M.T) <= 1e-15
    assert abs(M.sum() - float(out["torch"]["diagnostics"]["mass_body"])) <= 1e-12 * M.sum()

    no_ops = from_dict(dataclasses.asdict(dataclasses.replace(cfg, keep_operators=False)))
    p = ProblemT(fac_t.create_sphere(refinements=1), no_ops, device="cpu")
    with pytest.raises(ValueError, match="keep_operators"):
        p.solve_frame(p.initial_euler(), np.zeros(3 * p.n))
    mf = from_dict(dataclasses.asdict(dataclasses.replace(cfg, matrix_free=True)))
    p = ProblemT(fac_t.create_sphere(refinements=1), mf, device="cpu")
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        p.solve_frame(p.initial_euler(), np.zeros(3 * p.n))
    finally:
        os.chdir(cwd)
    assert sorted(os.listdir(tmp_path)) == ["jax", "torch"]


@pytest.mark.parametrize("change", [dict(mixed_precision_bulk=True)], ids=["mixed_bulk"])
def test_unported_setups_raise(change):
    """The image kernels left this list when K2 and K3 were ported
    (tests/test_torch_image_sweep.py, tests/test_torch_swimmer.py), and 2D
    when it was (tests/test_torch_2d_problem.py)."""
    cfg = from_dict(dataclasses.asdict(ProblemConfig(**change)))
    mesh = fac_t.create_sphere(refinements=1)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ProblemT(mesh, cfg, device="cpu")


def test_default_device_is_the_card():
    """With no `device` the problem runs on the CUDA card, and raises where
    there is none: it never carries on on the CPU by itself."""
    mesh = fac_t.create_sphere(refinements=1)
    if torch.cuda.is_available():
        assert ProblemT(mesh).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            ProblemT(mesh)
    assert ProblemT(mesh, device="cpu").device.type == "cpu"


def test_force_pole_and_initial_euler_match_jax():
    cfg = ProblemConfig(force_pole="Point", force_arbitrary_point=(0.5, 0.0, -1.0))
    pj, pt = _problems(cfg, refinements=1)
    e = pt.initial_euler()
    assert e.dtype == torch.float64
    assert np.array_equal(np.asarray(pj.initial_euler()), e.numpy())
    com = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    assert np.array_equal(
        np.asarray(pj.force_pole_point(jnp.asarray(com.numpy()))),
        pt.force_pole_point(com).numpy(),
    )
