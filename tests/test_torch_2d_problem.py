"""The 2D problem of the port (`StokesBEMProblem` with `dim=2`) against the
JAX package's, f64 on the CPU: the circle tests of
`tests/test_2d_problem.py` on the 10-cell clockwise circle built in code
(that file reads the reference's `tests/grid_test/circle_0.inp`), each also against the JAX package's
result, and the other solve strategies in 2D.

- Imposed velocity, imposed rotation (torque within 2e-3 of 4 pi at 80
  nodes), force/velocity duality (U_x = 1 / R_xx to 1e-8): forces and rigid
  velocities within 1e-10 of the JAX package's (relative to the largest
  entry);
- the Direct frame on its fresh and its stale LU, `solve_frame_frozen`,
  `monolithic=False` (with its 3 x 3 resistance matrix) and `print_matrices`:
  1e-10 (the dumps 1e-12);
- one Jacobi frame of the generic GMRES branch: equal iterations and
  1e-10, as `tests/test_torch_preconditioners.py` holds the 3D frames;
- `matrix_free=True`, 80 nodes in blocks of 32, GMRES tolerance 1e-11:
  iterations within 2 of the JAX package's and 1e-8 (as
  `tests/test_torch_matfree.py`), and 1e-7 of the port's materialized frame;
- no flagellum in the plane (a zero torque mode, as in the JAX package) and
  no image kernel (ValueError, where the JAX package asserts dim == 3)."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bemstokes_tpu.config import ProblemConfig, SolverConfig
from bemstokes_tpu.mesh.refine import SphericalManifold as CircleJ, refine_uniform as refine_j
from bemstokes_tpu.mesh.surface_mesh import SurfaceMesh as MeshJ
from bemstokes_tpu.problem import StokesBEMProblem as ProblemJ
from bemstokes_tpu_torch.config import from_dict
from bemstokes_tpu_torch.mesh.refine import SphericalManifold as CircleT, refine_uniform as refine_t
from bemstokes_tpu_torch.mesh.surface_mesh import SurfaceMesh as MeshT
from bemstokes_tpu_torch.problem import StokesBEMProblem as ProblemT, result_to_numpy
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-10
TOL_MATFREE_JAX = 1e-8
TOL_MATERIALIZED = 1e-7


def circle(Mesh, Circle, refine, refinements):
    """The 10-cell unit circle, clockwise, refined onto the circle."""
    th = -2.0 * np.pi * np.arange(10) / 10
    cells = np.stack([np.arange(10), (np.arange(10) + 1) % 10], axis=1)
    mesh = Mesh(np.stack([np.cos(th), np.sin(th)], axis=1), cells, np.zeros(10, np.int32))
    return refine(mesh, Circle((0.0, 0.0)), times=refinements) if refinements else mesh


def _problems(refinements=2, **kw):
    cfg = ProblemConfig(dim=2, force_pole="Origin", **kw)
    pj = ProblemJ(circle(MeshJ, CircleJ, refine_j, refinements), cfg)
    pt = ProblemT(circle(MeshT, CircleT, refine_t, refinements), from_dict(dataclasses.asdict(cfg)), device="cpu")
    assert pt.num_rigid == pj.num_rigid == 3  # 2 translations + 1 rotation
    return pj, pt


def _solve(refinements=2, frames=1, **kw):
    """Both packages' problems and results of `frames` frames (frame k: the
    circle turned by 0.05 k), zero gait."""
    pj, pt = _problems(refinements, **kw)
    e0 = np.asarray(pj.initial_euler())
    out = []
    for k in range(frames):
        c, s = np.cos(0.05 * k), np.sin(0.05 * k)
        e = e0 @ np.array([[c, -s], [s, c]]).T
        rj = pj.solve_frame(jnp.asarray(e), jnp.zeros(2 * pj.n))
        rt = result_to_numpy(pt.solve_frame(e, np.zeros(2 * pt.n)))
        out.append((rj, rt))
    return pj, pt, out


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / np.max(np.abs(b))


def _match(rj, rt, tol=TOL, keys=("stokes_forces", "rigid_velocities")):
    for key in keys:
        assert np.asarray(rt[key]).shape == np.asarray(rj[key]).shape, key
        assert _rel(rt[key], rj[key]) <= tol, (key, _rel(rt[key], rj[key]))


DIRECT = SolverConfig(solve_directly=True)


@pytest.fixture(scope="module")
def translation():
    return _solve(grid_type="ImposedVelocity", imposed_component=0, solver=DIRECT)


@pytest.fixture(scope="module")
def rotation():
    return _solve(refinements=3, grid_type="ImposedVelocity", imposed_component=2, solver=DIRECT)


def test_circle_imposed_velocity(translation):
    """Translating circle: consistent solve, pure x-drag (symmetry kills
    the transverse force and the torque)."""
    _, _, [(rj, rt)] = translation
    assert rt["residual"] < 1e-10
    F = rt["rigid_forces_pole"]
    assert abs(F[0]) > 1.0
    assert abs(F[1]) < 1e-8 * abs(F[0]) and abs(F[2]) < 1e-8 * abs(F[0])
    _match(rj, rt)
    assert _rel(rt["rigid_forces_pole"], rj["rigid_forces_pole"]) <= TOL


def test_circle_imposed_rotation(rotation):
    """Rotating circle: the exact exterior solution exists in 2D, torque
    T = 4 pi mu omega a^2 for the unit circle."""
    _, pt, [(rj, rt)] = rotation
    assert pt.n == 80 and rt["residual"] < 1e-10
    F = rt["rigid_forces_pole"]
    assert abs(F[2]) == pytest.approx(4.0 * np.pi, rel=2e-3)
    assert abs(F[0]) < 1e-8 and abs(F[1]) < 1e-8
    _match(rj, rt)


def test_circle_force_velocity_consistency(translation):
    """Mobility/resistance duality: ImposedForce with a unit x-force returns
    U_x = 1 / R_xx, R_xx the ImposedVelocity drag."""
    _, _, [(_, rt_v)] = translation
    R_xx = rt_v["rigid_forces_pole"][0]
    _, _, [(rj, rt)] = _solve(grid_type="ImposedForce", imposed_component=0, solver=DIRECT)
    U = rt["rigid_velocities"]
    assert U[0] == pytest.approx(1.0 / R_xx, rel=1e-8)
    assert abs(U[1]) < 1e-10 and abs(U[2]) < 1e-10
    _match(rj, rt)


def test_circle_direct_fresh_and_stale_frames():
    """Direct: a fresh LU, then the circle turned on the stale LU; equal
    iterations, forces and velocities as the JAX package's."""
    _, _, frames = _solve(frames=2, grid_type="ImposedVelocity", imposed_component=2)
    for k, (rj, rt) in enumerate(frames):
        assert rt["refactored"] == (k == 0) and rt["converged"]
        assert rt["iterations"] == int(rj["iterations"])
        _match(rj, rt)


def test_circle_frozen_frame_matches_jax():
    """grid Real with a seeded gait, then `solve_frame_frozen` on the kept
    operators with another gait."""
    pj, pt = _problems(grid_type="Real", solver=DIRECT)
    e = np.asarray(pj.initial_euler())
    rng = np.random.default_rng(2)
    s0, s1 = rng.normal(size=2 * pt.n), rng.normal(size=2 * pt.n)
    rj = pj.solve_frame(jnp.asarray(e), jnp.asarray(s0))
    rt = pt.solve_frame(e, s0)
    _match(rj, result_to_numpy(rt))
    _match(pj.solve_frame_frozen(rj, jnp.asarray(s1)), result_to_numpy(pt.solve_frame_frozen(rt, s1)))


def test_circle_resistance_matches_jax():
    """monolithic=False: the D2N strategy with its 3 x 3 resistance matrix,
    and the same forces as the monolithic frame."""
    _, _, [(rj, rt)] = _solve(grid_type="ImposedVelocity", imposed_component=2, monolithic=False)
    assert rt["resistance_matrix"].shape == (3, 3)
    _match(rj, rt, keys=("stokes_forces", "rigid_velocities", "resistance_matrix"))
    _, _, [(_, mono)] = _solve(grid_type="ImposedVelocity", imposed_component=2, solver=DIRECT)
    assert _rel(rt["resistance_matrix"][:, 2], mono["rigid_forces_pole"]) <= TOL


def test_circle_jacobi_frame_matches_jax():
    """One frame of the generic GMRES branch (Jacobi)."""
    _, _, [(rj, rt)] = _solve(
        grid_type="ImposedVelocity", imposed_component=2, solver=SolverConfig(preconditioner_type="Jacobi")
    )
    assert rt["converged"] and rt["iterations"] == int(rj["iterations"]) > 1
    _match(rj, rt)


def test_circle_matrix_free_matches_jax():
    """The matrix-free frame, 80 nodes in blocks of 32 (the 2D operator
    action is the plain torch sweep), against the JAX package's matrix-free
    frame and the port's materialized one."""
    solver = SolverConfig(tolerance=1e-11)
    kw = dict(grid_type="ImposedVelocity", imposed_component=2, solver=solver)
    _, pt, [(rj, rt)] = _solve(refinements=3, matrix_free=True, matfree_block_nodes=32, **kw)
    assert pt._matfree.nblk == 3 and rt["A"] is None and rt["converged"]
    assert abs(rt["iterations"] - int(rj["iterations"])) <= 2, (rt["iterations"], rj["iterations"])
    _match(rj, rt, tol=TOL_MATFREE_JAX)
    _, _, [(_, rm)] = _solve(refinements=3, **kw)
    _match(rm, rt, tol=TOL_MATERIALIZED)


def test_circle_print_matrices_match_jax(tmp_path):
    """The five dumps of `print_matrices` in 2D against the JAX package's."""
    pj, pt = _problems(refinements=1, grid_type="ImposedVelocity", imposed_component=2, print_matrices=True)
    e = np.asarray(pj.initial_euler())
    cwd = os.getcwd()
    try:
        for name, solve in (("jax", lambda: pj.solve_frame(jnp.asarray(e), jnp.zeros(2 * pj.n))),
                            ("torch", lambda: pt.solve_frame(e, np.zeros(2 * pt.n)))):
            os.makedirs(tmp_path / name)
            os.chdir(tmp_path / name)
            solve()
    finally:
        os.chdir(cwd)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "torch")) and len(files) == 5
    for f in files:
        a, b = np.loadtxt(tmp_path / "jax" / f), np.loadtxt(tmp_path / "torch" / f)
        assert a.shape == b.shape and np.max(np.abs(a - b)) <= 1e-12 * np.max(np.abs(a)), f


def test_circle_has_no_flagellum_torque_mode():
    pj, pt = _problems(refinements=1)
    e = np.array(pj.initial_euler())
    mode = pt.flagellum_torque_mode(torch.as_tensor(e), np.eye(2))
    assert mode.shape == (pt.n, 2) and not mode.any()
    assert np.array_equal(np.asarray(pj.flagellum_torque_mode(jnp.asarray(e), np.eye(2))), mode.numpy())


@pytest.mark.parametrize("kernel", ["no_slip_kernel", "reflect_kernel"])
def test_image_kernels_raise_in_2d(kernel):
    """The image kernels are 3D only (the JAX package asserts dim == 3)."""
    cfg = from_dict(dataclasses.asdict(ProblemConfig(dim=2, **{kernel: True})))
    with pytest.raises(ValueError, match="3D only"):
        ProblemT(circle(MeshT, CircleT, refine_t, 1), cfg, device="cpu")
