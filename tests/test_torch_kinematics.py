"""`bemstokes_tpu_torch/physics/kinematics.py` against the JAX package's
`bemstokes_tpu/physics/kinematics.py` on the same seeded inputs, f64:
1e-14 absolute on rotation matrices and quaternions (entries are O(1); the
4x4 Crank-Nicolson solve goes through two different LAPACK paths), and the
numpy twin of the frame loop against both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bemstokes_tpu.physics.kinematics as kin_j
import bemstokes_tpu_torch.physics.kinematics as kin_t
import torch_threads  # noqa: F401  (one torch thread a test process)

TOL = 1e-14


def _quaternion(seed):
    q = np.random.default_rng(seed).normal(size=4)
    q[0] = abs(q[0]) + 0.5  # trace > -1, as rotations accumulated from identity
    return q / np.linalg.norm(q)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quaternion_round_trip_matches_jax(seed):
    q = _quaternion(seed)
    Rj = kin_j.rotation_matrix_from_quaternion(jnp.asarray(q))
    Rt = kin_t.rotation_matrix_from_quaternion(torch.as_tensor(q))
    assert np.max(np.abs(np.asarray(Rj) - Rt.numpy())) <= TOL
    assert np.max(np.abs(Rt.numpy() @ Rt.numpy().T - np.eye(3))) <= 1e-14
    qj = kin_j.quaternion_from_rotation_matrix(Rj)
    qt = kin_t.quaternion_from_rotation_matrix(Rt)
    assert np.max(np.abs(np.asarray(qj) - qt.numpy())) <= TOL
    assert np.max(np.abs(qt.numpy() - q)) <= 1e-14


@pytest.mark.parametrize("forward_euler", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_update_rotation_matrix_matches_jax(seed, forward_euler):
    rng = np.random.default_rng(10 + seed)
    Rm = np.asarray(kin_j.rotation_matrix_from_quaternion(jnp.asarray(_quaternion(seed))))
    omega = rng.normal(size=3)
    Rj = kin_j.update_rotation_matrix(
        jnp.asarray(Rm), jnp.asarray(omega), 0.05, forward_euler=forward_euler, theta=0.5
    )
    Rt = kin_t.update_rotation_matrix(
        torch.as_tensor(Rm), torch.as_tensor(omega), 0.05, forward_euler=forward_euler, theta=0.5
    )
    assert np.max(np.abs(np.asarray(Rj) - Rt.numpy())) <= TOL


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_numpy_twin_matches_torch_and_jax(seed):
    rng = np.random.default_rng(20 + seed)
    Rm = np.asarray(kin_j.rotation_matrix_from_quaternion(jnp.asarray(_quaternion(seed))))
    omega = rng.normal(size=3)
    Rn = kin_t.update_rotation_matrix_np(Rm, omega, 0.1)
    Rt = kin_t.update_rotation_matrix(torch.as_tensor(Rm), torch.as_tensor(omega), 0.1)
    assert np.max(np.abs(Rn - Rt.numpy())) <= TOL
    # the copied numpy function is the JAX package's, bit for bit
    assert np.array_equal(Rn, kin_j.update_rotation_matrix_np(Rm, omega, 0.1))


def test_rotation_2d_matches_jax():
    Rm = np.asarray(kin_j.rotation_matrix_2d(0.3))
    assert np.max(np.abs(Rm - kin_t.rotation_matrix_2d(0.3).numpy())) <= TOL
    Rj = kin_j.update_rotation_matrix(jnp.asarray(Rm), jnp.asarray(0.7), 0.1)
    Rt = kin_t.update_rotation_matrix(torch.as_tensor(Rm), 0.7, 0.1)
    assert np.max(np.abs(np.asarray(Rj) - Rt.numpy())) <= TOL
    assert np.array_equal(
        kin_t.update_rotation_matrix_np(Rm, 0.7, 0.1), kin_j.update_rotation_matrix_np(Rm, 0.7, 0.1)
    )


def test_pointwise_velocities_and_displacements_match_jax():
    rng = np.random.default_rng(5)
    U = rng.normal(size=6)
    N = rng.normal(size=(6, 11, 3))
    vj = kin_j.rigid_pointwise_velocities(jnp.asarray(U), jnp.asarray(N), 3, assemble_scaling=2.0)
    vt = kin_t.rigid_pointwise_velocities(torch.as_tensor(U), torch.as_tensor(N), 3, assemble_scaling=2.0)
    for a, b in zip(vj, vt):
        assert np.max(np.abs(np.asarray(a) - b.numpy())) <= 1e-14
    disp = rng.normal(size=(11, 3))
    axes = (True, False, True)
    dj = kin_j.integrate_displacements(jnp.asarray(disp), vj[1], 0.05, axes)
    dt = kin_t.integrate_displacements(torch.as_tensor(disp), vt[1], 0.05, axes)
    assert np.max(np.abs(np.asarray(dj) - dt.numpy())) <= 1e-14
    assert np.array_equal(dt.numpy()[:, 1], disp[:, 1])
