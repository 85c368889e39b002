"""Rigid-body kinematics: quaternion rotation updates and displacement
integration (reference `compute_rotation_matrix_from_quaternion`
`source/bem_stokes.cc:4512-4525`, `update_rotation_matrix` `:4528-4720`,
`update_system_state` `:4728-4846`).

Port of `bemstokes_tpu/physics/kinematics.py`.  Everything is tiny (3x3 /
4-vectors) plain torch on the device of its inputs; the Heun
predictor-corrector bookkeeping lives in the frame loop, these are the
stateless updates.  The frame loop itself advances its state on the host
with `update_rotation_matrix_np` (a copy of the reference package's numpy
twin).
"""

from __future__ import annotations

import numpy as np
import torch


def _stack2d(rows):
    """A matrix from nested lists of 0-d tensors."""
    return torch.stack([torch.stack(list(r)) for r in rows])


def rotation_matrix_from_quaternion(q: torch.Tensor) -> torch.Tensor:
    """q = (w, x, y, z) -> 3x3 rotation matrix, reference convention."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    return _stack2d(
        [
            [1.0 - 2.0 * (z * z + y * y), -2.0 * w * z + 2.0 * x * y, 2.0 * w * y + 2.0 * x * z],
            [2.0 * w * z + 2.0 * x * y, 1.0 - 2.0 * (z * z + x * x), -2.0 * w * x + 2.0 * z * y],
            [-2.0 * w * y + 2.0 * x * z, 2.0 * w * x + 2.0 * z * y, 1.0 - 2.0 * (x * x + y * y)],
        ]
    )


def quaternion_from_rotation_matrix(Rm: torch.Tensor) -> torch.Tensor:
    """Inverse of the above (assumes trace > -1, i.e. rotations accumulated
    continuously from identity, as in the reference `:4540-4554`)."""
    w = torch.sqrt(1.0 + Rm[0, 0] + Rm[1, 1] + Rm[2, 2]) / 2.0
    x = 0.25 * (Rm[2, 1] - Rm[1, 2]) / w
    y = 0.25 * (Rm[0, 2] - Rm[2, 0]) / w
    z = 0.25 * (Rm[1, 0] - Rm[0, 1]) / w
    q = torch.stack([w, x, y, z])
    return q / torch.linalg.vector_norm(q)


def _quaternion_rate(q: torch.Tensor, omega: torch.Tensor) -> torch.Tensor:
    """qdot = 0.5 S(q) (0, omega) — the reference's S_inv application
    (`:4557-4624`)."""
    w, x, y, z = q[0], q[1], q[2], q[3]
    ox, oy, oz = omega[0], omega[1], omega[2]
    return 0.5 * torch.stack(
        [
            -x * ox - y * oy - z * oz,
            w * ox + z * oy - y * oz,
            -z * ox + w * oy + x * oz,
            y * ox - x * oy + w * oz,
        ]
    )


def rotation_matrix_2d(angle) -> torch.Tensor:
    """2x2 counterclockwise rotation by `angle`."""
    if not isinstance(angle, torch.Tensor):  # a Python float is float64
        angle = torch.as_tensor(angle, dtype=torch.float64)
    c, s = torch.cos(angle), torch.sin(angle)
    return _stack2d([[c, -s], [s, c]])


def update_rotation_matrix(
    Rm: torch.Tensor,
    omega: torch.Tensor,
    dt: float,
    forward_euler: bool = True,
    theta: float = 0.5,
) -> torch.Tensor:
    """Advance the accumulated body rotation by angular velocity omega over
    dt: forward-Euler or theta-scheme (Crank-Nicolson at theta=0.5) on the
    quaternion ODE, renormalized (reference `:4630-4686`).

    2D (2x2 Rm): `omega` is the scalar rotation rate and the increment
    `Rot(omega dt) . Rm` is exact — SO(2) needs no quaternion scheme."""
    if Rm.shape[-1] == 2:
        ang = torch.as_tensor(omega, dtype=Rm.dtype, device=Rm.device).reshape(()) * dt
        return rotation_matrix_2d(ang) @ Rm
    q = quaternion_from_rotation_matrix(Rm)
    qdot = _quaternion_rate(q, omega)
    if forward_euler:
        q_new = q + dt * qdot
    else:
        ox, oy, oz = omega[0], omega[1], omega[2]
        h = theta * dt * 0.5
        # A_CN q_new = q + (1-theta) dt qdot with A_CN = I - theta dt/2 Omega,
        # Omega the rate matrix of `_quaternion_rate` (reference `:4643-4676`;
        # NOTE the reference's A_CN flips the signs of the spatial 3x3 block
        # relative to its own qdot — a latent inconsistency that is invisible
        # for fixed-axis omega, the only case its tests cover.  We build the
        # consistent matrix so FE and CN integrate the SAME ODE and CN is
        # genuinely 2nd order for time-varying axes.)
        one = torch.ones((), dtype=q.dtype, device=q.device)
        A = _stack2d(
            [
                [one, h * ox, h * oy, h * oz],
                [-h * ox, one, h * oz, -h * oy],
                [-h * oy, -h * oz, one, h * ox],
                [-h * oz, h * oy, -h * ox, one],
            ]
        )
        rhs = q + (1.0 - theta) * dt * qdot
        q_new = torch.linalg.solve(A, rhs)
    q_new = q_new / torch.linalg.vector_norm(q_new)
    return rotation_matrix_from_quaternion(q_new)


def update_rotation_matrix_np(Rm, omega, dt: float):
    """Host-numpy twin of `update_rotation_matrix(..., forward_euler=True)`.

    The swimmer frame loop advances a 3x3 (or 2x2) rotation once per frame
    on the host, beside its other numpy state math, so the loop uses this
    numpy version.  Kept next to the torch one and pinned to it and to the
    reference package's by tests/test_torch_kinematics.py."""
    Rm = np.asarray(Rm, dtype=np.float64)
    if Rm.shape[-1] == 2:
        ang = float(np.asarray(omega)) * dt
        c, s = np.cos(ang), np.sin(ang)
        return np.array([[c, -s], [s, c]]) @ Rm
    w = np.sqrt(1.0 + Rm[0, 0] + Rm[1, 1] + Rm[2, 2]) / 2.0
    x = 0.25 * (Rm[2, 1] - Rm[1, 2]) / w
    y = 0.25 * (Rm[0, 2] - Rm[2, 0]) / w
    z = 0.25 * (Rm[1, 0] - Rm[0, 1]) / w
    q = np.array([w, x, y, z])
    q = q / np.linalg.norm(q)
    ox, oy, oz = (float(o) for o in np.asarray(omega))
    qd = 0.5 * np.array(
        [
            -q[1] * ox - q[2] * oy - q[3] * oz,
            q[0] * ox + q[3] * oy - q[2] * oz,
            -q[3] * ox + q[0] * oy + q[1] * oz,
            q[2] * ox - q[1] * oy + q[0] * oz,
        ]
    )
    qn = q + dt * qd
    qn = qn / np.linalg.norm(qn)
    w, x, y, z = qn
    return np.array(
        [
            [1.0 - 2.0 * (z * z + y * y), -2.0 * w * z + 2.0 * x * y, 2.0 * w * y + 2.0 * x * z],
            [2.0 * w * z + 2.0 * x * y, 1.0 - 2.0 * (z * z + x * x), -2.0 * w * x + 2.0 * z * y],
            [-2.0 * w * y + 2.0 * x * z, 2.0 * w * x + 2.0 * z * y, 1.0 - 2.0 * (x * x + y * y)],
        ]
    )


def rigid_pointwise_velocities(
    rigid_velocities: torch.Tensor,  # [R]
    N: torch.Tensor,  # [R, n, d]
    dim: int,
    assemble_scaling: float = 1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(full rigid velocity field, translation-only field), both [n, d]
    (reference `:4785-4791`)."""
    v_full = torch.einsum("r,rnd->nd", assemble_scaling * rigid_velocities, N)
    v_tr = torch.einsum(
        "r,rnd->nd", assemble_scaling * rigid_velocities[:dim], N[:dim]
    )
    return v_full, v_tr


def integrate_displacements(
    rigid_displacements: torch.Tensor,  # [n, d] accumulated
    translation_velocity_field: torch.Tensor,  # [n, d]
    dt: float,
    axes_enabled: tuple[bool, bool, bool],
) -> torch.Tensor:
    """Forward-Euler displacement accumulation with per-axis enable flags
    (reference bool_dipl_x/y/z, `:4820-4845`)."""
    delta = dt * translation_velocity_field
    mask = torch.tensor(
        [1.0 if e else 0.0 for e in axes_enabled],
        dtype=rigid_displacements.dtype,
        device=rigid_displacements.device,
    )
    return rigid_displacements + delta * mask[None, :]
