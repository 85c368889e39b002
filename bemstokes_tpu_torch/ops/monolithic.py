"""Monolithic saddle system coupling the BIE blocks to the rigid-body
balance rows (port of `bemstokes_tpu/ops/monolithic.py`; reference
`source/bem_stokes.cc:3152-3360`):

    A x = [ V . (m_V x_s) - K . (m_K x_s) - scale * tmp_N^T u ;
            rows(N_dual) x_s  (or identity rows for ImposedVelocity) ]

Column selection per BC set (columns = unknowns at that node):
  body / no-slip wall / dirichlet wall  -> V (traction unknown)
  neumann wall                          -> -K (velocity unknown)
  free-surface wall: wall-normal component -> V, tangential -> -K
  do-nothing wall:   wall-normal component -> -K, tangential -> V
(reference `:3196-3243`.)
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.surface_mesh import (
    MATERIAL_BODY,
    MATERIAL_WALL_NO_SLIP,
    MATERIAL_WALL_FREE_SURFACE,
    MATERIAL_WALL_DO_NOTHING,
    MATERIAL_WALL_DIRICHLET,
)
from ..utils import timers

GRID_REAL = "Real"
GRID_IMPOSED_FORCE = "ImposedForce"
GRID_IMPOSED_VELOCITY = "ImposedVelocity"
GRID_CONVERGENCE = "Convergence"


def operator_column_mask(
    bc_material_per_node: torch.Tensor,  # [n] material id of each scalar node
    normal_flat: torch.Tensor,  # [d*n] projected FE normal
    n_nodes: int,
    dim: int,
) -> torch.Tensor:
    """Boolean mask over flat columns: True -> V column, False -> -K column."""
    mat = bc_material_per_node.repeat(dim)  # [d*n]
    is_normal_comp = torch.abs(torch.abs(normal_flat) - 1.0) < 5e-2
    return (
        (mat == MATERIAL_BODY)
        | (mat == MATERIAL_WALL_NO_SLIP)
        | (mat == MATERIAL_WALL_DIRICHLET)
        | ((mat == MATERIAL_WALL_FREE_SURFACE) & is_normal_comp)
        | ((mat == MATERIAL_WALL_DO_NOTHING) & ~is_normal_comp)
    )


def imposed_tail_vector(
    num_rigid: int,
    dim: int,
    imposed_component: int,
    angle: float = 0.0,
    rotate: bool = False,
    dtype=torch.float64,
    device=None,
) -> torch.Tensor:
    """Rhs tail [R] for ImposedForce / ImposedVelocity / Convergence runs: a
    unit vector at `imposed_component`, optionally rotated about the x-axis
    by `angle_for_imposed_stuff` and placed in the translation block (when
    imposed_component < dim) or the rotation block (reference
    `source/bem_stokes.cc:3277-3311`, Rodrigues rotation `:846-875`).

    NOTE (parity quirk): the reference applies the rotation only when
    `dim == 3 && extra_debug_info == true` (`:3286-3293`); callers pass that
    gate as `rotate`."""
    e = np.zeros(dim)
    e[imposed_component % dim] = 1.0
    if rotate and dim == 3 and angle != 0.0:
        c, s = np.cos(angle), np.sin(angle)
        Rx = np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
        e = Rx @ e
    tail = np.zeros(num_rigid)
    if imposed_component < dim:
        tail[:dim] = e
    else:
        tail[dim:num_rigid] = e[: num_rigid - dim]
    with timers.host_sync():
        return torch.as_tensor(tail, dtype=dtype, device=device)


def build_monolithic_system(
    V: torch.Tensor,  # [d*n, d*n]
    K: torch.Tensor,  # [d*n, d*n]
    sel_V: torch.Tensor,  # [d*n] bool column mask
    tmp_N: torch.Tensor,  # [R, d*n] projected rigid columns P_t K P_t N_r
    N_dual: torch.Tensor,  # [R, d*n] M-duals of the rigid modes
    rhs_surface: torch.Tensor,  # [d*n] P_t K P_t s_dot (zero if grid != Real)
    grid_type: str = GRID_REAL,
    imposed_component: int = 0,
    assemble_scaling: float = 1.0,
    tmp_torque: torch.Tensor | None = None,  # [d*n] P_t K P_t N_flag_torque
    torque_dual: torch.Tensor | None = None,  # [d*n] M N_flagellum_torque
    imposed_motor_torque: float = -2.0,
    imposed_tail: torch.Tensor | None = None,  # [R] rhs tail override
):
    """Materialize A [d*n+R(+1), d*n+R(+1)] and rhs (for the LU/direct path
    and as the preconditioner matrix).

    With `tmp_torque`/`torque_dual` the system gains the motor-torque
    unknown: the flagellum rotation rate omega becomes an extra column
    (-scale * tmp_torque on the surface rows) and the imposed motor torque an
    extra balance row (scale * torque_dual^T f = imposed_motor_torque), with
    a zero surface rhs — reference `solve_with_torque`,
    `source/bem_stokes.cc:3191-3192, 3252-3256, 3340-3356`."""
    dn = V.shape[0]
    R = tmp_N.shape[0]
    dt, dev = V.dtype, V.device
    with_torque = tmp_torque is not None
    size = dn + R + (1 if with_torque else 0)
    A = torch.empty((size, size), dtype=dt, device=dev)
    # top-left: V columns where sel_V, -K elsewhere (built in A itself: no
    # dense -K temporary)
    top = A[:dn, :dn]
    torch.where(sel_V[None, :], V, K, out=top)
    with timers.host_sync():  # the masks' selections read their counts back
        top[:, ~sel_V] = -top[:, ~sel_V]
    A[:dn, dn : dn + R] = -assemble_scaling * tmp_N.T  # [dn, R]

    rigid = slice(dn, dn + R)
    if grid_type == GRID_IMPOSED_VELOCITY:
        A[rigid, :dn] = 0.0
        A[rigid, rigid] = assemble_scaling * torch.eye(R, dtype=dt, device=dev)
    elif grid_type == GRID_REAL:
        A[rigid, :dn] = assemble_scaling * N_dual
        A[rigid, rigid] = 0.0
    else:  # ImposedForce / Convergence: momentum rows, unscaled
        A[rigid, :dn] = N_dual
        A[rigid, rigid] = 0.0

    rhs_tail = torch.zeros((R,), dtype=dt, device=dev)
    if grid_type != GRID_REAL:
        rhs_head = torch.zeros((dn,), dtype=dt, device=dev)
        if imposed_tail is not None:
            rhs_tail = imposed_tail.to(dt)
        else:
            rhs_tail[imposed_component] = 1.0
    else:
        rhs_head = rhs_surface
    if not with_torque:
        return A, torch.cat([rhs_head, rhs_tail])

    A[:dn, -1] = -assemble_scaling * tmp_torque
    A[rigid, -1] = 0.0
    A[-1, :dn] = assemble_scaling * torque_dual
    A[-1, dn:] = 0.0
    # the gait is the unknown: zero surface rhs (reference `:3191-3192`)
    rhs = torch.cat(
        [
            torch.zeros((dn,), dtype=dt, device=dev),
            rhs_tail,
            torch.full((1,), imposed_motor_torque, dtype=dt, device=dev),
        ]
    )
    return A, rhs


def split_monolithic_solution(
    x: torch.Tensor, sel_V: torch.Tensor, n_rigid: int, assemble_scaling: float = 1.0
):
    """Split the monolithic solution into (stokes_forces, wall_velocities,
    rigid_velocities) — the diagonal-operator test of the reference
    (`source/bem_stokes.cc:4351-4414`) reduces to the column mask, and the
    rigid tail is un-scaled (`:4457-4462`)."""
    dn = x.shape[0] - n_rigid
    surf = x[:dn]
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    forces = torch.where(sel_V, surf, zero)
    wall_vel = torch.where(sel_V, zero, surf)
    rigid = x[dn:] * assemble_scaling
    return forces, wall_vel, rigid
