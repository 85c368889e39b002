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

`SaddleTail` holds everything beyond the surface block (the rigid and
motor-torque columns and rows, the rhs, the hanging-node rows' share): the
dense (`problem.py`), matrix-free (`matfree.py`) and distributed
(`parallel/solve.py`) frame steps all take their tail from it.
"""

from __future__ import annotations

import dataclasses

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


@dataclasses.dataclass
class SaddleTail:
    """The monolithic system beyond its surface block: the rigid (and
    motor-torque) columns, the rows that close them and the rhs, written
    once for the dense, the matrix-free and the distributed frame steps.

    With the surface block S (V or -K columns, `operator_column_mask`), the
    R rigid unknowns u and, under `solve_with_torque`, the flagellum rate
    omega (reference `source/bem_stokes.cc:3152-3360`):

        [ S                 -scale tmp_N^T   -scale tmp_torque ] [x_s  ]
        [ rigid rows        D_rr             0                 ] [u    ]
        [ scale torque_dual  0               0                 ] [omega]

    The rigid rows by `grid_type`: ImposedVelocity `scale * I` on u (zero
    surface columns), Real `scale * N_dual`, ImposedForce and Convergence
    `N_dual` unscaled.  The rhs: the surface rhs on the head for Real without
    the torque unknown, a zero head otherwise (the gait rate is then an
    unknown, reference `:3191-3192`); `rhs_tail` (zero for Real) on the
    rigid rows; the imposed motor torque on the last row.  The hanging-node
    rows `constrained` carry no rigid or torque column and a zero rhs (the
    caller writes their interpolation identity into the surface rows)."""

    grid_type: str
    scale: float
    tmp_N: torch.Tensor  # [R, d*n] P_t K P_t N_r
    N_dual: torch.Tensor  # [R, d*n] M-duals of the rigid modes
    rhs_tail: torch.Tensor  # [R]
    tmp_torque: torch.Tensor | None = None  # [d*n] P_t K P_t N_flag_torque
    torque_dual: torch.Tensor | None = None  # [d*n] M N_flagellum_torque
    motor_torque: float = -2.0
    constrained: torch.Tensor | None = None  # [c] constrained flat rows

    def __post_init__(self):
        self.R, self.dn = self.tmp_N.shape
        self.size = self.R + (self.tmp_torque is not None)  # unknowns beyond the surface
        if self.constrained is not None:
            self.tmp_N = self.tmp_N.clone()
            self.tmp_N[:, self.constrained] = 0.0
            if self.tmp_torque is not None:
                self.tmp_torque = self.tmp_torque.clone()
                self.tmp_torque[self.constrained] = 0.0

    @classmethod
    def from_config(cls, cfg, tmp_N, N_dual, tmp_torque=None, torque_dual=None, constrained=None):
        """The tail of a frame under `cfg` (a `ProblemConfig`): the torque
        unknown when `cfg.solve_with_torque`, the imposed rhs tail of
        `imposed_tail_vector` off the Real grid; `constrained` the flat rows
        of `HangingConstraints.flat_rows` on the device, or None."""
        if cfg.grid_type == GRID_REAL:
            rhs_tail = torch.zeros((tmp_N.shape[0],), dtype=tmp_N.dtype, device=tmp_N.device)
        else:
            rhs_tail = imposed_tail_vector(
                tmp_N.shape[0],
                cfg.dim,
                cfg.imposed_component,
                angle=cfg.angle_for_imposed_stuff,
                rotate=cfg.extra_debug_info,
                dtype=tmp_N.dtype,
                device=tmp_N.device,
            )
        if not cfg.solve_with_torque:
            tmp_torque = torque_dual = None
        return cls(
            cfg.grid_type, cfg.assemble_scaling, tmp_N, N_dual, rhs_tail, tmp_torque, torque_dual,
            cfg.imposed_motor_torque, constrained,
        )

    def _zero_constrained(self, v):
        if self.constrained is not None:
            v[self.constrained] = 0.0
        return v

    def rhs(self, rhs_surface: torch.Tensor) -> torch.Tensor:
        """The full rhs [d*n + size] from the surface rhs P_t K P_t s_dot."""
        dt, dev = self.tmp_N.dtype, self.tmp_N.device
        parts = [self.rhs_tail]
        if self.tmp_torque is not None:
            parts.append(torch.full((1,), self.motor_torque, dtype=dt, device=dev))
        if self.grid_type == GRID_REAL and self.tmp_torque is None:
            head = rhs_surface
        else:
            head = torch.zeros((self.dn,), dtype=dt, device=dev)
        return self._zero_constrained(torch.cat([head, *parts]))

    def frozen_rhs(self, rhs_surface: torch.Tensor) -> torch.Tensor:
        """The rhs of the frozen-geometry re-solve: the new surface rhs over
        a zero tail, whatever the grid (the reference's squirmer branch
        rebuilds the surface rhs only, `:5734-5759`)."""
        tail = torch.zeros((self.size,), dtype=rhs_surface.dtype, device=rhs_surface.device)
        return self._zero_constrained(torch.cat([rhs_surface, tail]))

    def apply(self, head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The monolithic action on x [d*n + size], given the surface
        block's action `head` on x[:d*n]: the rigid and torque columns added
        to the surface rows, then the rigid rows and the motor balance."""
        dn, R, scale = self.dn, self.R, self.scale
        xs, u = x[:dn], x[dn : dn + R]
        top = head - scale * (u @ self.tmp_N)
        if self.tmp_torque is not None:
            top = top - scale * self.tmp_torque * x[-1]
        if self.grid_type == GRID_IMPOSED_VELOCITY:
            mid = scale * u
        elif self.grid_type == GRID_REAL:
            mid = scale * (self.N_dual @ xs)
        else:  # ImposedForce / Convergence: momentum rows, unscaled
            mid = self.N_dual @ xs
        parts = [top, mid]
        if self.tmp_torque is not None:
            parts.append(scale * torch.dot(self.torque_dual, xs)[None])
        return torch.cat(parts)

    def border(self):
        """(C [d*n, size], B [size, d*n], D [size, size]): the columns, the
        rows and the corner of the system's border, for its dense form and
        its Schur complement."""
        dt, dev = self.tmp_N.dtype, self.tmp_N.device
        scale, R, T = self.scale, self.R, self.size
        C = torch.empty((self.dn, T), dtype=dt, device=dev)
        B = torch.zeros((T, self.dn), dtype=dt, device=dev)
        D = torch.zeros((T, T), dtype=dt, device=dev)
        C[:, :R] = -scale * self.tmp_N.T
        if self.grid_type == GRID_IMPOSED_VELOCITY:
            D[:R, :R] = scale * torch.eye(R, dtype=dt, device=dev)
        elif self.grid_type == GRID_REAL:
            B[:R] = scale * self.N_dual
        else:
            B[:R] = self.N_dual
        if self.tmp_torque is not None:
            C[:, R] = -scale * self.tmp_torque
            B[R] = scale * self.torque_dual
        return C, B, D

    def system(self, V, K, sel_V, rhs_surface):
        """The dense system (A [d*n + size]^2, rhs): V columns where sel_V,
        -K elsewhere (written in A itself: no dense -K temporary), then the
        border."""
        dn = self.dn
        size = dn + self.size
        A = torch.empty((size, size), dtype=V.dtype, device=V.device)
        top = A[:dn, :dn]
        torch.where(sel_V[None, :], V, K, out=top)
        with timers.host_sync():  # the masks' selections read their counts back
            top[:, ~sel_V] = -top[:, ~sel_V]
        A[:dn, dn:], A[dn:, :dn], A[dn:, dn:] = self.border()
        return A, self.rhs(rhs_surface)


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
    """Materialize A [d*n+R(+1), d*n+R(+1)] and rhs (the JAX package's entry;
    the frame steps build a `SaddleTail` and call its `system`).

    With `tmp_torque`/`torque_dual` the system gains the motor-torque
    unknown: the flagellum rotation rate omega becomes an extra column
    (-scale * tmp_torque on the surface rows) and the imposed motor torque an
    extra balance row (scale * torque_dual^T f = imposed_motor_torque), with
    a zero surface rhs — reference `solve_with_torque`,
    `source/bem_stokes.cc:3191-3192, 3252-3256, 3340-3356`."""
    rhs_tail = torch.zeros((tmp_N.shape[0],), dtype=V.dtype, device=V.device)
    if grid_type != GRID_REAL:
        if imposed_tail is not None:
            rhs_tail = imposed_tail.to(V.dtype)
        else:
            rhs_tail[imposed_component] = 1.0
    if tmp_torque is None:
        torque_dual = None
    tail = SaddleTail(
        grid_type, assemble_scaling, tmp_N, N_dual, rhs_tail, tmp_torque, torque_dual, imposed_motor_torque
    )
    return tail.system(V, K, sel_V, rhs_surface)


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
