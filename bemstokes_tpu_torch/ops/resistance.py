"""Dirichlet-to-Neumann operator and the non-monolithic (grand resistance
matrix) solve strategy (port of `bemstokes_tpu/ops/resistance.py`; reference
`dirichlet_to_neumann_operator` `source/bem_stokes.cc:4073-4129` and
`solve_system(monolithic=false)` `:4163-4261`).

D2N: f = P_t V^-1 P_t K P_t v, with P_t the body tangential projector
removing the hydrostatic pressure mode.  The resistance strategy computes

    R_rs = N_dual_r . D2N(N_s)        (R x R grand resistance matrix)
    rhs_r = -N_dual_r . D2N(s_dot)  (+ imposed force/velocity rows)

solves the tiny R x R system for the rigid velocity, and reconstructs the
tractions f = D2N(s_dot) + sum_r U_r D2N(N_r).

The JAX package maps D2N over the R rigid modes with `jax.vmap`; here the
shape velocity and the modes are the R + 1 right-hand sides of one LU solve.
"""

from __future__ import annotations

import torch

from ..la.direct import lu_factor_dense, lu_solve_dense
from ..la.gmres import gmres
from ..utils import timers
from .corrections import tangential_projector


def dirichlet_to_neumann(
    V: torch.Tensor,
    K: torch.Tensor,
    v_flat: torch.Tensor,
    normal_pure_flat: torch.Tensor,
    M_normal_pure_flat: torch.Tensor,
    l2_gamma_pure,
    V_lu=None,
    gmres_opts: dict | None = None,
):
    """f = P_t V^-1 P_t K P_t v for v [d*n] or rows [B, d*n].  With V_lu
    (`lu_factor_dense` factors of V) the inner solve is direct, all rows in
    one solve; otherwise unpreconditioned GMRES, a row at a time."""

    def P_t(x):
        return tangential_projector(x, normal_pure_flat, M_normal_pure_flat, l2_gamma_pure)

    rhs = P_t(P_t(v_flat) @ K.T)
    if V_lu is not None:
        f = lu_solve_dense(V_lu, rhs.T).T if rhs.ndim == 2 else lu_solve_dense(V_lu, rhs)
    else:
        opts = dict(restart=100, tol=1e-10, max_restarts=4)
        opts.update(gmres_opts or {})
        rows = rhs if rhs.ndim == 2 else rhs[None]
        f = torch.stack([gmres(lambda x: V @ x, r, **opts)[0] for r in rows])
        f = f if rhs.ndim == 2 else f[0]
    return P_t(f)


def solve_resistance_system(
    V: torch.Tensor,
    K: torch.Tensor,
    shape_velocities_flat: torch.Tensor,
    N_flat: torch.Tensor,  # [R, d*n] rigid modes
    N_dual_flat: torch.Tensor,  # [R, d*n]
    normal_pure_flat: torch.Tensor,
    M_normal_pure_flat: torch.Tensor,
    l2_gamma_pure,
    grid_type: str = "Real",
    imposed_component: int = 0,
):
    """Non-monolithic solve.  Returns (rigid_velocities [R], stokes_forces
    [d*n], resistance_matrix [R, R])."""
    R = N_flat.shape[0]
    with timers.scope("Resistance V factor"):
        V_lu = lu_factor_dense(V)
    with timers.scope("Resistance D2N"):
        DN = dirichlet_to_neumann(
            V,
            K,
            torch.cat([shape_velocities_flat[None], N_flat]),
            normal_pure_flat,
            M_normal_pure_flat,
            l2_gamma_pure,
            V_lu=V_lu,
        )
    f_s, DN_N = DN[0], DN[1:]  # [d*n], [R, d*n]
    res_matrix = N_dual_flat @ DN_N.T  # R_rs = N_dual_r . D2N(N_s)
    rhs = -(N_dual_flat @ f_s)

    if grid_type == "ImposedForce":
        rhs[imposed_component] += 1.0
        A = res_matrix
    elif grid_type == "ImposedVelocity":
        A = torch.eye(R, dtype=V.dtype, device=V.device)
        rhs = torch.zeros((R,), dtype=V.dtype, device=V.device)
        rhs[imposed_component] = 1.0
    else:
        A = res_matrix

    U = torch.linalg.solve(A, rhs)
    forces = f_s + U @ DN_N
    return U, forces, res_matrix
