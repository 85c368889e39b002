"""Dense LU direct solver / stale-LU preconditioner (port of
`bemstokes_tpu/la/direct.py`).

The reference's DirectPreconditioner wraps a Trilinos Amesos LU: factor the
monolithic matrix once, apply the (possibly stale) factorization as a
preconditioner on later frames, and refactor when GMRES iteration counts blow
past a trigger (reference `include/direct_preconditioner.h:25-27`,
`source/bem_stokes.cc:4336-4339, 5768-5779`).

The factorization is `torch.linalg.lu_factor` (LAPACK on the CPU, cuSOLVER
on the GPU).  The JAX package's single-chip blocked LU (`blocked_lu_*`) is
not ported: it works around a size limit of XLA's LU on the TPU, which the
GPU does not have.

Every LU apply of the port is `lu_apply`: the factor's pivots are turned
into a row permutation once, on the host, when it factors
(`pivots_to_permutation`), and each apply is one gather before the two
triangular solves: for one right-hand side `torch.linalg.lu_solve` on the GPU
walks the n row interchanges on one thread at every call before the same two
solves.  It serves one vector, several columns and a batch of diagonal
blocks (block-Jacobi), and `bordered_solver` closes a surface solve over a
small saddle tail with it, bit for bit `lu_solve`'s on the CPU.  The stale
LU on the card (`LUPreconditioner`, and the distributed block-Jacobi's slab
block) applies its single dense factor to one vector through the
hand-written kernel of `csrc/lu_trsv.cu` instead (`ops.lu_trsv`, its plan
made once a factorization): the gather and both solves in two launches,
each triangle read once (counter `lu applies native`); it rounds otherwise
than cuBLAS.  The preconditioner's counters `lu permutations` (one a
factorization) and `lu applies` (one an apply) show the reuse.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import lu_trsv
from ..utils import timers


def lu_factor_dense(A: torch.Tensor):
    """LU factors (LU, pivots) of a dense square matrix (or a batch of them).
    `torch.linalg.lu_factor` reads the factor's status back to raise on a
    singular matrix, so the host waits here for the factor: a host sync."""
    with timers.host_sync():
        return torch.linalg.lu_factor(A)


def pivots_to_permutation(piv: torch.Tensor) -> torch.Tensor:
    """LAPACK's 1-based row interchanges (row i swapped with row piv[i] - 1,
    in order) -> the permutation p with (P A)[i] = A[p[i]], on the pivots'
    device, without forming the n x n permutation matrix.  `piv` is [n] or a
    batch [nb, n] (one permutation a block); the pivots' one read back and
    the permutation's upload are host syncs."""
    with timers.host_sync():
        swaps = piv.reshape(-1, piv.shape[-1]).cpu().tolist()
    perms = []
    for row in swaps:
        perm = list(range(len(row)))
        for i, j in enumerate(row):
            perm[i], perm[j - 1] = perm[j - 1], perm[i]
        perms.append(perm)
    with timers.host_sync():
        return torch.tensor(perms, dtype=torch.long, device=piv.device).reshape(piv.shape)


def lu_apply(lu: torch.Tensor, perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve with an LU and its kept row permutation: one gather, then the
    two triangular solves of `torch.linalg.lu_solve`'s route (its bits,
    without its walk over the pivots).  `b` is [n] or [n, k] for an [n, n]
    factor, or [nb, n, k] for a batch of [nb, n, n] factors with perm
    [nb, n]."""
    x = b[:, None] if b.ndim == 1 else b
    x = x.gather(-2, perm[..., None].expand(x.shape)) if x.ndim == 3 else x[perm]
    x = torch.linalg.solve_triangular(lu, x, upper=False, unitriangular=True)
    x = torch.linalg.solve_triangular(lu, x, upper=True)
    return x[:, 0] if b.ndim == 1 else x


def lu_solve_dense(factors, b: torch.Tensor) -> torch.Tensor:
    """Solve with `lu_factor_dense` factors (LU, pivots); b is [n] or
    [n, k].  The pivots become the permutation at each call: a caller that
    solves more than once keeps `pivots_to_permutation`'s instead."""
    lu, piv = factors
    return lu_apply(lu, pivots_to_permutation(piv), b)


def bordered_solver(solve, C: torch.Tensor, B: torch.Tensor, D: torch.Tensor):
    """The exact inverse of the bordered matrix [[A_s, C], [B, D]] given the
    surface block's solve `solve(v)` = A_s^-1 v (for v [m] and [m, k]):
    with Z = A_s^-1 C and the Schur complement S = D - B Z, factored once,

        [v_s; v_t] -> x_t = S^-1 (v_t - B A_s^-1 v_s),  x_s = A_s^-1 v_s - Z x_t.

    Returns the apply (one surface solve and one small LU apply a call)."""
    Z = solve(C)
    S_lu, S_piv = lu_factor_dense(D - B @ Z)
    S_perm = pivots_to_permutation(S_piv)
    m = C.shape[0]

    def apply(v):
        ys = solve(v[:m])
        xt = lu_apply(S_lu, S_perm, v[m:] - B @ ys)
        return torch.cat([ys - Z @ xt, xt])

    return apply


@dataclasses.dataclass
class LUPreconditioner:
    """Stateful stale-LU preconditioner with the reference's refactor-on-
    iteration-count semantics.

    `factor_dtype` (e.g. torch.float32) factors in that dtype and casts on
    apply, while GMRES iterates in the problem dtype — a stale approximate
    factorization is a preconditioner either way.

    The apply uses the permutation kept from the factorization.  On the
    card it is the hand-written kernel, through the factor's `ops.lu_trsv`
    plan made with it; on the CPU it is `lu_apply`, `torch.linalg.lu_solve`'s
    route for one right-hand side, bit for bit."""

    refactor_iteration_trigger: int = 100
    factor_dtype: torch.dtype | None = None
    _factors: tuple | None = None
    _perm: torch.Tensor | None = None
    _plan: lu_trsv.TrsvPlan | None = None

    def set_up(self, A: torch.Tensor):
        if self.factor_dtype is not None:
            A = A.to(self.factor_dtype)
        self._plan = None  # the old plan's scratch before the new factor
        self._factors = lu_factor_dense(A)
        self._perm = pivots_to_permutation(self._factors[1])
        self._plan = lu_trsv.plan(self._factors[0])
        timers.count("lu permutations")

    @property
    def initialized(self) -> bool:
        return self._factors is not None

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        if self._factors is None:
            raise RuntimeError("LUPreconditioner not initialized")
        timers.count("lu applies")
        lu = self._factors[0]
        b = v.to(lu.dtype)
        x = lu_apply(lu, self._perm, b) if self._plan is None else self._plan.solve(self._perm, b)
        return x.to(v.dtype)

    def maybe_refactor(self, A: torch.Tensor, last_iterations: int) -> bool:
        """Refactor if the last solve needed too many iterations. Returns
        whether a refactorization happened."""
        if (
            self._factors is None
            or last_iterations > self.refactor_iteration_trigger
        ):
            self.set_up(A)
            return True
        return False
