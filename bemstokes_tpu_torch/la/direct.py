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

The preconditioner turns the factor's pivots into a row permutation once, on
the host, when it factors, and applies it as one gather: for one right-hand
side `torch.linalg.lu_solve` on the GPU walks the n row interchanges on one
thread at every call before the same two triangular solves.  The counters
`lu permutations` (one a factorization) and `lu applies` (one an apply) show
the reuse.
"""

from __future__ import annotations

import dataclasses

import torch

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
    device, without forming the n x n permutation matrix.  The pivots' read
    back and the permutation's upload are host syncs."""
    with timers.host_sync():
        swaps = piv.cpu().tolist()
    perm = list(range(len(swaps)))
    for i, j in enumerate(swaps):
        perm[i], perm[j - 1] = perm[j - 1], perm[i]
    with timers.host_sync():
        return torch.tensor(perm, dtype=torch.long, device=piv.device)


def lu_solve_dense(factors, b: torch.Tensor) -> torch.Tensor:
    """Solve with `lu_factor_dense` factors; b is [n] or [n, k]."""
    lu, piv = factors
    if b.ndim == 1:
        return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
    return torch.linalg.lu_solve(lu, piv, b)


@dataclasses.dataclass
class LUPreconditioner:
    """Stateful stale-LU preconditioner with the reference's refactor-on-
    iteration-count semantics.

    `factor_dtype` (e.g. torch.float32) factors in that dtype and casts on
    apply, while GMRES iterates in the problem dtype — a stale approximate
    factorization is a preconditioner either way.

    The apply is `torch.linalg.lu_solve`'s route for one right-hand side,
    bit for bit, with the permutation kept from the factorization."""

    refactor_iteration_trigger: int = 100
    factor_dtype: torch.dtype | None = None
    _factors: tuple | None = None
    _perm: torch.Tensor | None = None

    def set_up(self, A: torch.Tensor):
        if self.factor_dtype is not None:
            A = A.to(self.factor_dtype)
        self._factors = lu_factor_dense(A)
        self._perm = pivots_to_permutation(self._factors[1])
        timers.count("lu permutations")

    @property
    def initialized(self) -> bool:
        return self._factors is not None

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        if self._factors is None:
            raise RuntimeError("LUPreconditioner not initialized")
        timers.count("lu applies")
        lu = self._factors[0]
        x = v.to(lu.dtype)[self._perm, None]
        x = torch.linalg.solve_triangular(lu, x, upper=False, unitriangular=True)
        x = torch.linalg.solve_triangular(lu, x, upper=True)
        return x[:, 0].to(v.dtype)

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
