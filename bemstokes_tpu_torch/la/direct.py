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
    factorization is a preconditioner either way."""

    refactor_iteration_trigger: int = 100
    factor_dtype: torch.dtype | None = None
    _factors: tuple | None = None

    def set_up(self, A: torch.Tensor):
        if self.factor_dtype is not None:
            A = A.to(self.factor_dtype)
        self._factors = lu_factor_dense(A)

    @property
    def initialized(self) -> bool:
        return self._factors is not None

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        if self._factors is None:
            raise RuntimeError("LUPreconditioner not initialized")
        fdt = self._factors[0].dtype
        if v.dtype != fdt:
            return lu_solve_dense(self._factors, v.to(fdt)).to(v.dtype)
        return lu_solve_dense(self._factors, v)

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
