"""Preconditioner family for the monolithic GMRES solve (port of
`bemstokes_tpu/la/preconditioners.py`).

The reference selects among Trilinos preconditioners by name — ILU (IFPACK),
AMG (ML), Jacobi, SOR, SSOR, Direct (stale Amesos LU) — at
`source/bem_stokes.cc:4283-4313`.  The BEM operators here are DENSE, so each
name maps onto a dense equivalent, as in the JAX package:

- "Jacobi":   diagonal scaling;
- "SOR"/"SSOR": one forward (resp. forward + backward) Gauss-Seidel sweep
  with relaxation omega, as dense triangular solves
  (`torch.linalg.solve_triangular`);
- "ILU", "AMG", "BlockJacobi": block-Jacobi LU — exact LU of the diagonal
  blocks, one batched `lu_factor_dense` over [n_blocks, nb, nb], applied by
  `lu_apply`;
- "Direct":   the stale-LU preconditioner of `la/direct.py`.

A `bandwith` limit (reference `bandwith_preconditioner`,
`source/bem_stokes.cc:1724-1761`) masks the matrix to a band before
factorization.  Every `apply` takes and returns a flat [n] tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from .direct import LUPreconditioner, lu_apply, lu_factor_dense, pivots_to_permutation


def band_mask(A: torch.Tensor, bandwith: int) -> torch.Tensor:
    """Zero all entries outside the +-bandwith diagonal band, keeping the
    diagonal (the reference's banded preconditioner sparsity)."""
    n = A.shape[0]
    i = torch.arange(n, device=A.device)
    keep = torch.abs(i[:, None] - i[None, :]) <= bandwith
    return torch.where(keep, A, torch.zeros_like(A))


def _safe_diag(A: torch.Tensor) -> torch.Tensor:
    """Diagonal with zeros replaced by 1: the monolithic saddle system has a
    ZERO bottom-right rigid block (grid Real), which would make triangular /
    LU preconditioner factors singular (NaN poisoning the whole GMRES)."""
    d = torch.diagonal(A)
    return torch.where(d == 0, torch.ones_like(d), d)


def _solve_tri(M: torch.Tensor, v: torch.Tensor, upper: bool) -> torch.Tensor:
    return torch.linalg.solve_triangular(M, v[:, None], upper=upper)[:, 0]


@dataclasses.dataclass
class JacobiPreconditioner:
    inv_diag: torch.Tensor

    @classmethod
    def build(cls, A: torch.Tensor):
        return cls(inv_diag=1.0 / _safe_diag(A))

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return self.inv_diag * v


@dataclasses.dataclass
class SORPreconditioner:
    """One SOR sweep: solve (D/omega + L) x = v (forward triangular)."""

    M: torch.Tensor  # lower-triangular factor incl. scaled diagonal
    omega: float = 1.0

    @classmethod
    def build(cls, A: torch.Tensor, omega: float = 1.0):
        M = torch.tril(A, -1) + torch.diag(_safe_diag(A) / omega)
        return cls(M=M, omega=omega)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return _solve_tri(self.M, v, upper=False)


@dataclasses.dataclass
class SSORPreconditioner:
    """Symmetric SOR sweep:
    x = (D/omega + U)^-1 . D/omega . (D/omega + L)^-1 v  (scaled)."""

    Ml: torch.Tensor
    Mu: torch.Tensor
    diag_scaled: torch.Tensor

    @classmethod
    def build(cls, A: torch.Tensor, omega: float = 1.0):
        D = _safe_diag(A) / omega
        Ml = torch.tril(A, -1) + torch.diag(D)
        Mu = torch.triu(A, 1) + torch.diag(D)
        return cls(Ml=Ml, Mu=Mu, diag_scaled=D)

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        y = _solve_tri(self.Ml, v, upper=False)
        return _solve_tri(self.Mu, self.diag_scaled * y, upper=True)


def _block_lu_factor(A: torch.Tensor, n_blocks: int):
    """LU factors of the n_blocks diagonal blocks of A, in one batched
    factorization; the zero diagonal entries (the rigid saddle tail) become
    1 and the padding of the last block is the identity, so every block
    stays invertible."""
    n = A.shape[0]
    nb = -(-n // n_blocks)  # block size, ceil
    pad = n_blocks * nb - n
    i = torch.arange(n, device=A.device)
    Ap = torch.zeros((n_blocks * nb, n_blocks * nb), dtype=A.dtype, device=A.device)
    Ap[:n, :n] = A
    Ap[i, i] = _safe_diag(A)
    idx = torch.arange(n, n + pad, device=A.device)
    Ap[idx, idx] = 1.0
    blocks = torch.stack(
        [Ap[k * nb : (k + 1) * nb, k * nb : (k + 1) * nb] for k in range(n_blocks)]
    )
    return lu_factor_dense(blocks)


def _block_lu_solve(factors, v: torch.Tensor, n_blocks: int, n: int) -> torch.Tensor:
    """Apply the blocks' (LU, row permutation) to a flat [n] vector."""
    nb = -(-n // n_blocks)
    vp = torch.zeros((n_blocks * nb,), dtype=v.dtype, device=v.device)
    vp[:n] = v
    y = lu_apply(*factors, vp.reshape(n_blocks, nb, 1))
    return y.reshape(-1)[:n]


@dataclasses.dataclass
class BlockJacobiPreconditioner:
    """Exact LU of the diagonal blocks (the dense stand-in for ILU/AMG);
    `factors` the blocks' LU and row permutations."""

    factors: tuple
    n_blocks: int
    n: int

    @classmethod
    def build(cls, A: torch.Tensor, n_blocks: int = 8):
        lu, piv = _block_lu_factor(A, n_blocks)
        return cls(factors=(lu, pivots_to_permutation(piv)), n_blocks=n_blocks, n=A.shape[0])

    def apply(self, v: torch.Tensor) -> torch.Tensor:
        return _block_lu_solve(self.factors, v, self.n_blocks, self.n)


def build_preconditioner(
    A: torch.Tensor,
    kind: str,
    *,
    omega: float = 1.0,
    n_blocks: int = 8,
    bandwith: int | None = None,
    refactor_iteration_trigger: int = 100,
):
    """Name-based dispatch mirroring the reference's selection
    (`source/bem_stokes.cc:4283-4313`).  Returns an object with `.apply(v)`."""
    if bandwith is not None:
        A = band_mask(A, bandwith)
    if kind == "Jacobi":
        return JacobiPreconditioner.build(A)
    if kind == "SOR":
        return SORPreconditioner.build(A, omega)
    if kind == "SSOR":
        return SSORPreconditioner.build(A, omega)
    if kind in ("ILU", "AMG", "BlockJacobi"):
        return BlockJacobiPreconditioner.build(A, n_blocks)
    if kind == "Direct":
        p = LUPreconditioner(refactor_iteration_trigger)
        p.set_up(A)
        return p
    raise ValueError(f"unknown preconditioner type {kind!r}")
