"""Distributed dense blocked LU over the row-slab layout (port of
`bemstokes_tpu/parallel/lu.py`): the sharded DirectPreconditioner
(reference `source/direct_preconditioner.cc:1-23` wraps a rank-gathering
Amesos LU).

Layout.  Rank k owns the m = d*nloc rows of its node slab (`sharded`).  For
the factorization the columns are reordered to the SAME slab order
(`slab_reorder_columns`, a rank-local gather), giving a square [Np, Np]
matrix (Np = W*m) whose k-th block row AND block column belong to rank k.
Padded rows and columns carry a unit diagonal.

Factorization: right-looking blocked LU with block-local partial pivoting,
one block step per rank.  At step j rank j broadcasts its block row (the
JAX package's psum-masked all-reduce); every rank past j factors the
[m, m] diagonal block itself (cheaper than a second broadcast), rank j keeps
L_jj^{-1} P_j of its row as the U block row, and ranks k > j form
L_kj = A_kj U_jj^{-1} and update their trailing columns.  The pivoting is
the JAX package's, so the factors match it at the same W.

Solve: block forward and backward substitution.  At step k rank k solves
its [m, m] triangular block and broadcasts the m-vector; every later
(earlier) rank folds it into its accumulator with an [m, m] GEMV.  On the
card a rank solves one right-hand side with the hand-written kernel of
`ops.lu_trsv`, reading its diagonal block where it lies in the row-major
slab (the plan `slab_lu_factor` returns); several right-hand sides,
and the CPU, take `torch.linalg.solve_triangular`, which first copies the
strided block.

The factorization is the scope "Slab LU factor" and each solve the span
"Slab LU apply" (attributes `world`, `m` and `steps`: W broadcasts of a
block row, 2W of a solution block); their broadcasts are counted by
`sharded.collective`, the triangles solved through the kernel by the
counter `slab triangles native` (two an apply on every rank on the card).

`torch.linalg.lu_factor` returns LAPACK's 1-based pivots (row i swapped
with row piv[i] - 1, in order); the JAX package's are 0-based and turned
into a permutation by `lu_pivots_to_permutation`.
`la.direct.pivots_to_permutation` does the same on the host, without
forming the m x m permutation matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..la.direct import pivots_to_permutation
from ..ops import lu_trsv
from ..utils import timers
from .sharded import RowMesh, collective, padded_rows


def _slab_geometry(n_nodes: int, dim: int, mesh: RowMesh):
    _, nloc = padded_rows(n_nodes, mesh)
    return mesh.world, nloc, dim * nloc


def slab_reorder_columns(A_loc: torch.Tensor, n_nodes: int, dim: int, mesh: RowMesh):
    """This rank's [m, d*n] slab (flat columns) -> [m, Np] (slab columns),
    with unit rows on its padded rows.  Rank-local: a column gather plus a
    row fix, no communication."""
    W, nloc, m = _slab_geometry(n_nodes, dim, mesh)
    n = n_nodes
    Np = W * m
    # slab column s -> flat column (d*n is the zero-fill slot)
    s = np.arange(Np)
    node = (s // m) * nloc + (s % m) % nloc
    comp = (s % m) // nloc
    colperm = np.where(node < n, comp * n + node, dim * n)
    real = torch.as_tensor(np.flatnonzero(node < n), device=A_loc.device)
    A2 = A_loc.new_zeros((m, Np))
    A2[:, real] = A_loc[:, torch.as_tensor(colperm[node < n], device=A_loc.device)]
    # padded rows -> e_row (the unit diagonal at this rank's slab index);
    # padded columns are zero, their unit diagonal lives in the owning
    # rank's padded row
    r = np.arange(m)
    pad = np.flatnonzero(mesh.rank * nloc + r % nloc >= n)
    if pad.size:
        pad_t = torch.as_tensor(pad, device=A_loc.device)
        A2[pad_t] = 0.0
        A2[pad_t, mesh.rank * m + pad_t] = 1.0
    return A2


def slab_lu_factor(A2_loc: torch.Tensor, mesh: RowMesh):
    """Blocked LU of the slab-ordered square matrix.  Returns this rank's
    (LU_loc [m, Np], perm_loc [m], plan): its rows [L_k0 .. L_k,k-1 | LU_kk |
    U_k,k+1 ..], its block-local row permutation (already applied to the
    stored rows) and the `ops.lu_trsv` plan of its diagonal block LU_kk, read
    in place (row-major, leading dimension Np; None on the CPU).  `A2_loc`
    is overwritten."""
    W, rank = mesh.world, mesh.rank
    m = A2_loc.shape[1] // W
    A = A2_loc.contiguous()
    perm = torch.arange(m, device=A.device)
    with timers.scope("Slab LU factor", world=W, m=m, steps=W):
        for j in range(W):
            c0, c1 = j * m, (j + 1) * m
            pivot = A if rank == j else torch.empty(A.shape, dtype=A.dtype, device=A.device)
            pivot = collective("broadcast", pivot, mesh, src=j)
            if rank < j:
                continue
            lu_D, piv_D = torch.linalg.lu_factor(pivot[:, c0:c1])
            perm_D = pivots_to_permutation(piv_D)
            if rank == j:
                # U block row: L_jj^{-1} P_j on the trailing columns; the left
                # columns hold L factors of earlier steps and only get P_j
                row = pivot[perm_D]
                row[:, c0:c1] = lu_D
                if c1 < A.shape[1]:
                    row[:, c1:] = torch.linalg.solve_triangular(
                        lu_D, row[:, c1:], upper=False, unitriangular=True
                    )
                A, perm = row, perm_D
            else:
                trailing = torch.linalg.solve_triangular(
                    lu_D, pivot[perm_D, c1:], upper=False, unitriangular=True
                )
                L_kj = torch.linalg.solve_triangular(lu_D, A[:, c0:c1], upper=True, left=False)
                A[:, c1:] -= L_kj @ trailing
                A[:, c0:c1] = L_kj
            del pivot
    return A, perm, lu_trsv.plan(A[:, rank * m : (rank + 1) * m])


def slab_lu_solve(
    LU_loc: torch.Tensor,
    perm_loc: torch.Tensor,
    b_loc: torch.Tensor,
    mesh: RowMesh,
    plan: lu_trsv.TrsvPlan | None,
):
    """Solve L U x = P b with the factors of `slab_lu_factor`; b and x are
    this rank's slab pieces [m] (or [m, k] for k right-hand sides at once),
    in the factors' dtype inside and b's outside.  `plan` (None: every
    triangle through `solve_triangular`) solves this rank's triangles of one
    right-hand side."""
    W, rank = mesh.world, mesh.rank
    m = LU_loc.shape[1] // W
    vec = b_loc.ndim == 1
    acc = b_loc.to(LU_loc.dtype)[perm_loc]
    if vec:
        acc = acc[:, None]
    native = plan is not None and acc.shape[1] == 1

    def block(k):
        return LU_loc[:, k * m : (k + 1) * m]

    def sweep(order, upper):
        nonlocal acc
        out = None
        for k in order:
            # contiguous on both sides: a solve with several right-hand
            # sides comes back column-major, and a broadcast sends and
            # receives the storage as it lies
            if rank == k:
                if native:
                    xk = plan.solve_triangle(upper, acc)
                    timers.count("slab triangles native")
                else:
                    xk = torch.linalg.solve_triangular(
                        block(k), acc, upper=upper, unitriangular=not upper
                    ).contiguous()
                out = xk
            else:
                xk = torch.empty(acc.shape, dtype=acc.dtype, device=acc.device)
            xk = collective("broadcast", xk, mesh, src=k)
            if (rank < k) if upper else (rank > k):
                acc = acc - block(k) @ xk
        return out

    with timers.span("Slab LU apply", world=W, m=m, steps=2 * W):
        acc = sweep(range(W), upper=False)  # y: forward, unit lower
        x = sweep(range(W - 1, -1, -1), upper=True)
    x = x.to(b_loc.dtype)
    return x[:, 0] if vec else x
