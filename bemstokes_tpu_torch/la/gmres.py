"""Restarted GMRES with Givens rotations and right preconditioning (port of
`bemstokes_tpu/la/gmres.py`; the reference delegates to deal.II SolverGMRES,
`source/bem_stokes.cc:4270-4340`).

The JAX version runs both loops as `lax.while_loop`s over fixed-size masked
buffers; here they are Python loops that stop at convergence, with the same
arithmetic: modified Gram-Schmidt against the basis built so far, the
accumulated Givens rotations, the stopping rule |g[j+1]| < tol * ||b||, and
each restart begun from the TRUE residual b - A x.  Each Arnoldi step reads
its Hessenberg column back to the host for the rotations and the
convergence test, and copies the rotated column back.

The solve is the span "GMRES" (attributes `iterations`, `restarts`; counter
`gmres iterations`), each Arnoldi step its children "Preconditioner",
"Matvec" and "Orthogonalisation", and every read back or copy from the
host a `timers.host_sync` (`utils/timers.py`).

matvec and precond are arbitrary callables on flat tensors.  `agree`, when
given, maps every tensor whose value decides a branch before it is read to
the host: the distributed frame step (`parallel/solve.py`) passes one that
broadcasts it from rank 0, so that every rank takes the same branches and
runs the same collectives inside matvec and precond.
"""

from __future__ import annotations

import torch

from ..utils import timers


def _identity(x):
    return x


def gmres(
    matvec,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    precond=None,
    restart: int = 100,
    tol: float = 1e-10,
    max_restarts: int = 10,
    agree=None,
):
    """Solve A x = b. Returns (x, info) with info = dict(residual, iterations)
    (the residual a 0-d tensor, the iteration count an int).

    Right-preconditioned: solves A M^-1 y = b, x = M^-1 y, so the residual
    is the true residual."""
    if precond is None:
        precond = _identity
    if agree is None:
        agree = _identity
    with timers.scope("GMRES") as span:
        x, res, total_it, c = _gmres(matvec, b, x0, precond, restart, tol, max_restarts, agree)
        span.set(iterations=total_it, restarts=c)
    return x, {"residual": res, "iterations": total_it}


def restart_params(solver) -> tuple[int, int]:
    """(restart, max_restarts) for a `SolverConfig`: cycles of
    `gmres_restart` Arnoldi steps, as many as `max_steps` allows (at least
    one)."""
    restart = solver.gmres_restart
    return restart, max(1, -(-solver.max_steps // max(restart, 1)))


def solve_converged(residual: float, b_norm: float, tol: float) -> bool:
    """The frame loop's convergence test of a finished solve: the residual
    within `tol` of |b| (of 1 for a zero rhs), with a margin of 1e-4 for its
    rounding."""
    return residual <= tol * (b_norm if b_norm > 0 else 1.0) * 1.0001


def _gmres(matvec, b, x0, precond, m, tol, max_restarts, agree):
    n = b.shape[0]
    dt, dev = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    with timers.host_sync():
        b_norm = float(agree(torch.linalg.vector_norm(b)))
    atol = tol * (1.0 if b_norm == 0 else b_norm)

    def arnoldi_cycle(x, r):
        beta = torch.linalg.vector_norm(r)
        with timers.host_sync():
            beta_f = float(agree(beta))
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        H = torch.zeros((m + 1, m), dtype=dt, device=dev)
        cs, sn = [], []  # Givens rotations, applied on the host in f64
        g = [beta_f] + [0.0] * m
        V[0] = r / (1.0 if beta_f == 0 else beta)
        k = 0
        done = beta_f < atol
        while k < m and not done:
            j = k
            timers.count("gmres iterations")
            with timers.span("Preconditioner"):
                z = precond(V[j])
            with timers.span("Matvec"):
                w = matvec(z)
            with timers.span("Orthogonalisation"):
                # modified Gram-Schmidt against the basis built so far
                hcol = torch.zeros((m + 1,), dtype=dt, device=dev)
                for i in range(j + 1):
                    h = torch.dot(V[i], w)
                    w = w - h * V[i]
                    hcol[i] = h
                hj1 = torch.linalg.vector_norm(w)
                hcol[j + 1] = hj1
                V[j + 1] = w / torch.where(hj1 == 0, torch.ones_like(hj1), hj1)
                # the rotations act on a host copy of the new column (j + 2
                # scalars, in float64)
                with timers.host_sync():
                    hc = agree(hcol[: j + 2]).tolist()
                for i in range(j):
                    hi = hc[i] * cs[i] + hc[i + 1] * sn[i]
                    hi1 = -hc[i] * sn[i] + hc[i + 1] * cs[i]
                    hc[i], hc[i + 1] = hi, hi1
                denom = (hc[j] ** 2 + hc[j + 1] ** 2) ** 0.5
                c_new = 1.0 if denom == 0 else hc[j] / denom
                s_new = 0.0 if denom == 0 else hc[j + 1] / denom
                hc[j], hc[j + 1] = denom, 0.0
                cs.append(c_new)
                sn.append(s_new)
                g[j + 1] = -s_new * g[j]
                g[j] = c_new * g[j]
                with timers.host_sync():
                    H[: j + 2, j] = torch.tensor(hc, dtype=dt, device=dev)
            k = j + 1
            done = abs(g[j + 1]) < atol
        # back-substitution on the k x k upper-triangular system
        if k > 0:
            with timers.host_sync():
                gk = torch.tensor(g[:k], dtype=dt, device=dev)
            y = torch.linalg.solve_triangular(H[:k, :k], gk[:, None], upper=True)[:, 0]
            x = x + precond(y @ V[:k])
        return x, k

    r = b - matvec(x)
    res = torch.linalg.vector_norm(r)
    total_it = 0
    c = 0
    while c < max_restarts:
        with timers.host_sync():
            go_on = float(agree(res)) > atol
        if not go_on:
            break
        x, k = arnoldi_cycle(x, r)
        # restart on the TRUE residual (the in-cycle Givens estimate drifts
        # from it under finite precision)
        r = b - matvec(x)
        res = torch.linalg.vector_norm(r)
        total_it += k
        c += 1
    return x, res, total_it, c
