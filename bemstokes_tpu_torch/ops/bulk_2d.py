"""The 2D bulk: the smooth-rule operators V and K of a closed line-cell
boundary in the plane, and their actions, in plain torch on every device.

The JAX package keeps 2D on its XLA path on every platform: its Pallas
kernels are written for 3-vectors (`bemstokes_tpu/ops/assemble.py:365-386`
`_resolve_backend` needs `cfg.dim == 3`; `ops/pallas_node.py`,
`ops/pallas_assemble.py` and the fused matvec, `ops/matfree_node.py:88`, are
dim 3 only).  The port does the same: `ops.assemble.assemble_rows` and
`matfree.MatfreeSolver` route a 2D problem here by `cfg.dim`, and the CUDA
sweeps (`node_sweep`, `tile_slots`, `tile_nodes`, `sweep_matvec`) stay 3D and
refuse a 2D input.

The free-space Green's functions of the plane (viscosity 1; the JAX
package's `kernels/stokeslet.py:stokeslet_G_Wn` with dim = 2):

    G_ab(p)   = (p_a p_b / r^2 - delta_ab log r) / (4 pi)
    (W.n)_ab  = -p_a p_b (p . n) / (pi r^4)

Both are symmetric in (a, b), so a (row, sample) pair needs three entries of
each, xx, xy and yy; K carries the exterior sign, K = -sum W.n w.  A pair at
exactly r = 0 (a row node on a quadrature point of one of its own panels)
takes the dummy offset p = (1, 1), as the 3D sweeps do: the singular delta
subtracts the same value (node mode) or the pair is masked (panel modes).

Sizes: a [rows, columns, samples] intermediate holds at most `TILE_ELEMS`
entries (64 MiB in f64) where one row's columns fit (the panel modes take
every panel at once); the 10-cell circle refined 10 times (10,240 nodes, 8
samples a column node) is swept in ~100 row tiles.
"""

from __future__ import annotations

import math

import torch

#: entries of one [rows, columns, samples] intermediate; sets the row tiles
#: and column chunks of every sweep here
TILE_ELEMS = 2**23


def _tiles(nr: int, n: int, m: int):
    """(row tile, column chunk) of a sweep of nr rows against n columns of m
    samples: whole columns while they fit in TILE_ELEMS, rows to fill it."""
    cj = max(1, min(n, TILE_ELEMS // max(m, 1)))
    return max(1, min(nr, TILE_ELEMS // (cj * m))), cj


def pair_sums(xi, Y, N, Wl, v: bool = True, k: bool = True):
    """The distinct weighted sums of rows xi [t, 2] against samples Y, N
    [J, M, 2] with weights Wl [J, M, L]: [3 (v) + 3 (k), t, J, L], in order
    V_xx, V_xy, V_yy (with `v`), K_xx, K_xy, K_yy (with `k`); entry (i, j, l)
    is the sum over m of the Green's function at Y[j, m] - xi[i] times
    Wl[j, m, l]."""
    px = Y[None, :, :, 0] - xi[:, None, None, 0]  # [t, J, M]
    py = Y[None, :, :, 1] - xi[:, None, None, 1]
    zero = px * px + py * py == 0
    px = torch.where(zero, 1.0, px)
    py = torch.where(zero, 1.0, py)
    r2 = px * px + py * py
    inv = torch.reciprocal(r2)
    pxx, pxy, pyy = px * px, px * py, py * py
    q = []
    if v:
        q += [pxx * inv, pxy * inv, pyy * inv, torch.log(r2)]
    if k:
        kn = (px * N[None, :, :, 0] + py * N[None, :, :, 1]) * (inv * inv)
        q += [pxx * kn, pxy * kn, pyy * kn]
    s = torch.einsum("ktjm,jml->ktjl", torch.stack(q), Wl)
    out = []
    if v:
        c = 1.0 / (4.0 * math.pi)
        log_part = s[3] * (0.5 * c)  # the sum of log r, over 4 pi
        out += [s[0] * c - log_part, s[1] * c, s[2] * c - log_part]
    if k:
        out += [s[-3] / math.pi, s[-2] / math.pi, s[-1] / math.pi]
    return torch.stack(out)


def _store(V, K, parts, rows, cols):
    """Write the six sums [6, t, J] into V, K [2, nr, 2, n] at (rows,
    cols)."""
    for M, (xx, xy, yy) in ((V, parts[:3]), (K, parts[3:])):
        M[0, rows, 0, cols] = xx
        M[0, rows, 1, cols] = xy
        M[1, rows, 0, cols] = xy
        M[1, rows, 1, cols] = yy


def node_bulk(xi, Yj, Nj, Wj):
    """Node mode: dense (V, K) [2 nr, 2 n] of rows xi [nr, 2] against the
    column-node sample tables Yj, Nj [n, m, 2], Wj [n, m]
    (`ops.assemble.node_column_samples`), own-cell pairs included with the
    smooth rule; the 2D counterpart of `node_sweep`."""
    nr, (n, m) = xi.shape[0], Wj.shape
    V = torch.empty((2, nr, 2, n), dtype=xi.dtype, device=xi.device)
    K = torch.empty_like(V)
    t, cj = _tiles(nr, n, m)
    for i0 in range(0, nr, t):
        for j0 in range(0, n, cj):
            cols = slice(j0, j0 + cj)
            parts = pair_sums(xi[i0 : i0 + t], Yj[cols], Nj[cols], Wj[cols, :, None])
            _store(V, K, parts[..., 0], slice(i0, i0 + t), cols)
    return V.reshape(2 * nr, 2 * n), K.reshape(2 * nr, 2 * n)


def panel_bulk(xi, node_ids, xq, nrm, wphi, cells_fe, inc_slot, inc_mask, scatter: bool):
    """The "gather" and "scatter" modes: dense (V, K) [2 nr, 2 n] of rows xi
    [nr, 2] (global node ids `node_ids`) against the panels' smooth-rule
    points xq, unit normals nrm [Nc, nq, 2] and weighted shape values wphi
    [Nc, nq, nl], own-cell pairs masked.  Each (row, panel, local node) slot
    goes to its node column cells_fe[c, l] by the incidence gather-reduce
    (inc_slot, inc_mask [n, vmax]) or, with `scatter`, by an index-add."""
    nr = xi.shape[0]
    n = inc_slot.shape[0]
    Nc, nq, nl = wphi.shape
    V = torch.empty((2, nr, 2, n), dtype=xi.dtype, device=xi.device)
    K = torch.empty_like(V)
    t = max(1, min(nr, TILE_ELEMS // (Nc * nq)))  # every panel at once
    cols = cells_fe.reshape(-1)
    for i0 in range(0, nr, t):
        xi_t, ids_t = xi[i0 : i0 + t], node_ids[i0 : i0 + t]
        keep = ~torch.any(cells_fe[None] == ids_t[:, None, None], dim=-1)  # [t, Nc]
        slots = pair_sums(xi_t, xq, nrm, wphi) * keep[None, :, :, None].to(xi.dtype)
        slots = slots.reshape(6, slots.shape[1], Nc * nl)
        if scatter:
            parts = torch.zeros((6, slots.shape[1], n), dtype=xi.dtype, device=xi.device)
            parts.index_add_(2, cols, slots)
        else:
            parts = None
            for v in range(inc_slot.shape[1]):
                part = slots.index_select(2, inc_slot[:, v]) * inc_mask[:, v]
                parts = part if parts is None else parts.add_(part)
        _store(V, K, parts, slice(i0, i0 + t), slice(None))
    return V.reshape(2 * nr, 2 * n), K.reshape(2 * nr, 2 * n)


def sweep_matvec(xi, Yj, Nj, Wj, XV, XK):
    """(V @ XV, K @ XK) of the node-mode smooth bulk, rows xi [nr, 2],
    without forming V or K: each row tile's blocks are made and applied, then
    dropped (the JAX package's `_sweep_matvec_xla` with d = 2).  XV [2 n, BV]
    and XK [2 n, BK] are component-blocked columns (either may have width
    0); returns ([2 nr, BV], [2 nr, BK])."""
    nr, (n, m) = xi.shape[0], Wj.shape
    BV, BK = XV.shape[1], XK.shape[1]
    VX = torch.zeros((2, nr, BV), dtype=xi.dtype, device=xi.device)
    KX = torch.zeros((2, nr, BK), dtype=xi.dtype, device=xi.device)
    sides = [(out, X.reshape(2, n, B)) for out, X, B in ((VX, XV, BV), (KX, XK, BK)) if B]
    t, cj = _tiles(nr, n, m)
    for i0 in range(0, nr if sides else 0, t):
        rows = slice(i0, i0 + t)
        for j0 in range(0, n, cj):
            cols = slice(j0, j0 + cj)
            parts = pair_sums(xi[rows], Yj[cols], Nj[cols], Wj[cols, :, None], v=BV > 0, k=BK > 0)
            for s, (out, X) in enumerate(sides):
                xx, xy, yy = parts[3 * s : 3 * s + 3, ..., 0]
                out[0, rows] += xx @ X[0, cols] + xy @ X[1, cols]
                out[1, rows] += xy @ X[0, cols] + yy @ X[1, cols]
    return VX.reshape(2 * nr, BV), KX.reshape(2 * nr, BK)
