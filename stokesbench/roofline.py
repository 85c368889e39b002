"""The roofline arithmetic: the least time the card could take for a call's
work, from the call's shapes alone.  Frozen copies of `chip_smoke.py`
(`FLOPS_PER_INTERACTION` :366, `FLOPS_PER_INTERACTION_MATVEC` :341,
`PEAK_FLOPS` and `PEAK_BYTES` :369-370, `bound` :656, `matvec_bound` :1557),
recounted in the port's PRs 6 and 5, so that a later change to the port
cannot move the yardstick.  The same work counts the same whatever kernel
does it."""

from __future__ import annotations

#: floating-point operations per (row, sample) interaction of the node sweep,
#: the fewest-operation form of each Green's function known, a multiply-add
#: as two and an rsqrt as one (free space 50, free surface 86, no slip 141)
FLOPS_PER_INTERACTION = {"free_space": 50, "free_surface": 86, "no_slip": 141}
#: the same for the sweep-matvec, per narrow launch shape (BV, BK)
FLOPS_PER_INTERACTION_MATVEC = {
    "free_space": {(1, 1): 45, (1, 0): 25, (0, 1): 30},
    "free_surface": {(1, 1): 77, (1, 0): 43, (0, 1): 53},
    "no_slip": {(1, 1): 128, (1, 0): 58, (0, 1): 91},
}
#: peak rates of one H100 SXM at its full 700 W (NVIDIA's data sheet):
#: FP64 and FP32 outside the tensor cores, and the memory rate
PEAK_FLOPS = {"float64": 33.5e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
ITEM = {"float64": 8, "float32": 4}


def bound(kernel, dtype, nr, n, m):
    """(ms, "operations" | "bytes"): the least time of one node sweep of nr
    rows against n column nodes of m samples each: every input read once,
    V and K written once, against its operations."""
    nbytes = ITEM[dtype] * (3 * nr + 7 * n * m + 2 * 9 * nr * n)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = FLOPS_PER_INTERACTION[kernel] * nr * n * m / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def matvec_bound(kernel, dtype, nr, n, m, shape):
    """(ms, by) of one sweep-matvec of a narrow launch shape (BV, BK), or
    None for a shape without a count (the wide setup sweep)."""
    flops = FLOPS_PER_INTERACTION_MATVEC[kernel].get(tuple(shape))
    if flops is None:
        return None
    BV, BK = shape
    nbytes = ITEM[dtype] * (3 * nr + (4 + 3 * BK) * n * m + (BV + BK) * 3 * (n + nr))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops * nr * n * m / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"
