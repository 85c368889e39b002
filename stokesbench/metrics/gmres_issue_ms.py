"""Milliseconds of host time a GMRES iteration spends issuing its work
(`la/gmres.py`, either solve): the window's "GMRES" spans less the "Host
sync" spans inside them, over their iterations (program spans)."""

from ._program import gmres_split


def read(rec):
    split = gmres_split(rec)
    if split is None:
        return None
    solve_s, wait_s, _, iterations = split
    return 1e3 * (solve_s - wait_s) / iterations
