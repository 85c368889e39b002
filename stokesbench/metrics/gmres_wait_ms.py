"""Milliseconds of host time a GMRES iteration spends blocked on the card
(`la/gmres.py`, either solve): the window's "Host sync" spans inside its
"GMRES" spans, over their iterations (program spans)."""

from ._program import gmres_split


def read(rec):
    split = gmres_split(rec)
    if split is None:
        return None
    _, wait_s, _, iterations = split
    return 1e3 * wait_s / iterations
