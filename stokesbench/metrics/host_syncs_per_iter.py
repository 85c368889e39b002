"""Points a GMRES iteration blocks the host on the card (`la/gmres.py`,
either solve): the program's counter "host syncs" inside the window's
"GMRES" spans, over their iterations."""

from ._program import gmres_split


def read(rec):
    split = gmres_split(rec)
    if split is None:
        return None
    _, _, syncs, iterations = split
    return syncs / iterations
