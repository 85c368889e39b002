"""Milliseconds of rank 0's host time a GMRES iteration of the distributed
step takes (`la/gmres.py` over the slab operators of `parallel/solve.py`):
the window's "GMRES" spans that hold a "Sharded matvec" span, over their
iterations (program spans).  The slab LU apply's chain of broadcasts paces
it."""

from ._dist import dist_gmres


def read(rec):
    found = dist_gmres(rec)
    if found is None:
        return None
    solves, _, iterations = found
    return 1e3 * sum(s.seconds for s in solves) / iterations
