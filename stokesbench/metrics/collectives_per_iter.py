"""Collectives a GMRES iteration of the distributed step issues on rank 0:
the program's counter "collectives" (`parallel/sharded.py:collective`)
inside the window's "GMRES" spans that hold a "Sharded matvec" span, over
their iterations.  It is the length of the iteration's chain of
collectives: 2W broadcasts in the slab LU apply, an all-gather after it,
one in the matvec and one broadcast of the Hessenberg column, with each
solve's own few spread over its iterations."""

from ._dist import dist_gmres


def read(rec):
    found = dist_gmres(rec)
    if found is None:
        return None
    solves, inside, iterations = found
    return sum(s.counts.get("collectives", 0) for s in solves + inside) / iterations
