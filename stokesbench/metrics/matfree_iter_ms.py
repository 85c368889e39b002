"""Milliseconds a matrix-free GMRES iteration (`MatfreeSolver._gmres`: K5,
the deltas, block-Jacobi, Gram-Schmidt): the window's spans over its
iterations."""

from ._spans import ms_per_iteration


def read(rec):
    return ms_per_iteration(rec, "matfree_gmres")
