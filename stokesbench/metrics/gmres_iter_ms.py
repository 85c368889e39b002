"""Milliseconds a GMRES iteration on the stale LU
(`StokesBEMProblem._gmres_direct`): the window's spans over its
iterations."""

from ._spans import ms_per_iteration


def read(rec):
    return ms_per_iteration(rec, "gmres")
