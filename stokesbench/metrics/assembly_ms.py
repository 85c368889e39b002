"""Milliseconds a frame spends in the assembly of its system
(`StokesBEMProblem._pipeline`: the bulk, the singular and near deltas, the
corrections, the monolithic system), synchronised span."""

from ._spans import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "assembly")
