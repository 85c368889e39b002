"""Milliseconds a frame spends on its geometry on the host
(`SwimmerSimulation.euler_for_frame`, with the frame mesh's read, and
`shape_velocities`), synchronised span."""

from ._spans import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "geometry")
