"""Milliseconds a frame spends writing its output files
(`SwimmerSimulation._save_frame`: the result and state files, the text
series, the VTU), host span."""

from ._spans import ms_per_frame


def read(rec):
    return ms_per_frame(rec, "files")
