"""Milliseconds a frame spends writing its VTU file
(`SwimmerSimulation._write_frame_vtu`): the window's "VTU" spans over its
frames (program spans)."""

from ._program import window


def read(rec):
    spans = window(rec)
    vtu = [s for s in spans if s.name == "VTU"] if spans else []
    return 1e3 * sum(s.seconds for s in vtu) / len(rec.frame_seconds) if vtu else None
