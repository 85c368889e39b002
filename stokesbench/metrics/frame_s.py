"""Seconds a frame: the window's wall time over the frames completed in it
(fresh, stale and refactoring frames alike, with their output files)."""


def read(rec):
    return rec.window_s / len(rec.frame_seconds) if rec.frame_seconds else None
