"""Milliseconds a frame spends on the near-pair quadrature upgrade
(`ops/assemble.py:_add_near_corrections`, or the matrix-free set-up's
`_near_coo`): the window's outermost "Near delta" spans over its frames
(program spans).  Where the quadrature is not promoted there is none."""

from ._program import window


def read(rec):
    spans = window(rec)
    near = [s for s in spans if s.name == "Near delta" and not s.within("Near delta")] if spans else []
    return 1e3 * sum(s.seconds for s in near) / len(rec.frame_seconds) if near else None
