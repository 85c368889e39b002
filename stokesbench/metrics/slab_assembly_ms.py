"""Milliseconds a frame spends building its slab system on rank 0 (the
distributed step's V, K and A slabs with their corrections, the tail and the
right-hand side, `parallel/solve.py`): the window's outermost "Slab
assembly" spans over its frames (program spans)."""

from ._program import window


def read(rec):
    spans = window(rec)
    slabs = [s for s in spans if s.name == "Slab assembly" and not s.within("Slab assembly")] if spans else []
    return 1e3 * sum(s.seconds for s in slabs) / len(rec.frame_seconds) if slabs else None
