"""Shared arithmetic of the readers of the distributed frame step
(`bemstokes_tpu_torch/parallel/`): rank 0's program spans and counters in
the traced window.  A solve of the distributed step is a "GMRES" span that
holds a "Sharded matvec" span.  Where the window holds none (a cell on one
card, or a program without these spans) the readers find nothing and return
None."""

from ._program import window


def dist_gmres(rec):
    """(the window's "GMRES" spans of the distributed step, the spans inside
    them, their iterations), or None where the window holds no iteration of
    such a solve."""
    spans = window(rec)
    if spans is None:
        return None
    solves = {}
    for s in spans:
        if s.name == "Sharded matvec":
            p = s.parent
            while p is not None and p.name != "GMRES":
                p = p.parent
            if p is not None:
                solves[id(p)] = p
    iterations = sum(s.attrs.get("iterations", 0) for s in solves.values())
    if not iterations:
        return None

    def inside(s):
        p = s.parent
        while p is not None:
            if id(p) in solves:
                return True
            p = p.parent
        return False

    return list(solves.values()), [s for s in spans if inside(s)], iterations
