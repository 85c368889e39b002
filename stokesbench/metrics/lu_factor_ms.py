"""Milliseconds of one LU factorisation (`LUPreconditioner.maybe_refactor`
in the calls that refactored), synchronised span."""


def read(rec):
    if rec.spans is None:
        return None
    done = [s.seconds for s in rec.spans.of("lu_factor") if s.info["refactored"]]
    return 1e3 * sum(done) / len(done) if done else None
