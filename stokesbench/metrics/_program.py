"""Shared arithmetic of the readers of the program's own spans and counters:
the spans that the program's registry (`bemstokes_tpu_torch.utils.timers`)
recorded while the traced window's profiler ran.  Where the registry keeps
no spans (an untimed run, or a program without them) the readers find
nothing and return None."""


def window(rec):
    """The registry's spans of the run's window: those recorded from the
    first of its last len(rec.frame_seconds) "Frame" spans on, or None."""
    if not rec.frame_seconds:
        return None
    from bemstokes_tpu_torch.utils import timers

    spans = getattr(timers, "spans", None)
    if not spans:
        return None
    frames = [i for i, s in enumerate(spans) if s.name == "Frame"]
    if len(frames) < len(rec.frame_seconds):
        return None
    return spans[frames[-len(rec.frame_seconds)]:]


def gmres_split(rec):
    """(host seconds in the window's "GMRES" spans, host seconds of the
    "Host sync" spans inside them, the "host syncs" counted inside them,
    their iterations), or None where the window holds no GMRES iteration."""
    spans = window(rec)
    if spans is None:
        return None
    solves = [s for s in spans if s.name == "GMRES"]
    iterations = sum(s.attrs.get("iterations", 0) for s in solves)
    if not iterations:
        return None
    inside = [s for s in spans if s.within("GMRES")]
    waits = [s for s in inside if s.name == "Host sync" and not s.within("Host sync")]
    syncs = sum(s.counts.get("host syncs", 0) for s in solves + inside)
    return sum(s.seconds for s in solves), sum(s.seconds for s in waits), syncs, iterations

