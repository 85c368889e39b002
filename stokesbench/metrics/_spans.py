"""Shared arithmetic of the span readers."""


def ms_per_frame(rec, name):
    """Milliseconds a window frame spent in the spans called `name`, or None
    where the run has no such span."""
    if rec.spans is None or not rec.frame_seconds:
        return None
    spans = rec.spans.of(name)
    if not spans:
        return None
    return 1e3 * sum(s.seconds for s in spans) / len(rec.frame_seconds)


def ms_per_iteration(rec, name):
    if rec.spans is None:
        return None
    spans = rec.spans.of(name)
    its = sum(s.info["iterations"] for s in spans)
    return 1e3 * sum(s.seconds for s in spans) / its if its else None


def roofline(rec, name, bound):
    """100 x the calls' least time over the device time of the operations
    they launched, as the trace gives it (`trace.reduce`'s
    `span_device_s`), over the calls `bound(info)` has a count for and
    the trace has operations of."""
    if rec.spans is None or rec.trace is None:
        return None
    device_s = rec.trace["span_device_s"]
    least = used = 0.0
    for s in rec.spans.of(name):
        b = bound(s.info)
        t = device_s.get(f"{name}#{s.info['call']}")
        if b is not None and t:
            least += b
            used += 1e3 * t
    return 100.0 * least / used if used > 0 else None
