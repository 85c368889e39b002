"""Reduction of the traced run's profiler trace: the device's busy time in
the window, the device operations that took most of it, the idle gaps by
what the host was doing, and the device time of each call that a metric
reads (the operations the call launched)."""

from __future__ import annotations

import bisect
import math
from collections import defaultdict

from .spans import PREFIX

WINDOW = PREFIX + "window"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def raw_events(prof):
    """(name, on the device, start us, end us, is an annotation,
    correlation id, linked correlation id) of every event of a stopped
    `torch.profiler.profile`, read from the profiler's raw results: building
    its FunctionEvents takes minutes for a window of a few hundred thousand
    launches."""
    from torch.autograd import DeviceType

    for e in prof.profiler.kineto_results.events():
        yield (e.name(), e.device_type() == DeviceType.CUDA, e.start_ns() / 1e3, e.end_ns() / 1e3,
               e.is_user_annotation(), e.correlation_id(), e.linked_correlation_id())


def _label(name):
    """A span's name without the prefix and without a call's `#<n>`."""
    return name[len(PREFIX):].split("#", 1)[0]


def launched_in_calls(device, anchors, calls, reach_us=500e3, bucket_us=10e3):
    """{call label: device seconds} of the annotated calls `calls` ({label:
    (start, end)}, host us, not nested in one another, each between two
    synchronisations of the card): the union of the device operations
    that started while the call ran.

    The device's timestamps are the card's clock brought to the host's,
    and the two drift apart by up to ~0.1 ms over a window, which is more
    than the few microseconds between a call's host start and its first
    launch.  So each call's device operations are found on the device's
    clock, with the offset of the two clocks measured near the call:
    `anchors`, (host us of a launch, device start - host launch us) of the
    operations whose launch the trace holds by correlation id, give it as
    their least difference within `reach_us` of the call (a launch's own
    latency is a few microseconds; the card is idle at a call's start).
    The program's own kernels are launched by a runtime the trace does not
    correlate, so they are found by time alone."""
    if not calls or not anchors:
        return {}
    least = {}
    for t, off in anchors:
        b = int(t // bucket_us)
        if off < least.get(b, math.inf):
            least[b] = off
    device = sorted(device)
    starts = [s for s, *_ in device]
    out = {}
    for label, (s, e) in calls.items():
        lo, hi = int((s - reach_us) // bucket_us), int((e + reach_us) // bucket_us)
        offs = [least[b] for b in range(lo, hi + 1) if b in least]
        if not offs:
            continue
        shift = min(offs)
        i, j = bisect.bisect_left(starts, s + shift), bisect.bisect_right(starts, e + shift)
        if j > i:
            out[label] = sum(b - a for a, b in _union([(d[0], d[1]) for d in device[i:j]])) / 1e6
    return out


def reduce(events, top=10):
    """`events`: tuples as `raw_events` gives them.  Returns a dict with
    busy_s, window_s, device_ops and idle_gaps (each at most `top` [name,
    seconds]), and span_device_s: the device seconds of each call that a
    span annotated as `<name>#<call>` (`spans.Spans.wrap`), by its
    `<name>#<call>`."""
    device, notes, runtime, calls = [], defaultdict(list), {}, {}
    for name, on_device, start, end, annotation, corr, linked in events:
        if on_device:
            if annotation or name.startswith(PREFIX):
                continue
            device.append((start, end, name, corr))
        elif linked:
            runtime[corr] = start
        elif name.startswith(PREFIX):
            if "#" in name:
                calls[name[len(PREFIX):]] = (start, end)
            else:
                notes[name].append((start, end))
    if not notes.get(WINDOW):
        return None
    w0, w1 = notes[WINDOW][0]
    inside = [(max(s, w0), min(e, w1), n) for s, e, n, _ in device if e > w0 and s < w1]
    busy = _union([(s, e) for s, e, _ in inside])
    busy_us = sum(e - s for s, e in busy)
    by_name = defaultdict(float)
    for s, e, n in inside:
        by_name[n] += e - s
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    for label, iv in calls.items():
        notes[PREFIX + label].append(iv)

    # the host's spans, innermost first where they nest: the shortest span
    # that covers a gap's middle names it
    host = sorted((s, e, _label(n)) for n, iv in notes.items() if n != WINDOW for s, e in iv)
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    active, j = [], 0
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        while j < len(host) and host[j][0] <= mid:
            active.append(host[j])
            j += 1
        active = [h for h in active if h[1] >= mid]
        label = min(active, key=lambda h: h[1] - h[0])[2] if active else "frame loop, outside the spans"
        gaps[label] += e - s
    idle_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]

    return dict(
        window_s=(w1 - w0) / 1e6,
        busy_s=busy_us / 1e6,
        device_ops=[[n[:160], us / 1e6] for n, us in device_ops],
        idle_gaps=[[n, us / 1e6] for n, us in idle_gaps],
        span_device_s=launched_in_calls(
            [(s, e) for s, e, _, _ in device],
            [(runtime[c], s - runtime[c]) for s, _, _, c in device if c in runtime],
            calls,
        ),
    )
