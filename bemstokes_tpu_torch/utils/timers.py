"""The port's tracer: host-clock timers, spans and counters in one registry.
The timers are the analog of the reference's Teuchos::TimeMonitor timers
(Run, Assemble, LAC Solve, BEM Reinitialisation, DirectPreconditioner
Refactorisation; `source/bem_stokes.cc:19-23`, RAII scopes at `:2844, 4161,
5639, 5770`, summarized at `:5882`).

- `timers.scope(name, **attrs)` times a coarse stage (once a frame or a
  solve) on the host clock, always; `summary()` prints the totals by name.
- `timers.span(name, **attrs)` marks fine work (once an iteration or a
  kernel launch).  It does nothing unless tracing is on.
- `timers.count(name, k)` adds to a counter; `timers.host_sync()` brackets a
  point where the host blocks on the card (a read back, a copy from pageable
  host memory) and counts it as "host syncs"; inside a "GMRES" span it is
  also the span "Host sync", the wait of the solve's iteration.

Tracing is on exactly while a `torch.profiler` records (torch's own flag).
While it is on, every scope and span is kept in `timers.spans` as a `Span`:
its parent (the innermost open one), its frame (the `frame` attribute of the
"Frame" span it lies in), its start and end in nanoseconds since the epoch
(the clock the profiler stamps its host events with), its attributes and the
counters incremented while it was innermost.  It also opens a
`torch.profiler.record_function` of its name, so the trace holds it beside
the device work it issued.

No scope synchronises the card: a scope's time is the host's, and holds the
card's work only where the host waits for it (a `host_sync`).  The device's
time is the profiler trace's.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.autograd import profiler as _profiler

HOST_SYNC = "Host sync"
HOST_SYNCS = "host syncs"
#: the span whose host syncs are spans of their own; elsewhere (the assembly
#: blocks ~170 times a frame) a span a call would cost more than it shows
SYNCS_SPANNED_IN = "GMRES"

_NULL = contextlib.nullcontext()


class Span:
    """One recorded scope or span."""

    __slots__ = ("name", "parent", "frame", "start_ns", "end_ns", "attrs", "counts")

    def __init__(self, name, parent, frame, start_ns, end_ns=None, attrs=None, counts=None):
        self.name = name
        self.parent = parent
        self.frame = frame
        self.start_ns = start_ns
        self.end_ns = end_ns
        self.attrs = {} if attrs is None else attrs
        self.counts = {} if counts is None else counts

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def within(self, name) -> bool:
        """Whether a span called `name` encloses this one."""
        p = self.parent
        while p is not None:
            if p.name == name:
                return True
            p = p.parent
        return False


class _Timer:
    __slots__ = ("total", "calls")

    def __init__(self):
        self.total = 0.0
        self.calls = 0


class _Scope:
    """The context of one scope (`timed`: its host time is totalled under its
    name whether or not tracing is on) or of one span while tracing is on."""

    __slots__ = ("reg", "name", "attrs", "timed", "counter", "record", "annotation", "t0")

    def __init__(self, reg, name, attrs, timed, counter=None):
        self.reg = reg
        self.name = name
        self.attrs = attrs
        self.timed = timed
        self.counter = counter
        self.record = None

    def __enter__(self):
        reg = self.reg
        if _profiler._is_profiler_enabled:
            self.annotation = torch.profiler.record_function(self.name)
            # the profiler stamps the annotation's start midway through
            # `__enter__` and its end early in `__exit__`: the record takes
            # the middle of the one call and the clock right after the other
            before = time.time_ns()
            self.annotation.__enter__()
            start = (before + time.time_ns()) // 2
            parent = reg._open[-1] if reg._open else None
            frame = self.attrs.get("frame", parent.frame if parent is not None else None)
            self.record = Span(self.name, parent, frame, start, attrs=self.attrs)
            reg.spans.append(self.record)
            reg._open.append(self.record)
        else:
            self.t0 = time.perf_counter()
        if self.counter is not None:
            reg.count(self.counter)
        return self

    def set(self, **attrs):
        """Attributes known only at the end (a solve's iterations); kept
        while tracing is on."""
        if self.record is not None:
            self.record.attrs.update(attrs)

    def __exit__(self, *exc):
        rec = self.record
        if rec is not None:
            self.reg._open.pop()
            self.annotation.__exit__(*exc)
            rec.end_ns = time.time_ns()
            seconds = rec.seconds
        else:
            seconds = time.perf_counter() - self.t0
        if self.timed:
            t = self.reg._timers.get(self.name)
            if t is None:
                t = self.reg._timers[self.name] = _Timer()
            t.total += seconds
            t.calls += 1
        return False


class TimerRegistry:
    def __init__(self):
        self._timers: dict[str, _Timer] = {}
        self.counts: dict[str, int] = {}
        #: the spans recorded while tracing was on, in the order they opened
        self.spans: list[Span] = []
        self._open: list[Span] = []

    def scope(self, name: str, **attrs):
        """RAII timing scope of a coarse stage: its host time is totalled
        under `name`; while tracing is on it is also recorded with `attrs`."""
        return _Scope(self, name, attrs, True)

    def span(self, name: str, **attrs):
        """A span of fine work, recorded only while tracing is on (its host
        time is not totalled); otherwise a shared null context."""
        if not _profiler._is_profiler_enabled:
            return _NULL
        return _Scope(self, name, attrs, False)

    def host_sync(self):
        """Bracket one point where the host blocks on the card: counted as
        "host syncs" always (on the innermost recorded span too).  Inside a
        "GMRES" span, while tracing is on, it is also spanned as "Host sync",
        which then holds the count."""
        if _profiler._is_profiler_enabled and any(s.name == SYNCS_SPANNED_IN for s in self._open):
            return _Scope(self, HOST_SYNC, {}, False, counter=HOST_SYNCS)
        self.count(HOST_SYNCS)
        return _NULL

    def count(self, name: str, k: int = 1):
        """Add `k` to counter `name`, and to the innermost recorded span's."""
        self.counts[name] = self.counts.get(name, 0) + k
        if self._open:
            c = self._open[-1].counts
            c[name] = c.get(name, 0) + k

    def reset(self):
        """Clear the timers, counters and recorded spans."""
        self._timers.clear()
        self.counts.clear()
        self.spans.clear()

    def summary(self) -> str:
        """Teuchos-style summary table of host times, then the counters."""
        if not self._timers and not self.counts:
            return "(no timers recorded)"
        w = max(len(n) for n in (*self._timers, *self.counts)) + 2
        lines = [
            f"{'Timer':<{w}}{'Calls':>8}{'Host (s)':>12}{'Host mean (ms)':>16}",
            "-" * (w + 36),
        ]
        for name, t in sorted(self._timers.items()):
            mean_ms = (t.total / t.calls * 1e3) if t.calls else 0.0
            lines.append(f"{name:<{w}}{t.calls:>8}{t.total:>12.3f}{mean_ms:>16.2f}")
        if self.counts:
            lines += ["", f"{'Counter':<{w}}{'Total':>8}", "-" * (w + 8)]
            lines += [f"{name:<{w}}{n:>8}" for name, n in sorted(self.counts.items())]
        return "\n".join(lines)

    def as_dict(self) -> dict:
        """The timers' calls and host seconds by name."""
        return {name: {"calls": t.calls, "total_s": t.total} for name, t in self._timers.items()}


#: process-global registry (the reference's static Teuchos timers)
timers = TimerRegistry()
