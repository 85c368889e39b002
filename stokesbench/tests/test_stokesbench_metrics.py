"""The metric arithmetic on a synthetic run and a synthetic trace: frame
time over the window, the percentile, the idle share, the device
operations each call launched, and a roofline share from the counts."""

import pytest

from stokesbench import harness, roofline, trace
from stokesbench.metrics import (
    bulk_roofline,
    device_idle,
    files_ms,
    frame_p95_s,
    frame_s,
    gmres_iter_ms,
    lu_factor_ms,
    matvec_roofline,
    peak_mem_gib,
)
from stokesbench.spans import PREFIX, Span


class FakeSpans:
    def __init__(self, records):
        self.records = records

    def of(self, name):
        return [s for s in self.records if s.name == name]


def event(name, start, end, cuda=False, annotation=False, corr=0, linked=0):
    return name, cuda, start, end, annotation, corr, linked


def record(**kw):
    base = dict(cell=None, setup_s=3.0, frame_seconds=[1.0, 2.0, 1.0, 4.0], window_s=8.0, peak_bytes=3 * 2**30)
    base.update(kw)
    return harness.Record(**base)


def test_frame_metrics():
    rec = record()
    assert frame_s.read(rec) == 2.0
    assert frame_p95_s.read(rec) == pytest.approx(4.0 - 0.05 * 3 * 2.0)  # between the 3rd and 4th order statistic
    assert peak_mem_gib.read(rec) == 3.0


def test_trace_reduction_and_idle_share():
    events = [
        event(PREFIX + "window", 0.0, 1000.0),
        event(PREFIX + "bulk", 100.0, 300.0),
        event(PREFIX + "files", 500.0, 900.0),
        event("node_sweep_kernel<double>", 110.0, 290.0, cuda=True),
        event("Memcpy DtoH", 300.0, 350.0, cuda=True),
        event("gemv", 950.0, 1200.0, cuda=True),  # runs past the window: clipped
        event(PREFIX + "bulk", 100.0, 300.0, cuda=True, annotation=True),  # a device-side annotation: not work
    ]
    red = trace.reduce(events)
    assert red["window_s"] == pytest.approx(1e-3)
    assert red["busy_s"] == pytest.approx((180 + 50 + 50) / 1e6)
    labels = dict(red["idle_gaps"])
    assert labels["files"] == pytest.approx(600e-6)  # the gap 350-950 us: its middle is in the files span
    assert labels["frame loop, outside the spans"] == pytest.approx(110e-6)
    rec = record(trace=red)
    assert device_idle.read(rec) == pytest.approx(100 * (1 - 280 / 1000))


@pytest.mark.parametrize("skew", [400.0, -80.0])
def test_device_time_of_each_call_from_the_trace(skew):
    """A device operation belongs to the call during which it started on the
    card, with the card's clock brought to the host's by the launches the
    trace correlates: here the device clock runs `skew` us off the host's,
    so the kernels lie outside their calls' host spans, and are still found,
    and a kernel launched after a call is not counted in it."""
    events = [
        event(PREFIX + "window", 0.0, 5000.0, corr=1),
        event(PREFIX + "matvec#0", 100.0, 200.0, corr=2),
        event("cudaLaunchKernel", 120.0, 125.0, corr=900, linked=2),
        event("cudaMemsetAsync", 113.0, 114.0, corr=901, linked=3),
        event("sweep_matvec_kernel", 130.0 + skew, 190.0 + skew, cuda=True, corr=900, linked=2),
        event("Memset (Device)", 115.0 + skew, 120.0 + skew, cuda=True, corr=901, linked=3),
        # launched right after the call: its own latency puts it after the call
        event("cudaLaunchKernel", 205.0, 207.0, corr=904, linked=5),
        event("gemv", 209.0 + skew, 240.0 + skew, cuda=True, corr=904, linked=5),
        event(PREFIX + "matvec#1", 300.0, 400.0, corr=4),
        # a kernel whose launch the trace does not correlate: found by time
        event("sweep_matvec_kernel", 320.0 + skew, 398.0 + skew, cuda=True, corr=902),
        event("cudaLaunchKernel", 1000.0, 1005.0, corr=903, linked=1),
        event("gemv", 1010.0 + skew, 1100.0 + skew, cuda=True, corr=903, linked=1),
    ]
    red = trace.reduce(events)
    assert red["span_device_s"] == pytest.approx({"matvec#0": 65e-6, "matvec#1": 78e-6})
    assert dict(red["idle_gaps"]).keys() <= {"matvec", "frame loop, outside the spans"}


def test_spans_and_rooflines():
    info = dict(kernel="free_space", dtype="float64", nr=7698, n=7698, m=64)
    spans = FakeSpans([
        Span("files", 0.2, None), Span("files", 0.4, None),
        Span("gmres", 0.3, dict(iterations=50)), Span("gmres", 0.1, dict(iterations=30)),
        Span("lu_factor", 0.35, dict(refactored=True)), Span("lu_factor", 0.001, dict(refactored=False)),
        Span("bulk", 0.02, dict(info, call=0)),
        Span("matvec", 0.01, dict(info, shape=(1, 0), call=1)),
        Span("matvec", 0.07, dict(info, shape=(1, 10), call=2)),
        Span("matvec", 0.01, dict(info, shape=(1, 0), call=3)),  # no operation of it in the trace
    ])
    least, by = roofline.bound("free_space", "float64", 7698, 7698, 64)
    assert by == "operations" and least == pytest.approx(1e3 * 50 * 7698**2 * 64 / 33.5e12)
    red = dict(window_s=1.0, busy_s=0.5,
               span_device_s={"bulk#0": 2 * least / 1e3, "matvec#1": 4e-3, "matvec#2": 70e-3})
    rec = record(frame_seconds=[1.0, 1.0], spans=spans, trace=red)
    assert files_ms.read(rec) == pytest.approx(300.0)
    assert gmres_iter_ms.read(rec) == pytest.approx(400.0 / 80)
    assert lu_factor_ms.read(rec) == pytest.approx(350.0)
    assert bulk_roofline.read(rec) == pytest.approx(50.0)
    k5 = roofline.matvec_bound("free_space", "float64", 7698, 7698, 64, (1, 0))[0]
    assert matvec_roofline.read(rec) == pytest.approx(100 * k5 / 4.0)  # the wide set-up sweep has no count


def test_readers_find_nothing_to_read():
    rec = record()
    for reader in (files_ms, gmres_iter_ms, lu_factor_ms, bulk_roofline, matvec_roofline, device_idle):
        assert reader.read(rec) is None
