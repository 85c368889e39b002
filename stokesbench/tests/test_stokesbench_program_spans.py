"""The readers of the program's own spans and counters on a registry filled
by hand: the window's spans from its first frame on, the split of a GMRES
iteration into issue and wait, the host syncs an iteration, the VTU time a
frame, and nothing where the registry holds no window spans."""

import pytest

import bemstokes_tpu_torch.utils as program_utils
from bemstokes_tpu_torch.utils.timers import Span, TimerRegistry
from stokesbench import harness
from stokesbench.metrics import gmres_issue_ms, gmres_wait_ms, host_syncs_per_iter, vtu_ms

READERS = (gmres_issue_ms, gmres_wait_ms, host_syncs_per_iter, vtu_ms)
MS = 1_000_000  # ns


def record(frames):
    return harness.Record(cell=None, setup_s=1.0, frame_seconds=[0.5] * frames, window_s=0.5 * frames,
                          peak_bytes=0)


def add(reg, name, parent, start_ms, end_ms, frame=None, **attrs):
    counts = attrs.pop("counts", {})
    s = Span(name, parent, frame if parent is None else parent.frame, start_ms * MS, end_ms * MS, attrs, counts)
    reg.spans.append(s)
    return s


def frame(reg, k, t0, iterations, sync_ms, syncs, vtu_ms_):
    """A frame at t0 ms: a 20 ms GMRES of `iterations` iterations holding
    `syncs` host syncs of `sync_ms` each (one in each iteration's
    orthogonalisation, the rest directly under GMRES), then a VTU."""
    f = add(reg, "Frame", None, t0, t0 + 100, frame=k)
    g = add(reg, "GMRES", f, t0 + 10, t0 + 30, iterations=iterations, counts={"gmres iterations": iterations})
    t = t0 + 10
    for i in range(syncs):
        parent = add(reg, "Orthogonalisation", g, t, t + sync_ms + 0.5) if i < iterations else g
        add(reg, "Host sync", parent, t, t + sync_ms, counts={"host syncs": 1})
        t += sync_ms + 0.5
    # a host sync outside the solve is not the solve's
    add(reg, "Host sync", f, t0 + 40, t0 + 45, counts={"host syncs": 1})
    out = add(reg, "Frame output", f, t0 + 50, t0 + 50 + vtu_ms_ + 2)
    add(reg, "VTU", out, t0 + 51, t0 + 51 + vtu_ms_)


@pytest.fixture
def registry(monkeypatch):
    reg = TimerRegistry()
    monkeypatch.setattr(program_utils, "timers", reg)
    return reg


def test_readers_split_a_gmres_iteration(registry):
    # a frame of an earlier traced run, then the window's two frames
    frame(registry, 7, 0, iterations=9, sync_ms=3.0, syncs=9, vtu_ms_=50)
    frame(registry, 3, 1000, iterations=4, sync_ms=1.0, syncs=5, vtu_ms_=10)
    frame(registry, 4, 2000, iterations=6, sync_ms=2.0, syncs=7, vtu_ms_=30)
    rec = record(2)
    wait = 5 * 1.0 + 7 * 2.0
    assert gmres_wait_ms.read(rec) == pytest.approx(wait / 10)
    assert gmres_issue_ms.read(rec) == pytest.approx((40 - wait) / 10)
    assert gmres_issue_ms.read(rec) + gmres_wait_ms.read(rec) == pytest.approx(40 / 10)
    assert host_syncs_per_iter.read(rec) == pytest.approx(12 / 10)
    assert vtu_ms.read(rec) == pytest.approx((10 + 30) / 2)


def test_nested_host_sync_counts_once(registry):
    frame(registry, 0, 0, iterations=2, sync_ms=1.0, syncs=2, vtu_ms_=5)
    inner_parent = next(s for s in registry.spans if s.name == "Host sync" and s.parent.name == "Orthogonalisation")
    add(registry, "Host sync", inner_parent, 10.2, 10.4)
    rec = record(1)
    assert gmres_wait_ms.read(rec) == pytest.approx(2.0 / 2)


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[1])
def test_empty_registry_reads_nothing(registry, reader):
    assert reader.read(record(3)) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[1])
def test_fewer_frames_than_the_window_read_nothing(registry, reader):
    frame(registry, 0, 0, iterations=2, sync_ms=1.0, syncs=2, vtu_ms_=5)
    assert reader.read(record(2)) is None


@pytest.mark.parametrize("reader", READERS, ids=lambda r: r.__name__.rsplit(".", 1)[1])
def test_registry_without_spans_reads_nothing(monkeypatch, reader):
    class Plain:  # a registry that keeps timers only
        pass

    monkeypatch.setattr(program_utils, "timers", Plain())
    assert reader.read(record(1)) is None


def test_no_gmres_in_the_window(registry):
    f = add(registry, "Frame", None, 0, 10, frame=0)
    add(registry, "VTU", f, 1, 3)
    rec = record(1)
    assert gmres_issue_ms.read(rec) is None and host_syncs_per_iter.read(rec) is None
    assert vtu_ms.read(rec) == pytest.approx(2.0)
