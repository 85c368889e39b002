"""The port's tracer (`bemstokes_tpu_torch/utils/timers.py`) on the CPU: off,
a frame loop keeps its per-name host totals and records no span; under
`torch.profiler` it records the frame's span tree with one frame id a frame,
the GMRES iteration's three children, the near-pair delta of a promoted
quadrature, the host syncs and the counters (the stale LU's permutations
and applies among them), each also an annotation of the
profiler's trace on the same clock."""

import contextlib
import json

import pytest
import torch

from bemstokes_tpu_torch.config import ProblemConfig, QuadratureConfig, WallConfig
from bemstokes_tpu_torch.la.direct import LUPreconditioner
from bemstokes_tpu_torch.la.gmres import gmres
from bemstokes_tpu_torch.ops import lu_trsv
from bemstokes_tpu_torch.swimmer import SwimmerSimulation
from bemstokes_tpu_torch.utils import timers
import torch_threads  # noqa: F401  (one torch thread a test process)

CPU = [torch.profiler.ProfilerActivity.CPU]
#: how far a span's record may lie from its annotation in the trace
CLOCK_US = 50.0


def sphere_cfg(height=2.0, **kw):
    """A unit sphere (create_sphere(1)) towed beside the Blake no-slip wall,
    its centre `height` above it: two frames of the Direct loop, files every
    frame."""
    return ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=1,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=0,
        no_slip_kernel=True,
        walls=(WallConfig(enabled=False, position=(0.0, -height, 0.0), span=(10.0, 0.0, 10.0)),),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        n_frames=2,
        **kw,
    )


@pytest.fixture
def registry():
    timers.reset()
    yield timers
    timers.reset()


def run_loop(out, traced, **kw):
    """Two frames of the loop; traced, the set-up is recorded too."""
    if traced:
        with torch.profiler.profile(activities=CPU):
            sim = SwimmerSimulation(sphere_cfg(**kw), str(out), device="cpu")
            sim.run(0, 2)
    else:
        sim = SwimmerSimulation(sphere_cfg(**kw), str(out), device="cpu")
        sim.run(0, 2)
    return sim


def named(name):
    return [s for s in timers.spans if s.name == name]


def dense_system(n=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.eye(n, dtype=torch.float64) * 4 + 0.3 * torch.randn(n, n, generator=g, dtype=torch.float64)
    b = torch.randn(n, generator=g, dtype=torch.float64)
    return A, b


def test_untraced_loop_records_no_spans_and_keeps_totals(registry, tmp_path):
    run_loop(tmp_path, traced=False)
    assert timers.spans == []
    totals = timers.as_dict()
    for name in ("Run", "Frame", "BEM Reinitialisation", "Assemble", "LAC Solve", "GMRES",
                 "DirectPreconditioner Refactorisation", "Frame output", "Result file", "State file",
                 "Time series", "VTU"):
        assert totals[name]["calls"] == (1 if name == "Run" else 2), name
        assert totals[name]["total_s"] > 0
    # the fine spans are kept only while tracing
    for name in ("Matvec", "Preconditioner", "Orthogonalisation", "Node sweep", "Host sync"):
        assert name not in totals
    counters = timers.counts
    assert counters["host syncs"] > 0 and counters["gmres iterations"] > 0 and counters["output bytes"] > 0
    table = timers.summary()
    assert "Host (s)" in table and "Frame output" in table and "host syncs" in table


def test_traced_loop_records_the_frame_tree(registry, tmp_path):
    run_loop(tmp_path, traced=True)
    frames = named("Frame")
    assert [f.attrs["frame"] for f in frames] == [0, 1]
    assert all(f.parent.name == "Run" for f in frames)
    parent_of = {
        "BEM Reinitialisation": "Frame",
        "Assemble + LAC Solve": "Frame",
        "Assemble": "Assemble + LAC Solve",
        "LAC Solve": "Assemble + LAC Solve",
        "DirectPreconditioner Refactorisation": "LAC Solve",
        "GMRES": "LAC Solve",
        "Preconditioner": "GMRES",
        "Matvec": "GMRES",
        "Orthogonalisation": "GMRES",
        "Frame output": "Frame",
        "Result file": "Frame output",
        "State file": "Frame output",
        "Time series": "Frame output",
        "VTU": "Frame output",
    }
    for name, parent in parent_of.items():
        spans = named(name)
        assert spans, name
        assert all(s.parent.name == parent for s in spans), name
        assert len(named(name)) >= 2
    for name in ("Frame output", "VTU", "GMRES", "Assemble"):
        assert [s.frame for s in named(name)] == [0, 1], name
    # every span under a frame carries that frame's id
    for s in timers.spans:
        root = s
        while root.parent is not None and root.name != "Frame":
            root = root.parent
        if root.name == "Frame":
            assert s.frame == root.attrs["frame"]
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns
    sweeps = named("Node sweep")
    assert sweeps and all(s.within("Assemble") for s in sweeps)
    # the assembly's host syncs are counted on its spans, not spanned
    syncs = named("Host sync")
    assert syncs and all(s.within("GMRES") for s in syncs)
    assembly = [s for s in timers.spans if s.within("Assemble") or s.name == "Assemble"]
    assert sum(s.counts.get("host syncs", 0) for s in assembly) > 0
    refactor = named("DirectPreconditioner Refactorisation")
    assert refactor[0].attrs["refactored"] is True
    for g in named("GMRES"):
        assert g.attrs["iterations"] == g.counts["gmres iterations"] > 0
    # the bytes each writer wrote are the counts of its span
    vtu = named("VTU")[1]
    assert vtu.counts["output bytes"] == (tmp_path / "stokes_1.vtu").stat().st_size
    state = named("State file")[0]
    assert state.counts["output bytes"] == (tmp_path / "state_0.npz").stat().st_size


def test_traced_matrix_free_loop_spans_the_sweep(registry, tmp_path):
    run_loop(tmp_path, traced=True, matrix_free=True, matfree_block_nodes=8)
    sweeps = named("Sweep matvec")
    assert sweeps
    in_matvec = [s for s in sweeps if s.parent.name == "Matvec"]
    assert len(in_matvec) == len(named("Matvec"))
    assert all(s.within("GMRES") and s.within("Matfree GMRES") for s in in_matvec)


#: the sphere 1.02 radii above the wall: the quadrature is promoted (far
#: rule order 2, near pairs order 8), as in the benchmark's contact cell
CONTACT = dict(height=1.02, quadrature=QuadratureConfig(order=2, promote_boost=6))
#: host syncs of one promoted assembly of CONTACT's create_sphere(1) before
#: the near delta had spans: the spans add none
CONTACT_ASSEMBLY_SYNCS = 111


def test_promoted_loop_spans_the_near_delta(registry, tmp_path):
    sim = run_loop(tmp_path, traced=True, **CONTACT)
    (decision,) = named("Quadrature promotion")
    assert decision.attrs == sim.problem.quadrature_promotion
    assert decision.attrs["promoted"] is True and sim.problem.quadrature_promoted
    assert decision.attrs["gap"] == pytest.approx(0.04, rel=1e-3)
    assert decision.attrs["gap"] < decision.attrs["diameter"]
    assert (decision.attrs["order_far"], decision.attrs["order_near"]) == (2, 8)
    assemblies, deltas = named("Assemble"), named("Near delta")
    assert len(assemblies) == len(deltas) == 2
    rows, panels = sim.problem.n, min(32, len(sim.mesh.cells))
    for asm, d in zip(assemblies, deltas):
        assert d.parent is asm and d.frame == asm.frame
        assert d.attrs == dict(rows=rows, near_panels=panels, chunks=1, far_points=4, near_points=64)
        assert d.counts["near pairs"] == rows * panels
        children = [s for s in timers.spans if s.parent is d]
        assert [c.name for c in children] == ["Near selection", "Near local blocks"]
        # three table uploads; a chunk, each rule's four tables and the
        # image kernel's four scalars copied in; the two scatters
        inside = sum(s.counts.get("host syncs", 0) for s in [d, *children])
        assert inside == 3 + 2 * 8 * d.attrs["chunks"] + 2
        in_asm = [s for s in timers.spans if s is asm or (s.within("Assemble") and s.frame == asm.frame)]
        assert sum(s.counts.get("host syncs", 0) for s in in_asm) == CONTACT_ASSEMBLY_SYNCS
    assert timers.counts["near pairs"] == 2 * rows * panels


def test_unpromoted_loop_has_no_near_delta(registry, tmp_path):
    sim = run_loop(tmp_path, traced=True)
    (decision,) = named("Quadrature promotion")
    assert decision.attrs["promoted"] is False and not sim.problem.quadrature_promoted
    assert decision.attrs["gap"] == pytest.approx(2.0, rel=1e-3)
    assert decision.attrs["gap"] > decision.attrs["diameter"]
    assert decision.attrs["order_far"] == decision.attrs["order_near"] == 4
    assert named("Assemble") and not named("Near delta") and not named("Near local blocks")
    assert "near pairs" not in timers.counts


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_gmres_spans_each_iteration(registry, traced):
    A, b = dense_system()
    P = torch.linalg.inv(torch.diag(torch.diag(A)))
    if traced:
        with torch.profiler.profile(activities=CPU):
            x, info = gmres(lambda v: A @ v, b, precond=lambda v: P @ v, restart=5, tol=1e-12, max_restarts=20)
    else:
        x, info = gmres(lambda v: A @ v, b, precond=lambda v: P @ v, restart=5, tol=1e-12, max_restarts=20)
    its = info["iterations"]
    assert its > 5  # several restarts
    assert timers.counts["gmres iterations"] == its
    assert torch.linalg.vector_norm(A @ x - b) <= 1e-10 * torch.linalg.vector_norm(b)
    if not traced:
        assert timers.spans == []
        return
    (g,) = named("GMRES")
    assert g.attrs == dict(iterations=its, restarts=-(-its // 5))
    assert g.counts["gmres iterations"] == its
    for name in ("Matvec", "Preconditioner", "Orthogonalisation"):
        spans = named(name)
        assert len(spans) == its and all(s.parent is g for s in spans), name


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_host_syncs_count_the_helper_calls(registry, monkeypatch, traced):
    calls = []
    helper = timers.host_sync

    def counted():
        calls.append(1)
        return helper()

    monkeypatch.setattr(timers, "host_sync", counted)
    A, b = dense_system(seed=1)
    with torch.profiler.profile(activities=CPU) if traced else contextlib.nullcontext():
        gmres(lambda v: A @ v, b, restart=4, tol=1e-10, max_restarts=30)
        with timers.host_sync():
            pass
    assert calls and timers.counts["host syncs"] == len(calls)
    if traced:
        # every call inside the solve is a span; the last, outside it, only counts
        syncs = named("Host sync")
        assert len(syncs) == len(calls) - 1 and all(s.counts == {"host syncs": 1} for s in syncs)
        assert all(s.parent is not None and s.within("GMRES") for s in syncs)
        # each iteration reads its column back and copies the rotated one in
        its = named("GMRES")[0].attrs["iterations"]
        in_orth = [s for s in syncs if s.parent is not None and s.parent.name == "Orthogonalisation"]
        assert len(in_orth) == 2 * its
    else:
        assert timers.spans == []


def test_counter_attaches_to_the_innermost_span(registry):
    with torch.profiler.profile(activities=CPU):
        with timers.scope("Outer", size=3):
            timers.count("things", 3)
            with timers.span("Inner"):
                timers.count("things", 2)
                timers.count("other")
        timers.count("things", 5)  # no span open: the total alone
    outer, inner = named("Outer")[0], named("Inner")[0]
    assert outer.counts == {"things": 3} and outer.attrs == {"size": 3}
    assert inner.counts == {"things": 2, "other": 1} and inner.parent is outer
    assert timers.counts == {"things": 10, "other": 1}


def test_untraced_span_is_a_shared_null_context(registry):
    assert timers.span("Matvec") is timers.span("Orthogonalisation")
    with timers.span("Matvec"):
        timers.count("n")
    with timers.scope("Stage"):
        pass
    assert timers.spans == [] and timers.counts == {"n": 1}
    assert set(timers.as_dict()) == {"Stage"}


def _check_trace_clock(path):
    """[(span, annotation start - record start us, end - end us)] of every
    recorded span against the exported trace's annotations of its name, in
    order."""
    trace = json.loads(path.read_text())
    base = trace.get("baseTimeNanoseconds", 0)
    notes = {}
    for e in trace["traceEvents"]:
        if e.get("cat") == "user_annotation":
            start = e["ts"] * 1e3 + base
            notes.setdefault(e["name"], []).append((start, start + e["dur"] * 1e3))
    out = []
    for name in {s.name for s in timers.spans}:
        spans = sorted(named(name), key=lambda s: s.start_ns)
        found = sorted(notes.get(name, []))
        assert len(found) == len(spans), name
        for s, (a, b) in zip(spans, found):
            out.append((s, (a - s.start_ns) / 1e3, (b - s.end_ns) / 1e3))
    return out


def test_trace_annotations_match_the_records(registry, tmp_path):
    """Every recorded span is an annotation of the exported trace, its start
    and end within CLOCK_US of the record.  A time slice lost between the
    profiler's stamp and the record's moves one pair by a scheduler tick,
    so the traced solve is repeated (up to four times) until one run has
    every pair within the bound; a clock that differs fails every run."""
    A, b = dense_system(n=12, seed=2)
    for attempt in range(4):
        timers.reset()
        with torch.profiler.profile(activities=CPU) as prof:
            with timers.scope("Solve"):
                gmres(lambda v: A @ v, b, restart=4, tol=1e-8, max_restarts=10)
        path = tmp_path / f"trace{attempt}.json"
        prof.export_chrome_trace(str(path))
        pairs = _check_trace_clock(path)
        assert len(pairs) == len(timers.spans) > 20
        worst = max(max(abs(d0), abs(d1)) for _, d0, d1 in pairs)
        if worst <= CLOCK_US:
            break
    assert worst <= CLOCK_US


@pytest.mark.parametrize("traced", [False, True], ids=["untraced", "traced"])
def test_lu_preconditioner_counts_permutations_and_applies(registry, traced):
    """One factorization and k applies: `lu permutations` 1 on the
    refactorisation, `lu applies` k, one on each "Preconditioner" span and
    one at each cycle's end on "GMRES"; the apply syncs nothing."""
    A, b = dense_system(seed=2)
    stale = A + 0.3 * torch.randn(A.shape, generator=torch.Generator().manual_seed(3), dtype=A.dtype)
    p = LUPreconditioner()
    with torch.profiler.profile(activities=CPU) if traced else contextlib.nullcontext():
        with timers.scope("DirectPreconditioner Refactorisation"):
            assert p.maybe_refactor(stale, 0)
        syncs = timers.counts["host syncs"]
        x, info = gmres(lambda v: A @ v, b, precond=p.apply, restart=4, tol=1e-12, max_restarts=30)
    its = info["iterations"]
    cycles = -(-its // 4)
    assert its > 4 and torch.linalg.vector_norm(A @ x - b) <= 1e-10 * torch.linalg.vector_norm(b)
    assert timers.counts["lu permutations"] == 1
    assert timers.counts["lu applies"] == its + cycles
    # the factor's status, the pivots' read back, the permutation's upload
    assert syncs == 3
    if not traced:
        return
    (refactor,) = named("DirectPreconditioner Refactorisation")
    assert refactor.counts == {"host syncs": 3, "lu permutations": 1}
    applies = named("Preconditioner")
    assert len(applies) == its and all(s.counts == {"lu applies": 1} for s in applies)
    (g,) = named("GMRES")
    assert g.counts["lu applies"] == cycles


def test_lu_applies_native_is_not_counted_on_the_cpu(registry):
    """On the CPU the stale LU has no kernel plan: `lu applies` counts every
    apply, `lu applies native` none; the kernel's entry point takes the
    factor row-major as well as column-major (the same diagonal inverses and
    coupling tiles, read through the strides), and refuses a factor it
    cannot read and a right-hand side of another dtype."""
    A, b = dense_system(seed=4)
    p = LUPreconditioner()
    p.set_up(A)
    assert p._plan is None
    for _ in range(3):
        p.apply(b)
    assert timers.counts["lu applies"] == 3
    assert timers.counts.get("lu applies native", 0) == 0
    lu = p._factors[0]
    n = lu.shape[0]
    assert lu_trsv.plan(lu) is None
    col, row = lu_trsv.TrsvPlan(lu, grid=1), lu_trsv.TrsvPlan(lu.contiguous(), grid=1)
    assert (col.row_major, col.ld, row.row_major, row.ld) == (False, n, True, n)
    for u in (0, 1):
        assert torch.equal(row.dinv[u], col.dinv[u]) and torch.equal(row.coupling[u], col.coupling[u])
    with pytest.raises(ValueError, match="column-major"):
        lu_trsv.TrsvPlan(torch.linalg.lu_factor(torch.eye(80, dtype=A.dtype))[0][::2, ::2], grid=1)  # strided
    with pytest.raises(ValueError, match=f"ld >= {n}"):
        lu_trsv.TrsvPlan(lu.contiguous().as_strided((n, n), (n - 1, 1)), grid=1)  # ld < n
    with pytest.raises(ValueError, match="column-major"):
        lu_trsv.TrsvPlan(torch.zeros(n, 2 * n, dtype=A.dtype).mT[:n], grid=1)  # column-major, ld 2n
    with pytest.raises(ValueError, match="one square factor"):
        lu_trsv.TrsvPlan(torch.stack([lu, lu]), grid=1)  # batched
    with pytest.raises(TypeError, match="float32 or float64"):
        lu_trsv.TrsvPlan(lu.mT.to(torch.float16).mT, grid=1)
    with pytest.raises(TypeError, match="b is torch.float32"):
        lu_trsv.TrsvPlan(lu, grid=1).solve(p._perm, b.float())
