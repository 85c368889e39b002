"""The distributed frame step's spans and counters (`parallel/`, in the
tracer of `utils/timers.py`) in a gloo group of W = 2 processes on the CPU:
the sphere `create_sphere(2)` towed beside the Blake no-slip wall under the
Direct preconditioner, a step with a fresh slab LU, a step on the stale one,
then a third step with the profiler off.

Held: "Slab assembly" (one a step), "Slab LU factor" under
"DirectPreconditioner Refactorisation" (one a factorization), "Slab LU
apply" under "Preconditioner" and "Sharded matvec" under "Matvec" (one an
iteration each) carry `world`, `m` and `steps`; inside each "GMRES" span
the counters `collectives` and `collective bytes` equal what the code
issues for its k iterations in one cycle (below); off the profiler no span
is kept, the scopes keep their host totals and the counters still count;
on the CPU no slab triangle goes through the LU kernel (`slab triangles
native` 0, traced or not); and the one-card frame solve records none of
these spans or counters.

A GMRES solve of k iterations in one cycle issues, on each of W ranks with
m slab rows:

- an iteration: the slab LU apply's 2W broadcasts of an [m] block and the
  all-gather of its result, the matvec's all-gather, the broadcast of the
  Hessenberg column (j + 2 values at iteration j): 2W + 3;
- the solve: the broadcasts of |b|, of the residual before and after the
  cycle and of beta (4), the cycle's closing preconditioner (2W + 1) and
  the two residuals' matvecs (2): 2W + 7;

so (k + 1)(2W + 3) + 4 collectives.  Rank r receives 8 (W - 1) m bytes
from each all-gather and 8 m from each of the 2 (W - 1) broadcasts of a
block it does not solve, and the broadcasts of scalars from rank 0 only
where r > 0.
"""

import pytest
import torch

from torch_dist_group import Group
import torch_threads  # noqa: F401  (one torch thread a test process)

CPU = [torch.profiler.ProfilerActivity.CPU]
WORLD = 2
NEW = ("Slab assembly", "Slab LU factor", "Slab LU apply", "Sharded matvec")


def problem():
    import bemstokes_tpu_torch.config as cm
    import bemstokes_tpu_torch.mesh.factories as fac
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    cfg = cm.ProblemConfig(
        grid_type="ImposedForce",
        imposed_component=0,
        no_slip_kernel=True,
        walls=(cm.WallConfig(enabled=False, position=(0.0, -2.0, 0.0), span=(10.0, 0.0, 10.0)),),
        time_step=5.0,
    )
    return StokesBEMProblem(fac.create_sphere(refinements=2), cfg, device="cpu")


def _ancestors(s):
    names, p = [], s.parent
    while p is not None:
        names.append(p.name)
        p = p.parent
    return names


def _inside(s, solve):
    p = s.parent
    while p is not None:
        if p is solve:
            return True
        p = p.parent
    return False


# ---- the ranks (child processes) --------------------------------------------


def traced_steps(mesh):
    from bemstokes_tpu_torch.parallel.sharded import padded_rows
    from bemstokes_tpu_torch.parallel.solve import make_sharded_frame_step
    from bemstokes_tpu_torch.utils import timers

    prob = problem()
    step = make_sharded_frame_step(prob, mesh, return_fields=True)
    euler = prob.initial_euler()
    sdot = torch.zeros(3 * prob.n, dtype=torch.float64)
    timers.reset()
    with torch.profiler.profile(activities=CPU):
        for _ in range(2):
            euler = step(euler, sdot)[1]
    spans = list(timers.spans)
    out = dict(
        m=3 * padded_rows(prob.n, mesh)[1],
        spans=[
            dict(name=s.name, ancestors=_ancestors(s), attrs=dict(s.attrs), counts=dict(s.counts))
            for s in spans
            if s.name in NEW
        ],
        native=timers.counts.get("slab triangles native", 0),
        solves=[],
    )
    for g in (s for s in spans if s.name == "GMRES"):
        held = [g] + [s for s in spans if _inside(s, g)]
        out["solves"].append(
            dict(
                iterations=g.attrs["iterations"],
                restarts=g.attrs["restarts"],
                collectives=sum(s.counts.get("collectives", 0) for s in held),
                bytes=sum(s.counts.get("collective bytes", 0) for s in held),
            )
        )
    timers.reset()
    info = step(euler, sdot)[2]
    out["untraced"] = dict(
        spans=len(timers.spans),
        timers=timers.as_dict(),
        counts=dict(timers.counts),
        iterations=int(info["iterations"]),
    )
    return out


# ---- the tests (this process) -----------------------------------------------


def derived(k, m, rank, world=WORLD):
    """(collectives, bytes this rank receives) of a GMRES solve of k
    iterations in one cycle (the module's docstring)."""
    collectives = (k + 1) * (2 * world + 3) + 4
    vectors = 8 * m * (world - 1) * ((k + 2) + 3 * (k + 1))
    scalars = 8 * (4 + sum(j + 2 for j in range(k))) if rank > 0 else 0
    return collectives, vectors + scalars


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return Group(__name__, "traced_steps", WORLD, tmp_path_factory.mktemp("ranks")).results()


def test_distributed_step_records_its_spans(ranks):
    for rank, r in enumerate(ranks):
        m = r["m"]
        iterations = sum(s["iterations"] for s in r["solves"])
        by_name = {n: [s for s in r["spans"] if s["name"] == n] for n in NEW}
        assert len(by_name["Slab assembly"]) == 2, rank
        assert len(by_name["Slab LU factor"]) == 1, rank  # the second step reuses the factor
        for s in r["spans"]:
            assert s["attrs"]["world"] == WORLD and s["attrs"]["m"] == m, s
        for s in by_name["Slab LU factor"]:
            assert s["attrs"]["steps"] == WORLD and "DirectPreconditioner Refactorisation" in s["ancestors"]
        for s in by_name["Slab LU apply"]:
            assert s["attrs"]["steps"] == 2 * WORLD
        in_iterations = [s for s in by_name["Slab LU apply"] if "Preconditioner" in s["ancestors"]]
        assert len(in_iterations) == iterations >= 2
        matvecs = [s for s in by_name["Sharded matvec"] if "Matvec" in s["ancestors"]]
        assert len(matvecs) == iterations
        assert all("GMRES" in s["ancestors"] for s in by_name["Sharded matvec"])


def test_collectives_inside_gmres_are_the_derived_counts(ranks):
    for rank, r in enumerate(ranks):
        assert len(r["solves"]) == 2
        for s in r["solves"]:
            assert s["restarts"] == 1 and s["iterations"] >= 1, s
            assert (s["collectives"], s["bytes"]) == derived(s["iterations"], r["m"], rank), (rank, s)
    # the ranks agree on every branch, so they issue the same collectives
    assert [s["collectives"] for s in ranks[0]["solves"]] == [s["collectives"] for s in ranks[1]["solves"]]


def test_untraced_step_keeps_totals_and_counts(ranks):
    for rank, r in enumerate(ranks):
        u = r["untraced"]
        assert u["spans"] == 0
        assert u["timers"]["Slab assembly"]["calls"] == 1 and u["timers"]["Slab assembly"]["total_s"] > 0
        # the stale factor is reused: no factorization, and the solve's
        # collectives and those of the assembly (the replicated geometry's
        # broadcast, the solid-angle check's all-reduce, the projections'
        # all-gathers) are counted
        assert "Slab LU factor" not in u["timers"]
        assert u["counts"]["collectives"] > derived(u["iterations"], r["m"], rank)[0]
        assert u["counts"]["collective bytes"] > 0


def test_slab_triangles_are_not_native_on_the_cpu(ranks):
    """The CPU has no kernel plan: every slab triangle takes
    `solve_triangular`, so `slab triangles native` counts none, on no
    "Slab LU apply" span and in no step, traced or not."""
    for r in ranks:
        applies = [s for s in r["spans"] if s["name"] == "Slab LU apply"]
        assert applies and all("slab triangles native" not in s["counts"] for s in applies)
        assert all(s["counts"].get("collectives") == 2 * WORLD for s in applies)
        assert r["native"] == 0
        assert "slab triangles native" not in r["untraced"]["counts"]


def test_one_card_path_records_none_of_them():
    from bemstokes_tpu_torch.utils import timers

    prob = problem()
    timers.reset()
    try:
        with torch.profiler.profile(activities=CPU):
            prob.solve_frame(prob.initial_euler(), torch.zeros(3 * prob.n, dtype=torch.float64))
        assert any(s.name == "GMRES" for s in timers.spans)
        assert not [s.name for s in timers.spans if s.name in NEW]
        assert not any("collectives" in s.counts or "collective bytes" in s.counts for s in timers.spans)
        assert "collectives" not in timers.counts and "collective bytes" not in timers.counts
    finally:
        timers.reset()
