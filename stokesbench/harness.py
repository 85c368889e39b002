"""One run of one cell: the inputs from the seed, set-up and warm-up, the
measured window of frames, the traced reading of the layers, the check of
the window's frames against the plain reference, and the result line.  A
cell whose `chips` is W > 1 runs one process a card (`ranks.py`), each rank
through `measure`; this process is rank 0, which alone traces and checks.

Everything a cell needs is found by name: `BENCHMARK.json` names the cell's
configuration, traffic mix and metrics; `configs/<config>.json`,
`traffic/<mix>.json`, `limits/<cell>.json` and `metrics/<metric>.py` hold
them; the plain reference (`reference/`) reads the configuration's file.  A later cell, mix or metric is a new
file and a new entry, and no edit here."""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that must not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "bemstokes_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def merge(base, over):
    """`over` laid onto `base`, nested dicts merged key by key."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


@dataclasses.dataclass
class Cell:
    """A cell of BENCHMARK.json with its configuration, mix, limits and the
    metrics it reports, as found by name."""

    name: str
    entry: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list

    @classmethod
    def find(cls, name, bench=None):
        bench = bench or load_json(ROOT / "BENCHMARK.json")
        entry = next((w for w in bench["workloads"] if w["name"] == name), None)
        if entry is None:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")

        def reported(metrics):
            return [m for m in metrics if "workloads" not in m or name in m["workloads"]]

        return cls(
            name=name,
            entry=entry,
            config=load_json(HERE / "configs" / f"{entry['config']}.json"),
            traffic=load_json(HERE / "traffic" / f"{entry['traffic']}.json"),
            limits=load_json(HERE / "limits" / f"{name}.json"),
            end_to_end=reported(bench["end_to_end"]),
            per_layer=reported(bench["per_layer"]),
        )


@dataclasses.dataclass
class Record:
    """What a run measured, for the metric readers (`metrics/<name>.py`)."""

    cell: Cell
    setup_s: float
    frame_seconds: list
    window_s: float
    peak_bytes: int
    spans: object = None
    trace: dict | None = None


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card_line():
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


class Loop:
    """The program's frame loop of one cell at one seed: inputs written under
    `work`, SwimmerSimulation set up on `device`, frames run one at a time."""

    def __init__(self, cell, seed, work, device, problem_overrides=None, geometry_overrides=None):
        from bemstokes_tpu_torch.config import from_dict
        from bemstokes_tpu_torch.swimmer import SwimmerSimulation

        from . import gen

        self.work = Path(work)
        grids, self.out = self.work / "grids", self.work / "out"
        grids.mkdir(parents=True)
        geometry = merge(cell.config["geometry"], geometry_overrides or {})
        problem = merge(cell.config["problem"], cell.traffic["problem"])
        problem = merge(problem, problem_overrides or {})
        problem["input_grid_path"] = str(grids) + os.sep
        t0 = time.perf_counter()
        gen.write_inputs(grids, problem["input_grid_base_name"], geometry, seed)
        self.inputs_s = time.perf_counter() - t0
        self.problem = problem
        self.frame = seed % problem["n_frames"] if cell.traffic.get("start_frame_from_seed") else 0
        self.first = self.frame
        self.log = open(self.work / "program.log", "w")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(self.log):
            self.sim = SwimmerSimulation(from_dict(problem), str(self.out), device=device)
        self.init_s = time.perf_counter() - t0
        self.cuda = self.sim.device.type == "cuda"

    def step(self):
        """Run the next frame; returns its frame number."""
        k = self.frame
        with contextlib.redirect_stdout(self.log):
            self.sim.run(k, k + 1)
        if self.cuda:
            import torch

            torch.cuda.synchronize()
        self.frame += 1
        return k

    def outputs(self, k):
        """The program's outputs of frame k and the state it carried in."""
        if k == self.first:
            raise ValueError("the loop's first frame is a warm-up frame and is not checked")
        before = np.load(self.out / f"state_{k - 1}.npz")
        rot, disp = before["rotation"], before["displacements"]
        res = np.load(self.out / f"result_{k}.npz")
        after = np.load(self.out / f"state_{k}.npz")
        h = next(e for e in self.history if e["frame"] == k)
        cand = dict(
            euler=res["euler"],
            forces=res["stokes_forces"],
            velocities=res["rigid_velocities"],
            rotation=after["rotation"],
            displacements=after["displacements"],
        )
        if "flagellum_omega" in h:
            cand["omega"] = h["flagellum_omega"]
        return rot, disp, cand

    def close(self):
        """Free the program's state (its LU factors, operators, tables)."""
        self.history = list(self.sim.history)
        del self.sim
        gc.collect()
        if self.cuda:
            import torch

            torch.cuda.empty_cache()
        self.log.close()


def pick_frames(frames, iterations, count, seed):
    """The frames to check: the one whose solve took the most iterations,
    then others drawn from the seed."""
    if not frames:
        return []
    first = frames[int(np.argmax(iterations))]
    rest = [f for f in frames if f != first]
    rng = np.random.default_rng(seed)
    extra = rng.choice(rest, size=min(count - 1, len(rest)), replace=False).tolist() if rest and count > 1 else []
    return [first] + sorted(int(f) for f in extra)


def reference_module(cell):
    """The module of `reference/` that judges the cell's frames: the
    configuration's `reference` (default `loop`)."""
    return importlib.import_module(f".reference.{cell.config.get('reference', 'loop')}", __package__)


def check(loop, cell, frames, device, control=False):
    """({number: worst gap over `frames`} of the program's frames against the
    float64 plain reference, and the same of the control, or None unless
    `control`).  The numbers are those the configuration's reference module
    (`reference_module`) judges, and its control is that module's."""
    import torch

    ref_mod = reference_module(cell)
    ref = ref_mod.Reference(loop.problem, dtype=torch.float64, device=device)
    ctl = ref_mod.Control(loop.problem, device) if control else None
    worst, worst_ctl = {}, {} if control else None
    for k in frames:
        rot, disp, cand = loop.outputs(k)
        exp = ref_mod.expected(ref, k, rot, disp)
        for n, g in ref_mod.judge(ref, exp, rot, disp, cand).items():
            worst[n] = max(worst.get(n, 0.0), g)
        if control:
            for n, g in ref_mod.judge(ref, exp, rot, disp, ctl.candidate(k, rot, disp, cand)).items():
                worst_ctl[n] = max(worst_ctl.get(n, 0.0), g)
    return worst, worst_ctl


@dataclasses.dataclass
class Window:
    """What `measure` gives of one run: the (closed) loop, the metric
    readers' `Record`, the warm-up's seconds, the window's frames and their
    GMRES iterations, and every rank's peak allocated bytes."""

    loop: Loop
    rec: Record
    warmup_s: float
    frames: list
    iterations: list
    peaks: list


def measure(cell, seed, seconds, trace, device, work, problem_overrides=None, geometry_overrides=None,
            fault=None, t_start=None, group=None):
    """Set-up, warm-up and the measured window of one run (a `Window`), on
    each rank of a cell over several cards (`group`, a `ranks.Group`, which
    it closes once the window has closed, or None on one card); the program
    is freed at the end."""
    import torch

    cuda = torch.device(device).type == "cuda"
    loop = Loop(cell, seed, work, device, problem_overrides, geometry_overrides)
    if fault is not None:
        fault(loop)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t_warm = time.perf_counter()
    for _ in range(cell.traffic["warmup_frames"]):
        loop.step()
    warmup_s = time.perf_counter() - t_warm
    spans = prof = None
    if trace:
        from . import spans as spans_mod

        spans = spans_mod.install(loop.sim, cuda)
        activities = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    if group is not None:
        group.barrier()
    setup_s = time.perf_counter() - t_start
    frames, seconds_of, iterations = [], [], []
    window = torch.profiler.record_function("stokesbench.window") if trace else contextlib.nullcontext()
    with window:
        t0 = time.perf_counter()
        while True:
            ts = time.perf_counter()
            k = loop.step()
            te = time.perf_counter()
            stop = te - t0 >= seconds
            if group is not None:
                stop = group.frame_done(k, stop)
                te = time.perf_counter()
            frames.append(k)
            seconds_of.append(te - ts)
            iterations.append(loop.sim.history[-1]["iterations"])
            if stop:
                break
    window_s = te - t0
    peaks = [torch.cuda.max_memory_allocated() if cuda else 0]
    if group is not None:
        # the group's last collective, before rank 0 stops its profiler and
        # reduces the trace, which the other ranks need not wait for
        peaks = [int(p) for p, in group.gather(peaks)]
        group.close()
    reduced = None
    if trace:
        prof.__exit__(None, None, None)
        from . import trace as trace_mod

        t_reduce = time.perf_counter()
        reduced = trace_mod.reduce(trace_mod.raw_events(prof))
        reduced["reduce_s"] = time.perf_counter() - t_reduce
        del prof
        spans.restore()
    rec = Record(cell, setup_s, seconds_of, window_s, max(peaks), spans, reduced)
    loop.close()
    return Window(loop, rec, warmup_s, frames, iterations, peaks)


def run_cell(name, seed, seconds, trace, device="cuda", problem_overrides=None, geometry_overrides=None,
             t_start=None, bench=None, fault=None, control=False):
    """One run of cell `name`; returns the result dict (the last line).
    `fault(loop)`, for the harness's own tests, breaks the program's timed
    path before the warm-up (on every rank: a fault of a cell over several
    cards is a module-level function, which the other ranks import by
    name).  With `control` the result also holds the control's gaps
    (`check`), for `calibrate.py`; the benchmark's runs never set it.

    A cell with `chips` W > 1 runs on W cards, one process a card
    (`ranks.py`): this process is rank 0, the only one that traces, checks
    and returns a result."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell.find(name, bench)
    cuda = torch.device(device).type == "cuda"
    tmp = os.environ.get("TMPDIR") or tempfile.gettempdir()
    work = tempfile.mkdtemp(prefix="stokesbench-", dir=tmp)
    world, children, group = cell.entry["chips"], None, None
    try:
        if world > 1:
            from . import ranks

            if not cell.traffic["problem"].get("distributed"):
                raise SystemExit(f"{name}: a cell on {world} cards needs a mix with `distributed` set")
            spec = dict(name=name, seed=seed, seconds=seconds, device=str(device), problem_overrides=problem_overrides,
                        geometry_overrides=geometry_overrides, bench=bench, fault=ranks.fault_name(fault), folder=work)
            children = ranks.Ranks(world, spec, work)
            group = ranks.Group.join(world, device, children.port)
        w = measure(cell, seed, seconds, trace, device, Path(work) / "rank0" if group else work, problem_overrides,
                    geometry_overrides, fault, t_start, group)
        if group is not None:
            others = children.join()
            found = {o["rank"]: o["forbidden"] for o in others if o["forbidden"]}
            if found:
                raise SystemExit(f"stokesbench: modules of JAX or the JAX package were loaded on rank(s) {found}")
        loop, rec, frames, iterations = w.loop, w.rec, w.frames, w.iterations
        max_steps = loop.problem["solver"].get("max_steps", 1000)
        failed = sum(1 for i in iterations if i >= max_steps)
        reduced, spans, peak = rec.trace, rec.spans, rec.peak_bytes

        checked = pick_frames(frames, iterations, cell.traffic["check_frames"], seed)
        t_ref = time.perf_counter()
        gaps, gaps_ctl = check(loop, cell, checked, device, control)
        reference_s = time.perf_counter() - t_ref
        # every number the cell's limits name is compared; one the reference
        # gives no reading of fails
        checks = {n: dict(value=gaps.get(n), limit=limit) for n, limit in cell.limits.items()}
        correct = bool(checked) and all(c["value"] is not None and c["value"] <= c["limit"]
                                        for c in checks.values())

        metrics = {}
        for m in cell.per_layer if trace else cell.end_to_end:
            value = importlib.import_module(f"stokesbench.metrics.{m['name']}").read(rec)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
        dev = dict(
            platform="gpu" if cuda else "cpu",
            kind=torch.cuda.get_device_name(0) if cuda else "cpu",
            count=world,
            memory_peak_bytes=int(peak),
            card=card_line() if cuda else "cpu",
            torch=torch.__version__,
        )
        result = dict(correct=correct, attempted=len(frames), failed=failed, metrics=metrics, device=dev)
        if reduced is not None:
            dev.update(busy_s=reduced["busy_s"], window_s=reduced["window_s"])
            result["breakdown"] = dict(device_ops=reduced["device_ops"], idle_gaps=reduced["idle_gaps"])
        result["timings"] = dict(
            inputs_s=loop.inputs_s,
            init_s=loop.init_s,
            warmup_s=w.warmup_s,
            reference_s=reference_s,
            trace_reduce_s=reduced["reduce_s"] if reduced else None,
            frames=len(frames),
            frame_quartiles=[float(q) for q in np.percentile(rec.frame_seconds, [0, 25, 50, 75, 100])],
        )
        if reduced is not None:
            traced = [s for s in spans.records if s.info and "call" in s.info]
            result["timings"]["traced_calls"] = dict(
                calls=len(traced), with_device_time=sum(f"{s.name}#{s.info['call']}" in reduced["span_device_s"]
                                                        for s in traced))
        if group is not None:
            result["timings"]["ranks"] = [dict(rank=0, frames=frames, peak_bytes=w.peaks[0])] + [
                dict(rank=o["rank"], frames=o["frames"], peak_bytes=p) for o, p in zip(others, w.peaks[1:])]
        result["checked_frames"] = checked
        if control:
            result["control"] = gaps_ctl
        result["checks"] = checks
        return result
    finally:
        if children is not None:
            children.close()
        shutil.rmtree(work, ignore_errors=True)

