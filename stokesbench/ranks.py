"""A cell over W > 1 cards of one host: one process a card, as the port's
distributed frame step runs (`bemstokes_tpu_torch/parallel/`).

The process the benchmark was started in is rank 0.  `Ranks` starts
ranks 1..W-1 as child processes (`python3 -m stokesbench.ranks SPEC`) with
torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
127.0.0.1 and a free MASTER_PORT that rank 0 picks) and the spec of the run
in a JSON file; every rank then joins the process group through the
program's own `parallel.initialize_multihost()`, with a collective
timeout of `COLLECTIVE_TIMEOUT_S`, and runs the same inputs, warm-up and
window frames (`harness.measure`).  `Group.frame_done` ends each window
frame with one small all-reduce, which waits for every rank's card and
carries rank 0's decision to stop, so the frames are paced by the slowest
rank and every rank stops at the same frame.

Rank 0 watches its children from a thread: if one exits with an error, or
is still running `JOIN_S` seconds after rank 0 has closed its window, rank
0 writes each child's last log lines to standard error, kills the rest and
exits with 1, printing no result.  A rank that hangs without exiting
fails the group's next collective after `COLLECTIVE_TIMEOUT_S`: gloo
raises (and rank 0 exits with 1 as above), NCCL's watchdog aborts the
process.  A child whose parent has gone exits.  Each child reports the
modules of JAX or the JAX package it holds once its window has closed, and
rank 0 prints no result if one holds any."""

from __future__ import annotations

import contextlib
import datetime
import functools
import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
#: seconds a collective waits for a rank before it fails
COLLECTIVE_TIMEOUT_S = 120
#: seconds rank 0 waits for its children to exit once its window has closed
JOIN_S = 120
POLL_S = 0.2
TAIL_LINES = 40


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def collective_timeout():
    """`torch.distributed.init_process_group` with the benchmark's
    collective timeout, for the program's `initialize_multihost`, which
    passes none."""
    import torch.distributed as dist

    inner = dist.init_process_group
    dist.init_process_group = functools.partial(inner, timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        yield
    finally:
        dist.init_process_group = inner


def fault_name(fault):
    """A fault as the children import it: "module:qualified name"."""
    return None if fault is None else f"{fault.__module__}:{fault.__qualname__}"


def fault_of(name):
    if name is None:
        return None
    module, attr = name.split(":")
    return functools.reduce(getattr, attr.split("."), importlib.import_module(module))


class Group:
    """This process's rank in the cell's process group, on `device` ("cpu":
    gloo, for the harness's own tests; a card: NCCL)."""

    def __init__(self, rank, world, device):
        import torch

        self.rank, self.world = rank, world
        self.device = torch.device("cpu") if torch.device(device).type == "cpu" else torch.device(
            "cuda", torch.cuda.current_device())

    @classmethod
    def join(cls, world, device, port=None):
        """Join the group through the program's `initialize_multihost`: rank
        0 with the address it picked (`port`), a child from its environment."""
        from bemstokes_tpu_torch.parallel import initialize_multihost

        cpu = {"device": "cpu"} if str(device) == "cpu" else {}
        with collective_timeout():
            if port is None:
                initialize_multihost(**cpu)
            else:
                initialize_multihost(f"127.0.0.1:{port}", world, 0, 0, **cpu)
        import torch.distributed as dist

        return cls(dist.get_rank(), world, device)

    def _all_reduce_max(self, values):
        import torch
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        # `cpu()` waits for the card without the interpreter lock, so rank 0's
        # watchdog can end the process while this rank waits for a dead one
        return t.cpu().tolist()

    def barrier(self):
        """Wait until every rank is here (an all-reduce, which NCCL runs on
        the card like the window's)."""
        self._all_reduce_max([0.0])

    def frame_done(self, frame, stop):
        """One all-reduce after window frame `frame`: it returns once every
        rank has finished the frame, with rank 0's `stop`.  Raises if the
        ranks ran different frames."""
        done, hi, neg_lo = self._all_reduce_max([float(stop and self.rank == 0), float(frame), -float(frame)])
        if hi != frame or -neg_lo != frame:
            raise RuntimeError(f"rank {self.rank}: the ranks ran frames {-neg_lo:.0f} to {hi:.0f}, not all {frame}")
        return done > 0

    def gather(self, values):
        """Every rank's `values` (a short list of numbers), in rank order."""
        import torch
        import torch.distributed as dist

        t = torch.tensor(values, dtype=torch.float64, device=self.device)
        out = [torch.empty_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        return [o.cpu().tolist() for o in out]

    def close(self):
        import torch.distributed as dist

        dist.destroy_process_group()


class Ranks:
    """Ranks 1..W-1 of one run, started and watched by rank 0.  Each writes
    its log, and its work directory, under `folder` (rank 0's work
    directory)."""

    def __init__(self, world, spec, folder):
        self.world = world
        self.folder = Path(folder)
        self.port = free_port()
        spec_path = self.folder / "ranks.json"
        spec_path.write_text(json.dumps(spec))
        self.logs = [self.folder / f"rank{r}.log" for r in range(1, world)]
        self.procs = []
        self._joined = threading.Event()
        try:
            for r, log in zip(range(1, world), self.logs):
                env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(self.port))
                with open(log, "w") as out:
                    self.procs.append(subprocess.Popen(
                        [sys.executable, "-m", "stokesbench.ranks", str(spec_path)],
                        cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                    ))
        except BaseException:
            self.kill()
            raise
        self._watch = threading.Thread(target=self._watchdog, name="stokesbench-ranks", daemon=True)
        self._watch.start()

    def _watchdog(self):
        while not self._joined.wait(POLL_S):
            for r, p in enumerate(self.procs, 1):
                if p.poll() not in (None, 0):
                    self.fail(f"rank {r} exited with {p.returncode}")

    def tails(self):
        """Each child's last log lines."""
        out = []
        for r, log in enumerate(self.logs, 1):
            try:
                lines = log.read_text(errors="replace").splitlines()[-TAIL_LINES:]
            except OSError:
                lines = ["(no log)"]
            out.append(f"--- rank {r}, last {len(lines)} lines of its log ---\n" + "\n".join(lines))
        return "\n".join(out)

    def kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()

    def report(self, why):
        """Write `why` and the children's last log lines to standard error."""
        print(f"stokesbench: {why}; ending every rank\n{self.tails()}", file=sys.stderr, flush=True)

    def fail(self, why):
        """Kill the children, `report` why, remove rank 0's work directory
        and end this process with 1."""
        try:
            self.kill()
            self.report(why)
            shutil.rmtree(self.folder, ignore_errors=True)
        finally:
            os._exit(1)

    def join(self):
        """Wait for every child to exit with 0 (rank 0's window has closed)."""
        deadline = time.monotonic() + JOIN_S
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.fail(f"rank {r} still running {JOIN_S} s after rank 0's window closed")
        self._joined.set()
        self._watch.join()
        for r, p in enumerate(self.procs, 1):
            if p.returncode != 0:
                self.fail(f"rank {r} exited with {p.returncode}")
        return [json.loads((self.folder / f"rank{r}" / "rank.json").read_text()) for r in range(1, self.world)]

    def status(self):
        return ", ".join(f"rank {r} " + ("running" if p.poll() is None else f"exited with {p.returncode}")
                         for r, p in enumerate(self.procs, 1))

    def close(self):
        """Stop watching and kill any child still running; where rank 0 has
        not joined them (it failed itself, and its traceback follows), write
        their state and logs to standard error."""
        if not self._joined.is_set():
            self.report(f"rank 0 failed ({self.status()})")
        self._joined.set()
        self.kill()


def _exit_with_parent():
    parent = os.getppid()
    while True:
        time.sleep(1.0)
        if os.getppid() != parent:
            os._exit(1)


def main(spec_path):
    """Rank $RANK (> 0), started by rank 0's `Ranks` with the spec of its
    run: the same inputs, warm-up and window as rank 0 (`harness.measure`),
    no trace and no check.  Writes what rank 0 reads of it, with the modules
    of JAX or the JAX package loaded once its window has closed, to
    `<work>/rank.json`."""
    threading.Thread(target=_exit_with_parent, name="stokesbench-parent", daemon=True).start()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    torch.set_num_threads(1)
    from stokesbench import harness

    spec = json.loads(Path(spec_path).read_text())
    work = Path(spec["folder"]) / f"rank{os.environ['RANK']}"
    cell = harness.Cell.find(spec["name"], spec["bench"])
    group = Group.join(cell.entry["chips"], spec["device"])
    w = harness.measure(cell, spec["seed"], spec["seconds"], 0, spec["device"], work, spec["problem_overrides"],
                        spec["geometry_overrides"], fault_of(spec["fault"]), time.perf_counter(), group)
    out = dict(rank=group.rank, frames=w.frames, forbidden=harness.forbidden_modules())
    (work / "rank.json").write_text(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
