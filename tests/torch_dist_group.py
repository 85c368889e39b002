"""Process groups for the distributed tests of the torch port
(tests/test_torch_parallel_*.py): W child processes, one per rank, on the
CPU, started and joined with a deadline.

`Group(module, fn, world, folder, **kwargs)` starts W processes that each
join a gloo group through a FileStore in `folder` (no network, no port to
collide with other test workers), call `module.fn(mesh, **kwargs)` with
their `parallel.row_mesh` and save what it returns with `torch.save`.
`Group.results()` waits for them (up to DEADLINE seconds after they were
started), kills any still running, and returns the W results in rank order,
or fails with the tail of each rank's log.  A collective that waits for a
rank that never comes raises in the child after COLLECTIVE_TIMEOUT seconds,
so a deadlock fails within about a minute; the deadline, which a loaded
test machine must not reach, only bounds a child that hangs elsewhere.

`Group.command(argv, world, folder, env)` starts W copies of a command
with torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) instead.

The child imports torch, the port and the test module named; test modules
that hold child functions import JAX only inside the parent's functions.
"""

from __future__ import annotations

import datetime
import importlib
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
DEADLINE = 180.0
COLLECTIVE_TIMEOUT = 60.0


def _env(extra=None):
    path = [str(ROOT), str(TESTS)]
    if os.environ.get("PYTHONPATH"):
        path.append(os.environ["PYTHONPATH"])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(path), OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.update(extra or {})
    return env


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Group:
    def __init__(self, module, fn, world, folder, **kwargs):
        spec = dict(module=module, fn=fn, world=world, folder=str(folder), kwargs=kwargs)
        code = "import torch_dist_group; torch_dist_group.child()"
        argvs = [[sys.executable, "-c", code, json.dumps(spec), str(rank)] for rank in range(world)]
        self._start(argvs, [None] * world, folder)

    @classmethod
    def command(cls, argv, world, folder, env=None):
        self = cls.__new__(cls)
        port = str(free_port())
        envs = [
            dict(
                env or {},
                RANK=str(r),
                LOCAL_RANK=str(r),
                WORLD_SIZE=str(world),
                MASTER_ADDR="localhost",
                MASTER_PORT=port,
            )
            for r in range(world)
        ]
        self._start([list(argv)] * world, envs, folder)
        return self

    def _start(self, argvs, envs, folder):
        self.folder = Path(folder)
        self.folder.mkdir(parents=True, exist_ok=True)
        self.world = len(argvs)
        self.t0 = time.monotonic()
        self.logs = [self.folder / f"rank{r}.log" for r in range(self.world)]
        self.procs = []
        for r, (argv, env) in enumerate(zip(argvs, envs)):
            with open(self.logs[r], "w") as log:
                self.procs.append(
                    subprocess.Popen(argv, cwd=ROOT, env=_env(env), stdout=log, stderr=subprocess.STDOUT)
                )

    def wait(self):
        """Join the ranks; fail if one is still running at the deadline or
        exits with an error.  Returns each rank's log."""
        for p in self.procs:
            try:
                p.wait(timeout=max(1.0, DEADLINE - (time.monotonic() - self.t0)))
            except subprocess.TimeoutExpired:
                break
        hung = [r for r, p in enumerate(self.procs) if p.poll() is None]
        for r in hung:
            self.procs[r].kill()
            self.procs[r].wait()
        logs = [path.read_text() for path in self.logs]
        failed = [r for r, p in enumerate(self.procs) if p.returncode]
        if hung or failed:
            tails = "\n".join(f"--- rank {r} ---\n{log[-3000:]}" for r, log in enumerate(logs))
            raise AssertionError(f"ranks {hung} still running after {DEADLINE} s, ranks {failed} failed\n{tails}")
        return logs

    def results(self):
        self.wait()
        return [torch.load(self.folder / f"rank{r}.pt", weights_only=False) for r in range(self.world)]


def child():
    spec = json.loads(sys.argv[1])
    rank = int(sys.argv[2])
    torch.set_num_threads(1)
    import torch.distributed as dist

    from bemstokes_tpu_torch.parallel import row_mesh

    dist.init_process_group(
        "gloo",
        store=dist.FileStore(os.path.join(spec["folder"], "store"), spec["world"]),
        rank=rank,
        world_size=spec["world"],
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT),
    )
    fn = getattr(importlib.import_module(spec["module"]), spec["fn"])
    out = fn(row_mesh(device="cpu"), **spec["kwargs"])
    torch.save(out, os.path.join(spec["folder"], f"rank{rank}.pt"))
    dist.destroy_process_group()
