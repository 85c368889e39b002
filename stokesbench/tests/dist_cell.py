"""Rank 0 of `sphere_wall-loop`'s small twin (create_sphere(2)) run as a
cell over two CPU ranks in a gloo group, through the mix `loop_direct_dist`,
for the tests of a cell over several cards (`ranks.py`):

    python3 -m stokesbench.tests.dist_cell [--world W] [--fault exit|hang|jax]

prints the result line as the last line of standard output.  `--fault`
plants one of `FAULTS` on rank 1: it exits with 3 at its second frame, or
sleeps for ever at its second frame, or holds a module named `jax` once its
window has closed."""

import argparse
import json
import os
import sys
import time
import types

CELL = "sphere_wall-loop"


def bench(world):
    """BENCHMARK.json with the cell on `world` ranks under `loop_direct_dist`."""
    from stokesbench import harness

    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in b["workloads"]:
        if w["name"] == CELL:
            w.update(traffic="loop_direct_dist", chips=world)
    return b


def exit_at_second_frame(loop):
    """Rank 1 exits with 3 when its loop starts its second frame."""
    import torch.distributed as dist

    if dist.get_rank() != 1:
        return
    inner = loop.step

    def step():
        if loop.frame > loop.first:
            os._exit(3)
        return inner()

    loop.step = step


def hang_at_second_frame(loop):
    """Rank 1 sleeps for ever, without exiting, when its loop starts its
    second frame."""
    import torch.distributed as dist

    if dist.get_rank() != 1:
        return
    inner = loop.step

    def step():
        while loop.frame > loop.first:
            time.sleep(60.0)
        return inner()

    loop.step = step


def jax_after_window(loop):
    """Rank 1 holds a module named `jax` once its program is freed."""
    import torch.distributed as dist

    if dist.get_rank() != 1:
        return
    inner = loop.close

    def close():
        inner()
        sys.modules["jax"] = types.ModuleType("jax")

    loop.close = close


FAULTS = {"exit": exit_at_second_frame, "hang": hang_at_second_frame, "jax": jax_after_window}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args()
    import torch

    torch.set_num_threads(1)
    from stokesbench import harness
    from stokesbench.tests import dist_cell

    from .twins import SEED, TWINS

    geometry, problem = TWINS[CELL]
    out = harness.run_cell(CELL, SEED, 0.0, 0, device="cpu", problem_overrides=problem, geometry_overrides=geometry,
                           bench=bench(args.world), fault=dist_cell.FAULTS.get(args.fault))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
