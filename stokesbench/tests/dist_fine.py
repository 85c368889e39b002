"""Rank 0 of `sphere_fine-dist4`'s small twin (create_sphere(2), 98 nodes)
run as a cell over W CPU ranks in a gloo group, judged by the streamed
reference, for the tests of the cell (`test_stokesbench_dist4.py`):

    python3 -m stokesbench.tests.dist_fine [--world W] [--trace 0|1] [--fault exchange]

prints the result line as the last line of standard output.  `--fault
exchange` plants `exchange_left_out` on every rank."""

import argparse
import json
import sys

from .twins import SEED

CELL = "sphere_fine-dist4"
GEOMETRY = dict(refinements=2)


def bench(world):
    """BENCHMARK.json with the cell on `world` ranks."""
    from stokesbench import harness

    b = harness.load_json(harness.ROOT / "BENCHMARK.json")
    for w in b["workloads"]:
        if w["name"] == CELL:
            w["chips"] = world
    return b


def exchange_left_out(loop):
    """Rank 0's products with the slab operators keep the rows of its own
    slab and zeros in place of the other ranks' rows: the exchange between
    the ranks left out of its sharded matvec.  Its all-gather still runs, so
    no rank waits for another."""
    import torch.distributed as dist

    from bemstokes_tpu_torch.parallel import sharded, solve

    if dist.get_rank() != 0:
        return

    def own_rows_only(A_loc, x, n_nodes, dim, mesh):
        y = sharded.slab_to_flat(sharded.sharded_matvec(A_loc, x, mesh), n_nodes, dim, mesh).reshape(dim, n_nodes)
        _, nloc = sharded.padded_rows(n_nodes, mesh)
        own = y.new_zeros(y.shape)
        own[:, mesh.rank * nloc : (mesh.rank + 1) * nloc] = y[:, mesh.rank * nloc : (mesh.rank + 1) * nloc]
        return own.reshape(-1)

    solve._slab_product = own_rows_only


FAULTS = {"exchange": exchange_left_out}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--fault", choices=sorted(FAULTS))
    args = ap.parse_args()
    import torch

    torch.set_num_threads(1)
    from stokesbench import harness
    from stokesbench.tests import dist_fine

    out = harness.run_cell(CELL, SEED, 0.0, args.trace, device="cpu", geometry_overrides=GEOMETRY,
                           bench=bench(args.world), fault=dist_fine.FAULTS.get(args.fault))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
