#!/usr/bin/env python3
"""The distributed slab LU apply (`parallel/lu.py:slab_lu_solve`) over W
ranks, one process a card, at `sphere_fine-dist4`'s slab: m rows a rank of a
seeded well-conditioned [W m, W m] system, factored by `slab_lu_factor`.

    python3 -m torch.distributed.run --nproc_per_node 4 --master_addr 127.0.0.1 \\
        --master_port 29517 scripts/torch_slab_lu_apply.py [--m 18435] [--device cuda|cpu]
        [--applies 20] [--out FILE]

Each rank compares the apply with the factor's kernel plan (each of its
triangles through `csrc/lu_trsv.cu`'s row-major instantiation, in place)
against the apply with no plan (`solve_triangular` on the strided block: a
copy of the block, then cuBLAS trsv) on the same factors: the relative
difference (max |x - x_ref| / max |x_ref|), the same bits twice, the wall
time of an apply with every rank synchronised (`--applies` applies after a
warm-up, each route twice, alternating), and over three applies of each
route under `torch.profiler` the "Slab LU apply" spans, their attributes and
counters (`slab triangles native`, `collectives`, `collective bytes`) and
the rank's largest device kernels.  `--device cpu` runs the same over gloo,
where there is no plan.  Rank 0 prints one JSON line a rank, also written to
`--out`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from bemstokes_tpu_torch.parallel.lu import slab_lu_factor, slab_lu_solve  # noqa: E402
from bemstokes_tpu_torch.parallel.multihost import initialize_multihost  # noqa: E402
from bemstokes_tpu_torch.parallel.sharded import row_mesh  # noqa: E402
from bemstokes_tpu_torch.utils import timers  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--m", type=int, default=18435, help="rows a rank")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--applies", type=int, default=20)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    cpu = args.device == "cpu"
    initialize_multihost(device="cpu" if cpu else None)
    mesh = row_mesh(device="cpu" if cpu else None)
    W, rank, dev, m = mesh.world, mesh.rank, mesh.device, args.m
    cuda = dev.type == "cuda"
    g = torch.Generator(device=dev).manual_seed(1000 + rank)
    A = torch.randn(m, W * m, generator=g, dtype=torch.float64, device=dev).div_((W * m) ** 0.5)
    A[:, rank * m : (rank + 1) * m].diagonal().add_(4.0)
    b = torch.randn(m, generator=g, dtype=torch.float64, device=dev)

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)
        dist.barrier()

    t0 = time.perf_counter()
    LU, perm, plan = slab_lu_factor(A, mesh)
    del A
    sync()
    out = dict(
        rank=rank,
        world=W,
        m=m,
        device=torch.cuda.get_device_name(dev) if cuda else "cpu",
        factor_s=time.perf_counter() - t0,
        plan=plan is not None,
        plan_ld=plan.ld if plan else None,
        plan_row_major=plan.row_major if plan else None,
    )
    x_new, x_old = slab_lu_solve(LU, perm, b, mesh, plan), slab_lu_solve(LU, perm, b, mesh, None)
    out["rel_diff"] = float((x_new - x_old).abs().max() / x_old.abs().max())
    out["same_bits_twice"] = bool(torch.equal(slab_lu_solve(LU, perm, b, mesh, plan), x_new))

    def apply_ms(p):
        for _ in range(3):
            slab_lu_solve(LU, perm, b, mesh, p)
        sync()
        t = time.perf_counter()
        for _ in range(args.applies):
            slab_lu_solve(LU, perm, b, mesh, p)
        sync()
        return (time.perf_counter() - t) / args.applies * 1e3

    out["kernel_route_ms"], out["replaced_route_ms"] = [], []
    for _ in range(2):
        out["kernel_route_ms"].append(apply_ms(plan))
        out["replaced_route_ms"].append(apply_ms(None))

    def traced(p, calls=3):
        acts = [torch.profiler.ProfilerActivity.CPU] + ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        timers.reset()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                slab_lu_solve(LU, perm, b, mesh, p)
            sync()
        spans = [s for s in timers.spans if s.name == "Slab LU apply"]
        kernels = {}
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", 0) or 0
            if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                kernels[e.key[:80]] = [e.count / calls, round(us / 1e3 / calls, 4)]
        return dict(
            spans=len(spans),
            attrs=[dict(s.attrs) for s in spans][:1],
            span_counts=[dict(s.counts) for s in spans],
            native=timers.counts.get("slab triangles native", 0),
            kernels=dict(sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]),
        )

    out["kernel_route"] = traced(plan)
    out["replaced_route"] = traced(None)
    out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9 if cuda else None
    rows = [None] * W
    dist.all_gather_object(rows, out)
    if rank == 0:
        text = "\n".join(json.dumps(r) for r in rows) + "\n"
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(text)
        print(text, end="", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
