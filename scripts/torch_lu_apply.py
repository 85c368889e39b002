#!/usr/bin/env python3
"""The stale-LU preconditioner's apply on the card: the kernel of
`csrc/lu_trsv.cu` against `torch.linalg.solve_triangular` and `lu_solve`.

    python3 scripts/torch_lu_apply.py [--sizes 23101,18444] [--dtypes f64,f32]
                                      [--route both|kernel|solve_triangular]
                                      [--applies 20] [--frames 3]
                                      [--blocks 8] [--block-size 3072]
                                      [--slab 18435] [--slab-ranks 4]
                                      [--root DIR] [--out FILE]

For each size and factor dtype it factors a seeded nonsymmetric n x n matrix
on the card with `LUPreconditioner.set_up` (float64, cast to float32 for an
f32 factor, as `factor_dtype` does) and, for one right-hand side at a time
(rows of a [k, n] tensor, as GMRES passes them), for each route: the kernel
(`ops.lu_trsv`, the preconditioner's plan) and `solve_triangular` (the
gather and the two solves, `la.direct.lu_apply`).  It reports
each triangle's ms (CUDA events, `--applies` calls after a warm-up) beside
its bytes bound (n^2 / 2 values read at 3.35 TB/s) and their share, the
whole apply's ms, the relative difference from `torch.linalg.lu_solve`
(max |x - x_ref| / max |x_ref|; `solve_triangular` gives its bits), whether
the apply or the plan's preparation makes a host sync
(`torch.cuda.set_sync_debug_mode("error")`), the SM clock sampled by
`nvidia-smi` while the kernel runs (`torch_sass_count.py`'s sampler), and
each route's device kernels over 5 applies (`torch.profiler`).  The
kernel's build prints its registers, shared memory and spills first.

With `--frames F` > 0 it then runs F frames of chip_smoke.py's bacterium
loop (23,101 unknowns, the stale LU refactored past 100 iterations) with
every apply held against `lu_solve` of the factors it holds, and reports the
applies, the largest relative difference and the counters `lu
permutations`, `lu applies`, `lu applies native`.  `--root` imports
bemstokes_tpu_torch and chip_smoke.py from another checkout (an older
tree's apply is timed the same way; `--route solve_triangular` there).  With
`--blocks B` > 0 it factors a batch of B seeded `--block-size` blocks (the
matrix-free block-Jacobi's 8 x 3,072 at the bacterium's width), which the
kernel does not take, and for one and for seven columns compares
`la.direct.lu_apply` with the kept permutations against `lu_solve` (bits,
times, kernels).  With `--slab m` (sizes, comma-separated) it times the
distributed slab LU's triangles (`parallel/lu.py:slab_lu_solve`): a seeded
well-conditioned factor of order m as diagonal block 1 of a row-major
[m, W m] slab (W = `--slab-ranks`), and for L and U one right-hand side
[m, 1] through the kernel's row-major instantiation in place
(`TrsvPlan.solve_triangle`), the route it replaced in the same call
(`solve_triangular` on the strided block: its copy of the block and
cuBLAS trsv), cuBLAS trsv alone on a column-major copy, and the kernel's
column-major instantiation on that copy; with the bytes bound, the
relative difference from `solve_triangular`, the same bits twice, host
syncs and each route's device kernels.  Prints the card's name and power
limit first and one JSON line last, also written to `--out`.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
from torch_sass_count import ClockSampler

HBM_BYTES_PER_S = 3.35e12
DTYPES = {"f64": torch.float64, "f32": torch.float32}


def device_kernels(fn, calls=5):
    """{kernel name: (launches a call, device ms a call)} of `calls` calls."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        if e.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out[e.key[:90]] = (e.count / calls, us / 1e3 / calls)
    return dict(sorted(out.items(), key=lambda kv: -kv[1][1]))


def event_ms(fn, calls):
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def rel_diff(x, ref):
    return float((x - ref).abs().max() / ref.abs().max())


def syncs(fn):
    """Whether fn makes a host sync that torch sees."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
        return False
    except RuntimeError:
        return True
    finally:
        torch.cuda.set_sync_debug_mode("default")


def isolated(n, dtype, applies, routes, direct, lu_trsv, sampler):
    g = torch.Generator(device="cuda").manual_seed(20)
    A = torch.randn(n, n, generator=g, dtype=torch.float64, device="cuda")
    V = torch.randn(8, n, generator=g, dtype=torch.float64, device="cuda").to(dtype)
    p = direct.LUPreconditioner(factor_dtype=dtype)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.set_up(A)
    torch.cuda.synchronize()
    set_up_ms = (time.perf_counter() - t0) * 1e3
    del A
    lu, piv = p._factors
    perm = p._perm
    out = dict(n=n, dtype=str(dtype), set_up_ms=set_up_ms, layout_column_major=lu.mT.is_contiguous())
    bound_ms = n * n / 2 * lu.element_size() / HBM_BYTES_PER_S * 1e3
    out["triangle_bound_ms"] = bound_ms

    def lu_solve(j=0):
        return torch.linalg.lu_solve(lu, piv, V[j][:, None])[:, 0]

    refs = [lu_solve(j) for j in range(V.shape[0])]
    if "kernel" in routes:
        plan = p._plan
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh = lu_trsv.plan(lu)
        torch.cuda.synchronize()
        out_k = dict(plan_ms=(time.perf_counter() - t0) * 1e3, plan_syncs=syncs(lambda: lu_trsv.plan(lu)))
        del fresh
        lib = lu_trsv._library()
        x = torch.empty(n, dtype=dtype, device="cuda")

        def apply(j=0):
            return p.apply(V[j])

        def lower():
            plan._launch(lib, False, V[0], 1, perm, plan.y)

        def upper():
            plan._launch(lib, True, plan.y, 1, None, x)

        for _ in range(3):
            apply()
        out_k["rel_diff_lu_solve"] = max(rel_diff(apply(j), refs[j]) for j in range(V.shape[0]))
        out_k["same_bits_twice"] = bool(torch.equal(apply(1), apply(1)))
        out_k["apply_syncs"] = syncs(lambda: [apply(j) for j in range(V.shape[0])])
        t0 = time.perf_counter()
        out_k["lower_ms"] = [event_ms(lower, applies), event_ms(lower, applies)]
        out_k["upper_ms"] = [event_ms(upper, applies), event_ms(upper, applies)]
        out_k["apply_ms"] = [event_ms(apply, applies), event_ms(apply, applies)]
        out_k["sm_clock"] = sampler.between(t0, time.perf_counter())
        out_k["lower_share_of_bound"] = bound_ms / min(out_k["lower_ms"])
        out_k["upper_share_of_bound"] = bound_ms / min(out_k["upper_ms"])
        out_k["kernels"] = device_kernels(apply)
        out["kernel"] = out_k
    if "solve_triangular" in routes:

        def apply_st(j=0):
            return direct.lu_apply(lu, perm, V[j])

        xp = V[0][perm][:, None]
        y = torch.linalg.solve_triangular(lu, xp, upper=False, unitriangular=True)
        for _ in range(3):
            apply_st()
        out_s = dict(
            bit_for_bit_lu_solve=all(torch.equal(apply_st(j), refs[j]) for j in range(V.shape[0])),
            apply_syncs=syncs(lambda: [apply_st(j) for j in range(V.shape[0])]),
            lower_ms=[event_ms(lambda: torch.linalg.solve_triangular(lu, xp, upper=False, unitriangular=True),
                               applies)],
            upper_ms=[event_ms(lambda: torch.linalg.solve_triangular(lu, y, upper=True), applies)],
            apply_ms=[event_ms(apply_st, applies), event_ms(apply_st, applies)],
            lu_solve_ms=[event_ms(lu_solve, applies)],
            kernels=device_kernels(apply_st),
        )
        out_s["lower_share_of_bound"] = bound_ms / out_s["lower_ms"][0]
        out_s["upper_share_of_bound"] = bound_ms / out_s["upper_ms"][0]
        out["solve_triangular"] = out_s
    return out


def blocks(nb, size, applies, direct):
    g = torch.Generator(device="cuda").manual_seed(21)
    A = torch.randn(nb, size, size, generator=g, dtype=torch.float64, device="cuda")
    lu, piv = direct.lu_factor_dense(A)
    del A
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm = direct.pivots_to_permutation(piv)
    torch.cuda.synchronize()
    out = dict(blocks=nb, size=size, walk_ms=(time.perf_counter() - t0) * 1e3)
    for cols in (1, 7):
        b = torch.randn(nb, size, cols, generator=g, dtype=torch.float64, device="cuda")

        def old():
            return torch.linalg.lu_solve(lu, piv, b)

        def new():
            return direct.lu_apply(lu, perm, b)

        for _ in range(3):
            old(), new()
        x_old, x_new = old(), new()
        out[f"cols_{cols}"] = dict(
            bit_for_bit=bool(torch.equal(x_old, x_new)),
            max_rel_diff=rel_diff(x_new, x_old),
            lu_solve_ms=[event_ms(old, applies), event_ms(old, applies)],
            lu_apply_ms=[event_ms(new, applies), event_ms(new, applies)],
            lu_solve_kernels=device_kernels(old),
            lu_apply_kernels=device_kernels(new),
        )
    return out


def slab_triangles(m, dtype, ranks, applies, lu_trsv, sampler):
    g = torch.Generator(device="cuda").manual_seed(25)
    A = torch.randn(m, m, generator=g, dtype=torch.float64, device="cuda").div_(m**0.5)
    A.diagonal().add_(4.0)
    A = A[torch.randperm(m, generator=g, device="cuda")]
    lu = torch.linalg.lu_factor(A)[0]
    del A
    lu = lu.to(dtype)  # column-major, as lu_factor leaves it
    slab = torch.zeros(m, ranks * m, dtype=dtype, device="cuda")
    block = slab[:, m : 2 * m]
    block.copy_(lu)
    bound_ms = m * m / 2 * lu.element_size() / HBM_BYTES_PER_S * 1e3
    out = dict(m=m, dtype=str(dtype), ld=block.stride(0), triangle_bound_ms=bound_ms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = lu_trsv.plan(block)
    torch.cuda.synchronize()
    out.update(plan_ms=(time.perf_counter() - t0) * 1e3, plan_syncs=syncs(lambda: lu_trsv.plan(block)),
               row_major=plan.row_major)
    col = lu_trsv.plan(lu)
    b = torch.randn(m, 1, generator=g, dtype=torch.float64, device="cuda").to(dtype)
    for upper in (False, True):

        def row(upper=upper):
            return plan.solve_triangle(upper, b)

        def copied(upper=upper):
            return torch.linalg.solve_triangular(block, b, upper=upper, unitriangular=not upper).contiguous()

        def trsv(upper=upper):
            return torch.linalg.solve_triangular(lu, b, upper=upper, unitriangular=not upper)

        def column(upper=upper):
            return col.solve_triangle(upper, b)

        for _ in range(3):
            row(), copied(), trsv(), column()
        ref = copied()
        t0 = time.perf_counter()
        r = dict(
            rel_diff_solve_triangular=rel_diff(row(), ref),
            column_major_rel_diff=rel_diff(column(), ref),
            same_bits_twice=bool(torch.equal(row(), row())),
            syncs=syncs(row),
            kernel_ms=[event_ms(row, applies), event_ms(row, applies)],
            replaced_ms=[event_ms(copied, applies), event_ms(copied, applies)],
            trsv_alone_ms=[event_ms(trsv, applies)],
            column_major_ms=[event_ms(column, applies), event_ms(column, applies)],
        )
        r["sm_clock"] = sampler.between(t0, time.perf_counter())
        r["share_of_bound"] = bound_ms / min(r["kernel_ms"])
        r["column_major_share_of_bound"] = bound_ms / min(r["column_major_ms"])
        r["kernels"] = device_kernels(row)
        r["replaced_kernels"] = device_kernels(copied)
        out["U" if upper else "L"] = r
    return out


def frames(count, direct):
    import chip_smoke
    from bemstokes_tpu_torch.swimmer import SwimmerSimulation
    from bemstokes_tpu_torch.utils import timers

    seen = dict(applies=0, max_rel_diff=0.0)
    apply = direct.LUPreconditioner.apply

    def checked(self, v):
        y = apply(self, v)
        lu = self._factors[0]
        ref = torch.linalg.lu_solve(lu, self._factors[1], v.to(lu.dtype)[:, None])[:, 0].to(v.dtype)
        seen["applies"] += 1
        seen["max_rel_diff"] = max(seen["max_rel_diff"], rel_diff(y, ref))
        return y

    direct.LUPreconditioner.apply = checked
    timers.reset()
    with tempfile.TemporaryDirectory() as folder:
        chip_smoke.write_bacterium_gait(folder, *chip_smoke.GAIT_BACTERIUM, files=count + 1)
        cfg = chip_smoke.bacterium_config(f"{folder}/")
        with tempfile.TemporaryDirectory() as out:
            SwimmerSimulation(cfg, out).run(0, count)
    direct.LUPreconditioner.apply = apply
    for key in ("gmres iterations", "lu permutations", "lu applies", "lu applies native"):
        seen[key.replace(" ", "_")] = timers.counts.get(key)
    return seen


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="23101,18444")
    ap.add_argument("--dtypes", default="f64,f32")
    ap.add_argument("--route", choices=("both", "kernel", "solve_triangular"), default="both")
    ap.add_argument("--applies", type=int, default=20)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=3072)
    ap.add_argument("--slab", default="")
    ap.add_argument("--slab-ranks", type=int, default=4)
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent))
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))
    from bemstokes_tpu_torch.la import direct

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    print(card, flush=True)
    result = dict(card=card, torch=torch.__version__, root=str(Path(args.root).resolve()))
    routes = ("kernel", "solve_triangular") if args.route == "both" else (args.route,)
    lu_trsv = None
    if "kernel" in routes or args.slab:
        from bemstokes_tpu_torch.ops import cuda_build, lu_trsv

        lib_path, proc, tmp = cuda_build._start_build(lu_trsv.SOURCE)
        build = cuda_build._finish_build(lu_trsv.SOURCE, lib_path, proc, tmp)
        result["ptxas"] = [line.strip() for line in build.splitlines() if "registers" in line or "spill" in line]
        print("\n".join(result["ptxas"]), flush=True)
    sampler = ClockSampler()
    try:
        result["isolated"] = []
        for n in (int(v) for v in args.sizes.split(",") if v):
            for name in args.dtypes.split(","):
                row = isolated(n, DTYPES[name], args.applies, routes, direct, lu_trsv, sampler)
                print(json.dumps({k: v for k, v in row.items()}), flush=True)
                result["isolated"].append(row)
                torch.cuda.empty_cache()
        result["slab"] = []
        for m in (int(v) for v in args.slab.split(",") if v):
            for name in args.dtypes.split(","):
                row = slab_triangles(m, DTYPES[name], args.slab_ranks, args.applies, lu_trsv, sampler)
                print(json.dumps(row), flush=True)
                result["slab"].append(row)
                torch.cuda.empty_cache()
    finally:
        sampler.stop()
    if args.blocks:
        result["blocks"] = blocks(args.blocks, args.block_size, args.applies, direct)
    if args.frames:
        result["frames"] = frames(args.frames, direct)
    line = json.dumps(result)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
