#!/usr/bin/env python3
"""The stale-LU preconditioner's apply on the card, against `torch.linalg.lu_solve`.

    python3 scripts/torch_lu_apply.py [--n 23101] [--applies 20] [--frames 3]
                                      [--blocks 8] [--block-size 3072]
                                      [--root DIR] [--out FILE]

Factors a seeded nonsymmetric n x n float64 matrix on the card with
`LUPreconditioner.set_up` and, for one right-hand side at a time (rows of a
[k, n] tensor, as GMRES passes them): checks that `LUPreconditioner.apply`
gives `torch.linalg.lu_solve`'s bits, that the apply
makes no host sync (`torch.cuda.set_sync_debug_mode("error")`), times both
routes with CUDA events (`--applies` calls each, after a warm-up), and lists
each route's device kernels over 5 calls from `torch.profiler` (calls and
device ms a call).  With `--frames F` > 0 it then runs F frames of
chip_smoke.py's bacterium loop (23,101 unknowns, the stale LU refactored
past 100 iterations) with every apply checked against `lu_solve` of the
factors it holds, and reports the applies, the mismatches and the counters
`lu permutations` / `lu applies`.  `--root` imports bemstokes_tpu_torch
and chip_smoke.py from another checkout (an older tree's apply is timed the
same way).  With `--blocks B` > 0 it factors a batch of B seeded
`--block-size` blocks (the matrix-free block-Jacobi's 8 x 3,072 at the
bacterium's width) and, for one and for seven columns (an iteration's
apply and the Schur tail's), compares `la.direct.lu_apply` with the kept
permutations against `torch.linalg.lu_solve` on the pivots: bits, the time
of each (CUDA events) and of the host's walk over the batch's pivots, and
their kernels.  Prints the card's name and power limit first and one JSON
line last, also written to `--out`.
"""

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch


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


def isolated(n, applies, direct):
    g = torch.Generator(device="cuda").manual_seed(20)
    A = torch.randn(n, n, generator=g, dtype=torch.float64, device="cuda")
    V = torch.randn(8, n, generator=g, dtype=torch.float64, device="cuda")
    p = direct.LUPreconditioner()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p.set_up(A)
    torch.cuda.synchronize()
    set_up_ms = (time.perf_counter() - t0) * 1e3
    del A
    lu, piv = p._factors
    swapped = int((piv != torch.arange(1, n + 1, dtype=piv.dtype, device=piv.device)).sum())

    def old(j=0):
        return torch.linalg.lu_solve(lu, piv, V[j][:, None])[:, 0]

    def new(j=0):
        return p.apply(V[j])

    for _ in range(3):
        old(), new()
    equal = all(torch.equal(new(j), old(j)) for j in range(V.shape[0]))
    torch.cuda.set_sync_debug_mode("error")
    try:
        for j in range(V.shape[0]):
            new(j)
        apply_syncs = False
    except RuntimeError:
        apply_syncs = True
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return dict(
        n=n,
        set_up_ms=set_up_ms,
        rows_swapped=swapped,
        bit_for_bit=equal,
        apply_syncs=apply_syncs,
        lu_solve_ms=[event_ms(old, applies), event_ms(old, applies)],
        apply_ms=[event_ms(new, applies), event_ms(new, applies)],
        lu_solve_kernels=device_kernels(old),
        apply_kernels=device_kernels(new),
    )


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
            max_rel_diff=float((x_old - x_new).abs().max() / x_old.abs().max()),
            lu_solve_ms=[event_ms(old, applies), event_ms(old, applies)],
            lu_apply_ms=[event_ms(new, applies), event_ms(new, applies)],
            lu_solve_kernels=device_kernels(old),
            lu_apply_kernels=device_kernels(new),
        )
    return out


def frames(count, direct):
    import chip_smoke
    from bemstokes_tpu_torch.swimmer import SwimmerSimulation
    from bemstokes_tpu_torch.utils import timers

    seen = dict(applies=0, mismatches=0, max_abs_diff=0.0)
    apply = direct.LUPreconditioner.apply

    def checked(self, v):
        y = apply(self, v)
        lu = self._factors[0]
        ref = torch.linalg.lu_solve(lu, self._factors[1], v.to(lu.dtype)[:, None])[:, 0].to(v.dtype)
        seen["applies"] += 1
        if not torch.equal(y, ref):
            seen["mismatches"] += 1
            seen["max_abs_diff"] = max(seen["max_abs_diff"], float((y - ref).abs().max()))
        return y

    direct.LUPreconditioner.apply = checked
    timers.reset()
    with tempfile.TemporaryDirectory() as folder:
        chip_smoke.write_bacterium_gait(folder, *chip_smoke.GAIT_BACTERIUM, files=count + 1)
        cfg = chip_smoke.bacterium_config(f"{folder}/")
        with tempfile.TemporaryDirectory() as out:
            SwimmerSimulation(cfg, out).run(0, count)
    direct.LUPreconditioner.apply = apply
    seen["gmres_iterations"] = timers.counts.get("gmres iterations")
    seen["lu_permutations"] = timers.counts.get("lu permutations")
    seen["lu_applies"] = timers.counts.get("lu applies")
    return seen


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=23101)
    ap.add_argument("--applies", type=int, default=20)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--blocks", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=3072)
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
    result["isolated"] = isolated(args.n, args.applies, direct)
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
