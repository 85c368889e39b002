#!/usr/bin/env python3
"""Smoke run of the torch port (bemstokes_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. versions (torch, CUDA, nvcc) and the card's name and power limit;
2. the build of the kernels from csrc/ (the node sweeps K1, K2, K3 and K4,
   the fused sweep-matvec K5 and the slot kernel K6; one nvcc per source,
   started together), with each kernel's registers and spills as ptxas
   reports them;
3. K1 (free space), K2 (free-surface image) and K3 (Blake no-slip image)
   against their plain torch version on the card, f64 and f32, at the shapes
   the main paths give them: create_sphere(3) whole, a 512-row slab of
   create_sphere(5) and create_sphere(5) whole, wall at y = -2; K2 and K3
   once more at create_sphere(3) with the wall normal along x and z.  Timed
   with CUDA events after a warm-up.  In f32 the kernel and the plain version
   are also held against the f64 kernel, which shows how far each is from
   the exact sums;
4. small inputs, the card against the CPU (where every stage runs its plain
   torch version), 1e-10 relative on forces and rigid velocities and equal
   iteration counts: three free-space frames of StokesBEMProblem and three
   frames of SwimmerSimulation beside a wall with each image kernel, all on
   create_sphere(3); and the free-surface image solve against the explicit
   mirror-body solve in free space on the card (1e-9);
5. the main paths at full width in f64, each with the launch counters set
   to 0 just before it and read just after:
   - K1: StokesBEMProblem on create_sphere(5) (18,444 unknowns),
     ImposedVelocity along x, three frames (fresh LU, then two rigid motions
     on the stale LU), drag error <= 2.5e-4 against Stokes' 6 pi;
   - K3: SwimmerSimulation.run(0, 3), a unit sphere sedimenting away from a
     no-slip wall 2 radii below its centre, internal_sphere_refinements=5:
     every frame converges, the LU is factored once, frame 0's mobility
     6 pi U_y is within 1e-3 of Brenner's exact 1/lambda(2) = 0.470470 and
     U_y rises from frame to frame;
   - K2: the same sphere pulled along a free surface: 1 < 6 pi U_x < 1.3;
   - K3 again: the bare helix (384 x 16 panels, 6,160 nodes) rotating
     beside the no-slip wall, two frames of 64 per turn: the force-free body
     counter-rotates, U[3] = -omega_gait to 2e-3, the rest below 5e-3;
6. one f32 free-space frame at 18,444 unknowns (GMRES tolerance 1e-5);
7. K5 (`sweep_matvec`, all three Green's functions) against its plain torch
   version on the card, f64 and f32, in each launch shape (BV, BK): (1, 0),
   V alone, the GMRES matvec of an all-body mesh; (0, 1), K alone; (1, 1),
   two-sided; and (1, 10), the setup sweep: create_sphere(3) whole, a
   512-row slab of create_sphere(5), create_sphere(5) whole and a 512-row
   slab of create_sphere(6); a second call must give the same bits; at
   create_sphere(5) in f64 every shape also against V @ x, K @ x of the
   operators K1, K2 and K3 materialize (1e-12); timed at create_sphere(5)
   and at the capacity shape create_sphere(6) (24,578 nodes); before it, the
   kernel's f64 inverse square root alone against 1 / sqrt;
8. the matrix-free path, small, for each Green's function: a matrix-free
   frame on create_sphere(2), the card against the CPU (1e-10, equal
   iterations), and one on create_sphere(3) twice on the card with equal
   iteration counts;
9. the matrix-free path at 18,444 unknowns, f64, GMRES tolerance 1e-11:
   frame 0 of phase 5's free-space, no-slip and free-surface configurations
   solved materialized and matrix-free, rigid velocities and forces within
   1e-7, with the K5 launch counters set to 0 before each and read after:
   on these all-body meshes every GMRES matvec must have gone through the
   V-only kernel, none through the two-sided one, the setup sweep through
   the wide one (the counters are kept per Green's function and shape);
10. the capacity frame, which no materialized path can hold on one card:
   create_sphere(6), 24,578 nodes, 73,740 unknowns, ImposedVelocity along x,
   matfree_block_nodes = 1024, one frame each, with the same check of the
   launch shapes: in f64 with the solver's
   defaults (drag error <= 1e-4 against 6 pi, converged) and in f32 with
   preconditioner_dtype = float32, gmres_restart = 25, tolerance = 3e-5,
   max_steps = 200 (drag error <= 2.5e-4);
11. K4 (the free-space sweep stored component-major, [9, n, nr]) against its
   plain version and against K1's dense result (the same bits after
   `planes_to_dense`), f64 and f32, at create_sphere(3) whole, a 512-row slab
   of create_sphere(5) and create_sphere(5) whole, timed beside K1;
12. K6 (`tile_slots`) against its plain version, f64 and f32: Q1 panels at
   create_sphere(3) whole and at one row block of create_sphere(5), Q2 panels
   at create_sphere(3); a second call must give the same bits; in f32 kernel
   and plain version are also held against the f64 kernel; timed over all
   row blocks of create_sphere(5) (6,146 rows x 6,144 panels x 16 points)
   with the incidence gather-reduce timed apart; then `assemble_V_K` in
   gather mode against node mode on the card at create_sphere(5) (1e-10);
13. small inputs in gather mode, the card against the CPU: three free-space
   frames on create_sphere(3), 1e-10 and equal iterations;
14. the gather path at full width, launch counters set to 0 before and read
   after: StokesBEMProblem on create_sphere(5), 18,444 unknowns, f64,
   assembly_backend = "gather", three frames (fresh LU, two stale): drag
   error <= 2.5e-4 and forces within 1e-8 of phase 5's node-mode frames;
   one frame through K4 (assembly_backend = "node_planes") equal to phase
   5's frame 0 to 1e-12; one f32 gather frame; and the largest error of the
   f32 K against f64, over all entries and over the own-node 3x3 blocks,
   for the gather and the node assembly, bulk alone and with the deltas;
15. the command line: `python3 -m bemstokes_tpu_torch run -p <json> 0 2 -o
   <dir>` as a subprocess on the card, on a gait of three gmsh files that the
   script writes from create_sphere(5), gather mode: exit code 0, the state
   and result files of both frames finite, the stroke swims along x.

Before the last line it prints the card's name and power limit and one JSON
object {"kernels": [...]} with each kernel's launches on its main path, its
error against the plain version, both times and its bound; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

import dataclasses
import gc
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REFINEMENTS = 5  # create_sphere(5): 6,146 nodes, 18,444 unknowns
SLAB_ROWS = 512
WALL_Y = -2.0
#: kernel against plain version, relative to max|V| and max|K|.  In f32 the
#: own-node entries of K are sums of large cancelling terms, and both the
#: kernel and the plain version are ~1e-2 of max|K| away from the f64 value
#: there (phase 3 prints both distances).  K3 takes every inverse power from
#: one rsqrt where the plain version divides by integer powers of a square
#: root, so the two round those terms differently: 1.2e-5 at 6,146 nodes,
#: three orders below their common distance to f64.
TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
TOL_F32_NO_SLIP = 5e-5


def tolerance(kernel, dtype):
    if kernel == "no_slip" and dtype == torch.float32:
        return TOL_F32_NO_SLIP
    return TOL[dtype]

DRAG_TOL = 2.5e-4

CAPACITY_REFINEMENTS = 6  # create_sphere(6): 24,578 nodes, 73,740 unknowns
CAPACITY_FRAMES = 1  # frames per type in the capacity phase
#: K5 against its plain version, relative to max|V x| and max|K x|.  In f32
#: the kernel contracts each sample with the vector before it sums, takes
#: every inverse power from one rsqrt and sums the column nodes in splits;
#: the plain version forms G and W.n first and lets einsum pick the order.
#: K's own-node terms are large and cancel, so the two differ by a few 1e-6
#: of the largest entry; 5e-5 is K3's bound, kept for the same reason.
TOL_MATVEC = {torch.float64: 1e-12, torch.float32: 5e-5}
# K5: operations per (row, sample) interaction of each narrow launch shape
# (BV, BK), counted from csrc/sweep_matvec.cu with a multiply-add as two and
# an rsqrt as one.  (1, 0), V alone, is the GMRES matvec of an all-body mesh.
FLOPS_PER_INTERACTION_MATVEC = {
    "free_space": {(1, 1): 45, (1, 0): 25, (0, 1): 30},
    "free_surface": {(1, 1): 77, (1, 0): 43, (0, 1): 53},
    "no_slip": {(1, 1): 128, (1, 0): 58, (0, 1): 91},
}
MATVEC_SHAPES = ((1, 0), (0, 1), (1, 1), (1, 10))  # the last: the setup sweep

# Floating-point operations per (row, sample) interaction, counted from the
# kernel sources with a multiply-add as two and an rsqrt as one.
FLOPS_PER_INTERACTION = {"free_space": 65, "free_surface": 159, "no_slip": 217}
# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet): FP64 and
# FP32 outside the tensor cores, and the memory rate.
PEAK_FLOPS = {torch.float64: 33.5e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12

KERNELS = {
    "free_space": dict(
        name="node_sweep",
        source="bemstokes_tpu_torch/csrc/node_sweep.cu",
        replaces="bemstokes_tpu/ops/pallas_node.py:129",
    ),
    "free_surface": dict(
        name="node_sweep_free_surface",
        source="bemstokes_tpu_torch/csrc/node_sweep_image.cu",
        replaces="bemstokes_tpu/ops/pallas_node.py:252",
    ),
    "no_slip": dict(
        name="node_sweep_no_slip",
        source="bemstokes_tpu_torch/csrc/node_sweep_image.cu",
        replaces="bemstokes_tpu/ops/pallas_node.py:259",
    ),
}
PLANES_KERNEL = dict(
    name="node_sweep_planes",
    source="bemstokes_tpu_torch/csrc/node_sweep.cu",
    replaces="bemstokes_tpu/ops/pallas_node.py:46",
)
SLOT_KERNEL = dict(
    name="tile_slots",
    source="bemstokes_tpu_torch/csrc/tile_slots.cu",
    replaces="bemstokes_tpu/ops/pallas_assemble.py:45",
)
#: K6 against its plain version, relative to max|V_slots| and max|K_slots|.
#: Own-cell pairs are masked, so no slot is a sum of large cancelling terms;
#: what is left in f32 is the rsqrt, the FMA contraction and the order of the
#: nq-sum.
TOL_SLOTS = {torch.float64: 1e-12, torch.float32: 2e-5}
MATVEC_KERNELS = {
    kernel: dict(
        name=f"sweep_matvec_{kernel}",
        source="bemstokes_tpu_torch/csrc/sweep_matvec.cu",
        replaces="bemstokes_tpu/ops/matfree_node.py:195",
    )
    for kernel in KERNELS
}


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps, warmup=True):
    """Mean device time of fn() over `reps` calls (after one warm-up call
    unless the caller has just run it)."""
    if warmup:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rotation(axis, theta):
    c, s = np.cos(theta), np.sin(theta)
    i, j = [k for k in range(3) if k != axis]
    R = np.eye(3)
    R[i, i] = R[j, j] = c
    R[i, j], R[j, i] = -s, s
    return R


def frames_of(e0):
    """Frame 0 and two rigid motions of it (rotation + translation)."""
    return [
        e0,
        e0 @ rotation(2, 0.3).T + np.array([0.5, -0.2, 0.1]),
        e0 @ (rotation(0, 0.7) @ rotation(1, -0.4)).T + np.array([-1.0, 0.3, 2.0]),
    ]


def drag_error(res):
    F = np.asarray(res["rigid_forces_pole"])
    return abs(abs(F[0]) - 6 * np.pi) / (6 * np.pi)


def brenner_lambda(H, terms=5000):
    """Sphere translating perpendicular to a rigid plane wall: exact drag
    correction F = 6 pi mu a U lambda (Brenner 1961), H = centre height /
    radius."""
    al = np.arccosh(np.float64(H))
    n = np.arange(1, terms + 1, dtype=np.float64)
    k = 2 * n + 1
    e = np.exp(-k * al)
    sha, sh2a = np.sinh(al), np.sinh(2 * al)
    num = (1 - e * e) + k * sh2a * e
    den = (1 - e) ** 2 - (k * sha) ** 2 * e
    return (4.0 / 3.0) * sha * np.sum(n * (n + 1) / ((2 * n - 1) * (2 * n + 3)) * (num / den - 1))


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()


def clock_under_load(fn):
    """`nvidia-smi`'s SM clock, its maximum and the power draw, read while
    three calls of fn() are in flight on the card."""
    for _ in range(3):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
    ).stdout.strip()
    torch.cuda.synchronize()
    return out


def zero_counts(*modules):
    for mod in modules:
        for counts in (mod.launches, getattr(mod, "shape_launches", {})):
            for k in counts:
                counts[k] = 0


def shapes_of(matfree_node, kernel):
    """K5's launches of one Green's function per launch shape."""
    return {
        shape: count for (k, shape), count in matfree_node.shape_launches.items() if k == kernel
    }


def check_one_sided(name, kernel, shapes, iterations):
    """An all-body mesh: every GMRES matvec through the V-only kernel, none
    two-sided, the setup sweep through the wide one."""
    if not (shapes["1x0"] >= iterations and shapes["1x1"] == 0 and shapes["0x1"] == 0 and shapes["wide"] >= 1):
        raise AssertionError(f"{name} ({kernel}): unexpected K5 launch shapes {shapes}")


def phase_versions(cuda_build):
    nvcc = subprocess.run(
        [cuda_build.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")
    log(card_line())


def phase_build(cuda_build):
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    if not {"sweep_matvec.cu", "node_sweep.cu", "node_sweep_image.cu", "tile_slots.cu"} <= set(built):
        raise AssertionError(f"kernel sources missing from the build: {sorted(built)}")
    log(f"kernel build {time.perf_counter() - t0:.2f} s: " + ", ".join(p.name for p, _ in built.values()))
    for name, (_, output) in built.items():
        # per kernel instantiation: its entry function, its stack frame and
        # spills, and its registers and shared memory, as ptxas reports them
        for line in output.splitlines():
            if any(key in line for key in ("Compiling entry function", "spill", "Used ")):
                log(f"ptxas {name}: {line.strip()}")


def kernel_inputs(refinements, dtype, device):
    """(xi, Yj, Nj, Wj) exactly as the main paths build them for the node
    sweep on create_sphere(refinements)."""
    from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
    from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
    from bemstokes_tpu_torch.ops.assemble import (
        AssemblyConfig,
        build_assembly_tables,
        node_sweep_inputs,
    )

    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(space, space, AssemblyConfig(dtype=dtype))
    euler = torch.as_tensor(
        euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device
    )
    xi = support_points(euler, space, space)
    return node_sweep_inputs(euler, xi, tables)


def bound(kernel, dtype, nr, n, m):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes the sweep must move (every input read once, V and K written
    once) over the memory rate and its operations over the peak rate."""
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (3 * nr + 7 * n * m + 2 * 9 * nr * n)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = FLOPS_PER_INTERACTION[kernel] * nr * n * m / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def rel(A, B):
    return ((A - B).abs().max() / B.abs().max()).item()


def event_ms(fn):
    """Device time of one fn() (no warm-up: the plain versions' one run)."""
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def phase_planes_vs_plain(node_kernel, device):
    """K4 (the component-major store of the free-space sweep) against its
    plain version and against K1's dense result, timed beside K1; returns the
    record of create_sphere(5) whole, f64."""
    cases = [
        ("sphere3", 3, None),
        (f"sphere{REFINEMENTS}_slab{SLAB_ROWS}", REFINEMENTS, SLAB_ROWS),
        (f"sphere{REFINEMENTS}", REFINEMENTS, None),
    ]
    record = None
    for dtype in (torch.float64, torch.float32):
        tol = TOL[dtype]
        for name, refinements, rows in cases:
            xi, Yj, Nj, Wj = kernel_inputs(refinements, dtype, device)
            if rows is not None:
                xi = xi[:rows].contiguous()
            V, K = node_kernel.node_sweep(xi, Yj, Nj, Wj, layout="planes")
            Vd, Kd = node_kernel.node_sweep(xi, Yj, Nj, Wj)
            torch.cuda.synchronize()
            same_bits = torch.equal(node_kernel.planes_to_dense(V), Vd) and torch.equal(
                node_kernel.planes_to_dense(K), Kd
            )
            del Vd, Kd
            (Vr, Kr), plain_ms = event_ms(
                lambda: node_kernel.node_sweep_reference(
                    xi, Yj, Nj, Wj, row_tile=64, col_chunk=1024, layout="planes"
                )
            )
            abs_err = max((V - Vr).abs().max().item(), (K - Kr).abs().max().item())
            rel_v, rel_k = rel(V, Vr), rel(K, Kr)
            finite = bool(torch.isfinite(V).all() and torch.isfinite(K).all())
            del V, K, Vr, Kr
            ms = cuda_ms(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj, layout="planes"), reps=10)
            ms_dense = cuda_ms(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj), reps=10)
            nr, n, m = xi.shape[0], Yj.shape[0], Yj.shape[1]
            bound_ms, bound_by = bound("free_space", dtype, nr, n, m)
            log(
                f"planes (K4) {name} {str(dtype)[6:]} rows={nr} cols={n} m={m}: "
                f"rel err V {rel_v:.3e} K {rel_k:.3e} (tol {tol:.0e}), max abs err {abs_err:.3e}; "
                f"K1's bits after planes_to_dense: {same_bits}; K4 {ms:.3f} ms, K1 {ms_dense:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}"
            )
            if not (finite and same_bits and rel_v <= tol and rel_k <= tol):
                raise AssertionError(f"K4 disagrees with its plain version or with K1 on {name} {dtype}")
            if rows is None and refinements == REFINEMENTS and dtype == torch.float64:
                record = dict(
                    max_abs_err=abs_err,
                    max_rel_err=max(rel_v, rel_k),
                    ms=ms,
                    plain_ms=plain_ms,
                    bound_ms=bound_ms,
                    bound_by=bound_by,
                    library_ms=None,
                    dense_ms=ms_dense,
                )
            del xi, Yj, Nj, Wj
            torch.cuda.empty_cache()
    return record


def slot_case(refinements, degree, dtype, device):
    """(tables, euler, support points, xq, nrm, wphi) of the gather assembly
    on create_sphere(refinements) with Q`degree` elements."""
    from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
    from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
    from bemstokes_tpu_torch.ops.assemble import AssemblyConfig, build_assembly_tables, slot_inputs

    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, degree)
    tables = build_assembly_tables(
        space, space, AssemblyConfig(dtype=dtype, column_mode="gather")
    )
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    return tables, euler, support_points(euler, space, space), *slot_inputs(euler, tables)


def slots_bound(dtype, nt, nc, nq, nl):
    """(bound_ms, bound_by) of the slot kernel: every input read once and both
    slot tensors written once over the memory rate, against its operations
    over the peak rate.  Operations, counted from csrc/tile_slots.cu with a
    multiply-add as two and an rsqrt as one: 52 per (row, panel point) and
    pass to evaluate G and W.n, 24 per local node to contract them, and 27
    per (row, slot) for `keep` and the sign."""
    item = torch.finfo(dtype).bits // 8
    passes = -(-nl // (3 if nl > 4 and nl % 3 == 0 else 4))
    nbytes = item * (3 * nt + nc * nq * (6 + nl) + nc * nt + 2 * 9 * nc * nl * nt)
    flops = nt * nc * (nq * (52 * passes + 24 * nl) + 27 * nl)
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def phase_slots_vs_plain(slot_kernel, device):
    """K6 against its plain version; returns the record of all row blocks of
    create_sphere(5), f64."""
    from bemstokes_tpu_torch.ops import assemble

    cases = [
        ("sphere3_Q1", 3, 1, False),
        (f"sphere{REFINEMENTS}_Q1_block", REFINEMENTS, 1, True),
        ("sphere3_Q2", 3, 2, False),
    ]
    V64 = K64 = None
    for dtype in (torch.float64, torch.float32):
        tol = TOL_SLOTS[dtype]
        for name, refinements, degree, main_shape in cases:
            tables, euler, sp, xq, nrm, wphi = slot_case(refinements, degree, dtype, device)
            # one row block, as `assemble_rows` cuts them (f64 rows at both
            # types, so that f32 can be held against the f64 kernel)
            T = assemble.slot_block_rows(with_cfg(tables, dtype=torch.float64))
            xi = sp[:T].contiguous()
            ids = torch.arange(xi.shape[0], device=device)
            keep = assemble.own_cell_keep(tables, ids, xi)
            V, K = slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)
            V2, K2 = slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)
            torch.cuda.synchronize()
            if not (torch.equal(V, V2) and torch.equal(K, K2)):
                raise AssertionError(f"tile_slots {name}: two calls gave different bits")
            del V2, K2
            Vr, Kr = slot_kernel.tile_slots_reference(xi, xq, nrm, wphi, keep)
            rel_v, rel_k = rel(V, Vr), rel(K, Kr)
            finite = bool(torch.isfinite(V).all() and torch.isfinite(K).all())
            far = ""
            if main_shape and dtype == torch.float64:
                V64, K64 = V, K
            elif main_shape:
                far = (
                    f"; against the f64 kernel: kernel V {rel(V, V64):.3e} K {rel(K, K64):.3e}, "
                    f"plain V {rel(Vr, V64):.3e} K {rel(Kr, K64):.3e}"
                )
                V64 = K64 = None
            nc, nq, nl = wphi.shape
            log(
                f"tile_slots (K6) {name} {str(dtype)[6:]} rows={xi.shape[0]} panels={nc} nq={nq} nl={nl} "
                f"masked pairs={int((keep == 0).sum())}: rel err V {rel_v:.3e} K {rel_k:.3e} "
                f"(tol {tol:.0e}), same bits twice{far}"
            )
            if not (finite and rel_v <= tol and rel_k <= tol):
                raise AssertionError(f"tile_slots disagrees with its plain version on {name} {dtype}")
            del V, K, Vr, Kr
            torch.cuda.empty_cache()

    # timed over all row blocks of create_sphere(5), the gather-reduce apart
    records = {}
    for dtype in (torch.float64, torch.float32):
        tables, euler, sp, xq, nrm, wphi = slot_case(REFINEMENTS, 1, dtype, device)
        T = assemble.slot_block_rows(tables)
        ids = torch.arange(sp.shape[0], device=device)
        blocks = [
            (sp[t0 : t0 + T].contiguous(), assemble.own_cell_keep(tables, ids[t0 : t0 + T], sp))
            for t0 in range(0, sp.shape[0], T)
        ]

        def all_blocks():
            for xi, keep in blocks:
                slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)

        ms = cuda_ms(all_blocks, reps=3)
        # the plain version over the same blocks, one run, and the largest
        # difference over all blocks
        abs_err = 0.0
        t_plain = 0.0
        for xi, keep in blocks:
            V, K = slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)
            (Vr, Kr), t = event_ms(lambda: slot_kernel.tile_slots_reference(xi, xq, nrm, wphi, keep))
            t_plain += t
            abs_err = max(abs_err, (V - Vr).abs().max().item(), (K - Kr).abs().max().item())
            del V, K, Vr, Kr
        xi, keep = blocks[0]  # a full block
        V, K = slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)
        gather_ms = cuda_ms(
            lambda: (assemble.gather_reduce(V, tables), assemble.gather_reduce(K, tables)), reps=3
        )
        del V, K
        bulk_ms = cuda_ms(lambda: assemble._panel_bulk(euler, sp, ids, tables), reps=2)
        nc, nq, nl = wphi.shape
        nt = sp.shape[0]
        bound_ms, bound_by = slots_bound(dtype, nt, nc, nq, nl)
        log(
            f"tile_slots (K6) sphere{REFINEMENTS} {str(dtype)[6:]} rows={nt} panels={nc} nq={nq} nl={nl}, "
            f"{len(blocks)} row blocks of {T}: kernel {ms:.3f} ms ({nt * nc * nq / (ms * 1e-3):.4e} "
            f"evaluations/s, {2 * 9 * nc * nl * nt * torch.finfo(dtype).bits / 8 / (ms * 1e-3) / 1e12:.3f} TB/s stored), "
            f"plain {t_plain:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}, max abs err {abs_err:.3e}; "
            f"gather-reduce of one {T}-row block (V and K) {gather_ms:.3f} ms; "
            f"the whole gather bulk (kernel, gather-reduce, relayout) {bulk_ms:.3f} ms"
        )
        records[dtype] = dict(
            max_abs_err=abs_err,
            ms=ms,
            plain_ms=t_plain,
            bound_ms=bound_ms,
            bound_by=bound_by,
            # no one PyTorch call computes the slot tensors
            library_ms=None,
            gather_block_ms=gather_ms,
            bulk_ms=bulk_ms,
        )
        del blocks
        torch.cuda.empty_cache()

    # the whole assembly, gather against node mode
    dtype = torch.float64
    tables, euler, sp, *_ = slot_case(REFINEMENTS, 1, dtype, device)
    Vg, Kg = assemble.assemble_V_K(euler, sp, tables)
    Vn, Kn = assemble.assemble_V_K(euler, sp, with_cfg(tables, column_mode="node"))
    err_v, err_k = rel(Vg, Vn), rel(Kg, Kn)
    del Vg, Kg, Vn, Kn
    torch.cuda.empty_cache()
    log(
        f"assemble_V_K create_sphere({REFINEMENTS}) f64 on the card, gather against node mode: "
        f"V {err_v:.3e} K {err_k:.3e} of max (tol 1e-10)"
    )
    if not (err_v <= 1e-10 and err_k <= 1e-10):
        raise AssertionError("the gather assembly disagrees with node mode on the card")
    return records[torch.float64]


def with_cfg(tables, **changes):
    """Assembly tables with fields of their AssemblyConfig replaced."""
    return dataclasses.replace(tables, cfg=dataclasses.replace(tables.cfg, **changes))


def phase_kernel_vs_plain(node_kernel, device):
    """Every kernel against its plain version; returns, per kernel, the
    record of the main-path shape (create_sphere(5) whole, f64)."""
    cases = [
        ("sphere3", 3, None, 1),
        (f"sphere{REFINEMENTS}_slab{SLAB_ROWS}", REFINEMENTS, SLAB_ROWS, 1),
        (f"sphere{REFINEMENTS}", REFINEMENTS, None, 1),
        ("sphere3_wall_x", 3, None, 0),
        ("sphere3_wall_z", 3, None, 2),
    ]
    records = {}
    for kernel in KERNELS:
        V64 = K64 = None  # the f64 kernel result at the main-path shape
        for dtype in (torch.float64, torch.float32):
            for name, refinements, rows, wall_axis in cases:
                if wall_axis != 1 and kernel == "free_space":
                    continue
                main_shape = rows is None and refinements == REFINEMENTS
                xi, Yj, Nj, Wj = kernel_inputs(refinements, dtype, device)
                if rows is not None:
                    xi = xi[:rows].contiguous()
                kw = dict(kernel=kernel, wall_axis=wall_axis, wall_position=WALL_Y)
                plain_kw = dict(row_tile=64, col_chunk=1024, **kw)
                V, K = node_kernel.node_sweep(xi, Yj, Nj, Wj, **kw)
                torch.cuda.synchronize()
                # the plain version's one run is its comparison run; the
                # smaller shapes before it have warmed the allocator
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                Vr, Kr = node_kernel.node_sweep_reference(xi, Yj, Nj, Wj, **plain_kw)
                t1.record()
                torch.cuda.synchronize()
                plain_ms = t0.elapsed_time(t1)
                abs_err = max((V - Vr).abs().max().item(), (K - Kr).abs().max().item())
                rel_v, rel_k = rel(V, Vr), rel(K, Kr)
                finite = bool(torch.isfinite(V).all() and torch.isfinite(K).all())
                far = ""
                if main_shape and dtype == torch.float64:
                    V64, K64 = V, K
                elif main_shape:
                    far = (
                        f"; against the f64 kernel: kernel V {rel(V, V64):.3e} K {rel(K, K64):.3e}, "
                        f"plain V {rel(Vr, V64):.3e} K {rel(Kr, K64):.3e}"
                    )
                    V64 = K64 = None
                del V, K, Vr, Kr
                ms = cuda_ms(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj, **kw), reps=10)
                nr, n, m = xi.shape[0], Yj.shape[0], Yj.shape[1]
                bound_ms, bound_by = bound(kernel, dtype, nr, n, m)
                tol = tolerance(kernel, dtype)
                log(
                    f"{kernel} {name} {str(dtype)[6:]} rows={nr} cols={n} m={m}: "
                    f"rel err V {rel_v:.3e} K {rel_k:.3e} (tol {tol:.0e}), "
                    f"max abs err {abs_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"bound {bound_ms:.3f} ms by {bound_by} "
                    f"({nr * n * m / (ms * 1e-3):.4e} interactions/s){far}"
                )
                if not (finite and rel_v <= tol and rel_k <= tol):
                    raise AssertionError(
                        f"{kernel} disagrees with its plain version on {name} {dtype}"
                    )
                if main_shape and dtype == torch.float64:
                    records[kernel] = dict(
                        max_abs_err=abs_err,
                        max_rel_err=max(rel_v, rel_k),
                        ms=ms,
                        plain_ms=plain_ms,
                        bound_ms=bound_ms,
                        bound_by=bound_by,
                        # no one PyTorch call computes a pairwise
                        # Green's-function sweep
                        library_ms=None,
                    )
                del xi, Yj, Nj, Wj
                torch.cuda.empty_cache()
    return records


def timed_solves(problem):
    """Record every `solve_frame` of `problem`: seconds (device
    synchronised), iterations, refactored, convergence and residuals."""
    records = []
    inner = problem.solve_frame

    def solve_frame(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = inner(*args, **kwargs)
        torch.cuda.synchronize()
        records.append(
            dict(
                frame=len(records),
                seconds=time.perf_counter() - t0,
                iterations=res["iterations"],
                refactored=res["refactored"],
                converged=res["converged"],
                residual=res["residual"],
                gmres_residual=res["gmres_residual"],
                finite=bool(torch.isfinite(res["stokes_forces"]).all())
                and bool(np.all(np.isfinite(res["rigid_velocities"]))),
            )
        )
        return res

    problem.solve_frame = solve_frame
    return records


def solve_frames(device, cfg, frames):
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    prob = StokesBEMProblem(create_sphere(refinements=REFINEMENTS), cfg, device=device)
    records = timed_solves(prob)
    unknowns = 3 * prob.n + prob.num_rigid
    e0 = prob.initial_euler().cpu().numpy()
    sdot = np.zeros(3 * prob.n)
    for e in frames_of(e0)[:frames]:
        res = prob.solve_frame(e, sdot)
        records[-1]["drag_rel_err"] = float(drag_error(res))
        records[-1]["stokes_forces"] = res["stokes_forces"].cpu().numpy()
        shown = {k: v for k, v in records[-1].items() if k != "stokes_forces"}
        log(f"frame {cfg.dtype} {cfg.assembly_backend} unknowns={unknowns} " + json.dumps(shown))
        del res
    return unknowns, records


def wall_config(kernel, refinements, **kw):
    """A unit sphere 2 radii above the image plane, pushed perpendicular to a
    no-slip wall or pulled along a free surface by a unit force."""
    from bemstokes_tpu_torch.config import ProblemConfig, WallConfig

    return ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=refinements,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=1 if kernel == "no_slip" else 0,
        no_slip_kernel=kernel == "no_slip",
        reflect_kernel=kernel == "free_surface",
        walls=(WallConfig(enabled=False, position=(0.0, WALL_Y, 0.0), span=(10.0, 0.0, 10.0)),),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        **kw,
    )


def run_simulation(cfg, device, frames):
    """SwimmerSimulation(cfg).run(0, frames) on `device`; returns the
    history, the per-solve records and the saved forces of each frame."""
    from bemstokes_tpu_torch.swimmer import SwimmerSimulation

    with tempfile.TemporaryDirectory() as out:
        sim = SwimmerSimulation(cfg, out, device=device)
        records = timed_solves(sim.problem) if torch.device(device).type == "cuda" else []
        history = sim.run(0, frames)
        forces = [np.load(f"{out}/result_{k}.npz")["stokes_forces"] for k in range(frames)]
    unknowns = 3 * sim.problem.n + sim.problem.num_rigid
    return history, records, forces, unknowns


def phase_small_reference(device):
    """Small inputs: the card against the CPU, and the free-surface image
    against the explicit mirror body."""
    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig, WallConfig
    from bemstokes_tpu_torch.mesh import SurfaceMesh, create_sphere
    from bemstokes_tpu_torch.physics.rigid import flatten
    from bemstokes_tpu_torch.problem import StokesBEMProblem, result_to_numpy

    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0)
    out = []
    for dev in (device, torch.device("cpu")):
        prob = StokesBEMProblem(create_sphere(refinements=3), cfg, device=dev)
        e0 = prob.initial_euler().cpu().numpy()
        res = [result_to_numpy(prob.solve_frame(e, np.zeros(3 * prob.n))) for e in frames_of(e0)]
        out.append(res)
    worst = 0.0
    for rc, rh in zip(*out):
        for key in ("rigid_forces_pole", "stokes_forces"):
            worst = max(worst, np.abs(rc[key] - rh[key]).max() / np.abs(rh[key]).max())
        if rc["iterations"] != rh["iterations"]:
            raise AssertionError("card and CPU GMRES iteration counts differ")
    log(f"small input (create_sphere(3), 3 free-space frames): card vs CPU max rel force diff {worst:.3e} (tol 1e-10)")
    if not worst <= 1e-10:
        raise AssertionError("the free-space path on the card disagrees with the CPU reference")

    for kernel in ("no_slip", "free_surface"):
        hc, _, fc, _ = run_simulation(wall_config(kernel, 3), device, 3)
        hh, _, fh, _ = run_simulation(wall_config(kernel, 3), "cpu", 3)
        worst = 0.0
        for a, b, fa, fb in zip(hc, hh, fc, fh):
            ua, ub = np.array(a["rigid_velocities"]), np.array(b["rigid_velocities"])
            worst = max(worst, np.abs(ua - ub).max() / np.abs(ub).max())
            worst = max(worst, np.abs(fa - fb).max() / np.abs(fb).max())
            if (a["iterations"], a["refactored"]) != (b["iterations"], b["refactored"]):
                raise AssertionError(f"{kernel}: card and CPU iteration counts differ: {a} {b}")
        log(
            f"small input ({kernel} wall, create_sphere(3), 3 frames of SwimmerSimulation): "
            f"card vs CPU max rel diff of forces and rigid velocities {worst:.3e} (tol 1e-10), "
            f"iterations {[h['iterations'] for h in hc]}"
        )
        if not worst <= 1e-10:
            raise AssertionError(f"the {kernel} frame loop on the card disagrees with the CPU")

    # the free-surface image solve is the analytic elimination of an explicit
    # mirror body: same discrete problem up to rounding
    plane_y = -3.0
    mesh = create_sphere(refinements=3)
    base = dict(
        grid_type="ImposedVelocity", imposed_component=0, solver=SolverConfig(solve_directly=True)
    )
    cfg_i = ProblemConfig(
        reflect_kernel=True,
        walls=(WallConfig(enabled=False, position=(0.0, plane_y, 0.0), span=(10.0, 0.0, 10.0)),),
        **base,
    )
    prob_i = StokesBEMProblem(mesh, cfg_i, device=device)
    res_i = prob_i.solve_frame(prob_i.initial_euler(), np.zeros(3 * prob_i.n))
    F_i = float(torch.dot(flatten(res_i["operators"]["N_dual"][0]), res_i["stokes_forces"]))
    mv = mesh.vertices.copy()
    mv[:, 1] = 2 * plane_y - mv[:, 1]
    # reflected vertices, cell orientation flipped to keep outward normals
    mirror = SurfaceMesh(mv, mesh.cells[:, [1, 0, 3, 2]], mesh.material_id.copy())
    prob_2 = StokesBEMProblem(mesh.merged_with(mirror), ProblemConfig(**base), device=device)
    e2 = prob_2.initial_euler()
    res_2 = prob_2.solve_frame(e2, np.zeros(3 * prob_2.n))
    top = (e2[:, 1] > plane_y).to(e2.dtype)
    F_2 = float(
        torch.dot(flatten(res_2["operators"]["N_dual"][0] * top[:, None]), res_2["stokes_forces"])
    )
    err = abs(F_i - F_2) / abs(F_2)
    log(
        f"free-surface image vs explicit mirror body (create_sphere(3), card): drag "
        f"{F_i:.12f} vs {F_2:.12f}, rel diff {err:.3e} (tol 1e-9)"
    )
    if not (err <= 1e-9 and abs(F_i) < 6 * np.pi):
        raise AssertionError("the free-surface image solve disagrees with the mirror-body solve")


def phase_free_space_path(node_kernel, device):
    from bemstokes_tpu_torch.config import ProblemConfig

    # one-time library set-up (cuBLAS, cuSOLVER) outside the timed frames
    w = torch.eye(64, dtype=torch.float64, device=device)
    torch.linalg.lu_factor(w @ w)
    torch.cuda.synchronize()

    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0)
    torch.cuda.reset_peak_memory_stats()
    zero_counts(node_kernel)
    unknowns, recs = solve_frames(device, cfg, 3)
    launches = dict(node_kernel.launches)
    log(
        f"free-space path f64: launches {launches}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    )
    expected = 3 * (6 * 4**REFINEMENTS + 2) + 6  # 18,444 at refinement 5
    if unknowns != expected:
        raise AssertionError(f"expected {expected} unknowns, got {unknowns}")
    if [r["refactored"] for r in recs] != [True, False, False]:
        raise AssertionError("frame 0 must factor a fresh LU and frames 1-2 reuse it")
    for r in recs:
        if not (r["converged"] and r["finite"] and r["drag_rel_err"] <= DRAG_TOL):
            raise AssertionError(f"frame {r['frame']} failed: {r}")
    if launches["free_space"] < 1:
        raise AssertionError("the free-space path did not launch K1")
    return launches["free_space"], [r["stokes_forces"] for r in recs]


def wall_path(node_kernel, device, name, cfg, frames):
    """One full-width frame loop with the counters zeroed before it."""
    gc.collect()  # the previous path's results, so that the peak is this run's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(node_kernel)
    t0 = time.perf_counter()
    history, records, _, unknowns = run_simulation(cfg, device, frames)
    wall = time.perf_counter() - t0
    launches = dict(node_kernel.launches)
    for rec in records:
        log(f"{name} f64 unknowns={unknowns} " + json.dumps(rec))
    log(
        f"{name}: launches {launches}, {wall:.3f} s for the whole run (mesh and tables, "
        f"{frames} frames, their result, state and VTU files), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    )
    if len(records) != frames or not all(r["converged"] and r["finite"] for r in records):
        raise AssertionError(f"{name}: a frame did not converge: {records}")
    return history, records, launches, unknowns


def phase_wall_paths(node_kernel, device):
    from bemstokes_tpu_torch.config import ProblemConfig, WallConfig

    expected = 3 * (6 * 4**REFINEMENTS + 2) + 6
    out = {}

    # (a) sedimenting sphere, no-slip wall
    history, records, launches, unknowns = wall_path(
        node_kernel, device, "no-slip sphere", wall_config("no_slip", REFINEMENTS), 3
    )
    mobility = [6 * np.pi * h["rigid_velocities"][1] for h in history]
    exact = 1.0 / brenner_lambda(-WALL_Y)
    log(
        f"no-slip sphere: 6 pi U_y = {mobility}, Brenner 1/lambda(2) = {exact:.6f}, "
        f"frame 0 off by {abs(mobility[0] - exact):.3e} (tol 1e-3)"
    )
    if unknowns != expected:
        raise AssertionError(f"expected {expected} unknowns, got {unknowns}")
    if [r["refactored"] for r in records] != [True, False, False]:
        raise AssertionError("no-slip sphere: frame 0 must factor the LU and frames 1-2 reuse it")
    if not (abs(mobility[0] - exact) <= 1e-3 and mobility[0] < mobility[1] < mobility[2]):
        raise AssertionError("no-slip sphere: wrong mobility")
    if launches != {"free_space": 0, "free_surface": 0, "no_slip": 3, "planes": 0}:
        raise AssertionError(f"no-slip sphere: expected 3 launches of K3 alone, got {launches}")
    out["no_slip"] = launches["no_slip"]

    # (b) the same sphere pulled along a free surface
    history, records, launches, _ = wall_path(
        node_kernel, device, "free-surface sphere", wall_config("free_surface", REFINEMENTS), 3
    )
    mobility = [6 * np.pi * h["rigid_velocities"][0] for h in history]
    log(f"free-surface sphere: 6 pi U_x = {mobility} (band 1 .. 1.3)")
    if not all(1.0 < mob < 1.3 for mob in mobility):
        raise AssertionError("free-surface sphere: mobility outside its band")
    if launches != {"free_space": 0, "free_surface": 3, "no_slip": 0, "planes": 0}:
        raise AssertionError(f"free-surface sphere: expected 3 launches of K2 alone, got {launches}")
    out["free_surface"] = launches["free_surface"]

    # (c) the bare helix beside the no-slip wall
    n_frames, dt = 64, 0.05
    cfg = ProblemConfig(
        use_flagellum_handler=True,
        imposed_rotation_as_flagellum_shape=True,
        flagellum_params=dict(n_length=384, n_around=16),
        n_frames=n_frames,
        time_step=dt,
        grid_type="Real",
        no_slip_kernel=True,
        walls=(WallConfig(enabled=False, position=(0.0, -3.0, 0.0), span=(10.0, 0.0, 10.0)),),
    )
    history, records, launches, unknowns = wall_path(node_kernel, device, "no-slip helix", cfg, 2)
    omega = -2.0 * np.pi / (dt * n_frames)
    for h in history:
        U = np.array(h["rigid_velocities"])
        log(f"no-slip helix frame {h['frame']}: U = {U.tolist()}, -omega_gait = {-omega}")
        if not (
            abs(U[3] + omega) <= 2e-3 * abs(omega)
            and np.all(np.abs(U[[0, 1, 2, 4, 5]]) < 5e-3 * abs(omega))
        ):
            raise AssertionError("no-slip helix: the body does not counter-rotate")
    if unknowns != 3 * 385 * 16 + 6 or launches["no_slip"] != 2:
        raise AssertionError(f"no-slip helix: unknowns {unknowns}, launches {launches}")
    return out


def phase_float32(device):
    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig

    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        dtype="float32",
        solver=SolverConfig(tolerance=1e-5),
    )
    _, (rec,) = solve_frames(device, cfg, 1)
    if not (rec["converged"] and rec["finite"]):
        raise AssertionError(f"f32 frame failed: {rec}")


def sweep_inputs(refinements, dtype, device, kernel):
    """(tables, support points, xq, normals, jxw) as the matrix-free setup
    builds them on create_sphere(refinements), wall at y = WALL_Y."""
    from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
    from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
    from bemstokes_tpu_torch.ops.assemble import AssemblyConfig, build_assembly_tables
    from bemstokes_tpu_torch.physics.rigid import build_mass_operator

    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(
        space, space, AssemblyConfig(dtype=dtype, kernel=kernel, wall_axis=1, wall_position=WALL_Y)
    )
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    _, (xq, normals, jxw) = build_mass_operator(euler, tables)
    return tables, euler, support_points(euler, space, space), xq, normals, jxw


def matvec_bound(kernel, dtype, nr, n, m, shape=(1, 0)):
    """(bound_ms, bound_by) of one sweep-matvec of a narrow launch shape
    (BV, BK): every input read once (the normals only where K is swept) and
    the outputs written once over the memory rate, against its operations
    over the peak rate."""
    BV, BK = shape
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (3 * nr + (4 + 3 * BK) * n * m + (BV + BK) * 3 * (n + nr))
    t_bytes = nbytes / PEAK_BYTES
    t_ops = FLOPS_PER_INTERACTION_MATVEC[kernel][shape] * nr * n * m / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "operations" if t_ops >= t_bytes else "bytes"


def check_rsqrt(matfree_node, device):
    """K5's f64 inverse square root alone against 1 / sqrt in extended
    precision, over the r^2 the sweeps see and far beyond."""
    rng = np.random.default_rng(3)
    x = np.exp(rng.uniform(np.log(1e-12), np.log(1e8), 1_000_000))
    xd = torch.as_tensor(x, device=device)
    y = matfree_node.rsqrt_pos(xd).cpu().numpy()
    exact = 1 / np.sqrt(x.astype(np.longdouble))
    err = float(np.abs((y - exact) / exact).max())
    lib = float(np.abs((torch.rsqrt(xd).cpu().numpy() - exact) / exact).max())
    log(
        f"rsqrt_pos (K5's f64 inverse square root) on 1e6 values in 1e-12 .. 1e8: largest relative "
        f"error {err:.3e} = {err / 2.0**-53:.3f} x 2^-53 (torch.rsqrt {lib:.3e}; tol 2^-52)"
    )
    if not err <= 2.0**-52:
        raise AssertionError("rsqrt_pos is further than one ulp from 1 / sqrt")


def shape_name(shape):
    return f"({shape[0]},{shape[1]})"


def phase_matvec_vs_plain(matfree_node, node_kernel, device):
    """K5 against its plain version and against the materialized kernels, for
    every launch shape: V alone (1, 0), K alone (0, 1), two-sided (1, 1) and
    the setup sweep (1, 10); returns, per Green's function, the record of
    create_sphere(5) whole, f64, V alone (the GMRES matvec of the all-body
    paths), with the other shapes' and the capacity shape's times beside it."""
    from bemstokes_tpu_torch.ops.assemble import node_sweep_inputs

    check_rsqrt(matfree_node, device)
    cases = [
        ("sphere3", 3, None),
        (f"sphere{REFINEMENTS}_slab{SLAB_ROWS}", REFINEMENTS, SLAB_ROWS),
        (f"sphere{REFINEMENTS}", REFINEMENTS, None),
        (f"sphere{CAPACITY_REFINEMENTS}_slab{SLAB_ROWS}", CAPACITY_REFINEMENTS, SLAB_ROWS),
    ]
    rng = np.random.default_rng(0)
    records = {}

    def sweep(st, arrs, XV, XK, shape):
        return matfree_node.sweep_matvec(st, arrs, XV[:, : shape[0]], XK[:, : shape[1]])

    def times(st, arrs, XV, XK, reps):
        return {
            shape: cuda_ms(lambda: sweep(st, arrs, XV, XK, shape), reps=reps)
            for shape in MATVEC_SHAPES
        }

    def shown(ms, kernel, dtype, nr, n, m):
        parts = []
        for shape in MATVEC_SHAPES:
            text = f"{shape_name(shape)} {ms[shape]:.3f} ms"
            if shape in FLOPS_PER_INTERACTION_MATVEC[kernel]:
                bound_ms, bound_by = matvec_bound(kernel, dtype, nr, n, m, shape)
                text += f" (bound {bound_ms:.3f} by {bound_by})"
            parts.append(text)
        return ", ".join(parts) + f" ({nr * n * m / (ms[1, 0] * 1e-3):.4e} interactions/s V alone)"

    for kernel in MATVEC_KERNELS:
        for dtype in (torch.float64, torch.float32):
            tol = TOL_MATVEC[dtype]
            for name, refinements, rows in cases:
                main_shape = rows is None and refinements == REFINEMENTS and dtype == torch.float64
                tables, euler, sp, xq, normals, jxw = sweep_inputs(refinements, dtype, device, kernel)
                xi = sp if rows is None else sp[:rows]
                st, arrs = matfree_node.build_sweep(tables, xi, xq, normals, jxw)
                XV = torch.as_tensor(rng.standard_normal((3 * st.n, 1)), dtype=dtype, device=device)
                XK = torch.as_tensor(rng.standard_normal((3 * st.n, 10)), dtype=dtype, device=device)
                # one plain run serves every launch shape: its columns are
                # independent of one another
                Vr, Kr = matfree_node.sweep_matvec_reference(
                    st, arrs, XV, XK, row_tile=64, col_chunk=1024
                )
                if main_shape:
                    Vd, Kd = node_kernel.node_sweep(
                        *node_sweep_inputs(euler, xi, tables),
                        kernel=kernel, wall_axis=1, wall_position=WALL_Y,
                    )
                    Vm, Km = Vd @ XV, Kd @ XK
                    del Vd, Kd
                worst, abs_err, err_m = 0.0, 0.0, 0.0
                for shape in MATVEC_SHAPES:
                    BV, BK = shape
                    V, K = sweep(st, arrs, XV, XK, shape)
                    V2, K2 = sweep(st, arrs, XV, XK, shape)
                    torch.cuda.synchronize()
                    if V.shape != (3 * st.nr, BV) or K.shape != (3 * st.nr, BK):
                        raise AssertionError(f"{kernel} sweep_matvec {shape}: wrong output shapes")
                    if not (torch.equal(V, V2) and torch.equal(K, K2)):
                        raise AssertionError(f"{kernel} sweep_matvec {shape}: two calls gave different bits")
                    if not bool(torch.isfinite(V).all() and torch.isfinite(K).all()):
                        raise AssertionError(f"{kernel} sweep_matvec {shape}: result not finite")
                    if BV:
                        worst = max(worst, rel(V, Vr))
                    if BK:
                        worst = max(worst, rel(K, Kr[:, :BK]))
                    if shape == (1, 0):
                        abs_err = (V - Vr).abs().max().item()
                    if main_shape:
                        if BV:
                            err_m = max(err_m, rel(V, Vm))
                        if BK:
                            err_m = max(err_m, rel(K, Km[:, :BK]))
                    del V, K, V2, K2
                materialized = ""
                if main_shape:
                    del Vm, Km
                    materialized = (
                        f"; every shape against V @ x, K @ x of the materialized kernel {err_m:.3e} (tol 1e-12)"
                    )
                    if not err_m <= 1e-12:
                        raise AssertionError(f"{kernel} sweep_matvec disagrees with the materialized operators")
                nr, n, m = st.nr, st.n, st.vmax * st.nq
                ms = times(st, arrs, XV, XK, reps=5)
                log(
                    f"sweep_matvec {kernel} {name} {str(dtype)[6:]} rows={nr} cols={n} m={m}: "
                    f"rel err over the shapes {worst:.3e} (tol {tol:.0e}), same bits twice; "
                    f"{shown(ms, kernel, dtype, nr, n, m)}{materialized}"
                )
                if not worst <= tol:
                    raise AssertionError(f"{kernel} sweep_matvec disagrees with its plain version on {name} {dtype}")
                if main_shape:
                    _, plain_ms = event_ms(
                        lambda: matfree_node.sweep_matvec_reference(
                            st, arrs, XV, XK[:, :0], row_tile=64, col_chunk=1024
                        )
                    )
                    bound_ms, bound_by = matvec_bound(kernel, dtype, nr, n, m)
                    records[kernel] = dict(
                        max_abs_err=abs_err,
                        max_rel_err=worst,
                        ms=ms[1, 0],
                        plain_ms=plain_ms,
                        bound_ms=bound_ms,
                        bound_by=bound_by,
                        # no one PyTorch call computes a fused sweep-matvec
                        library_ms=None,
                        shape="(1,0): V alone",
                        k_alone_ms=ms[0, 1],
                        two_sided_ms=ms[1, 1],
                        setup_ms=ms[1, 10],
                    )
                del arrs, Vr, Kr
                torch.cuda.empty_cache()
            # the capacity shape whole: timed only (its plain version would
            # take tens of seconds)
            tables, _, sp, xq, normals, jxw = sweep_inputs(CAPACITY_REFINEMENTS, dtype, device, kernel)
            st, arrs = matfree_node.build_sweep(tables, sp, xq, normals, jxw)
            XV = torch.as_tensor(rng.standard_normal((3 * st.n, 1)), dtype=dtype, device=device)
            XK = torch.as_tensor(rng.standard_normal((3 * st.n, 10)), dtype=dtype, device=device)
            ms = times(st, arrs, XV, XK, reps=3)
            clock = clock_under_load(lambda: sweep(st, arrs, XV, XK, (1, 0)))
            nr, n, m = st.nr, st.n, st.vmax * st.nq
            log(
                f"sweep_matvec {kernel} sphere{CAPACITY_REFINEMENTS} {str(dtype)[6:]} rows={nr} cols={n} m={m}: "
                f"{shown(ms, kernel, dtype, nr, n, m)}; SM clock, its maximum and power under this load: {clock}"
            )
            if dtype == torch.float64:
                records[kernel].update(
                    capacity_ms=ms[1, 0],
                    capacity_bound_ms=matvec_bound(kernel, dtype, nr, n, m)[0],
                    capacity_two_sided_ms=ms[1, 1],
                    capacity_setup_ms=ms[1, 10],
                )
            del arrs
            torch.cuda.empty_cache()
    return records


def matfree_problem(device, kernel, refinements, **kw):
    """StokesBEMProblem on create_sphere(refinements) for phase 5's
    free-space (ImposedVelocity along x) or wall configuration."""
    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    if kernel == "free_space":
        cfg = ProblemConfig(
            grid_type="ImposedVelocity", imposed_component=0, force_pole="Origin",
            body_manifold="sphere", **kw,
        )
    else:
        cfg = wall_config(kernel, refinements, **kw)
    return StokesBEMProblem(create_sphere(refinements=refinements), cfg, device=device)


def solve_once(prob):
    from bemstokes_tpu_torch.problem import result_to_numpy

    if prob.device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = prob.solve_frame(prob.initial_euler(), np.zeros(3 * prob.n))
    if prob.device.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    keep = ("stokes_forces", "rigid_velocities", "rigid_forces_pole", "iterations", "converged",
            "residual", "gmres_residual")
    return {k: result_to_numpy(res[k]) for k in keep}, seconds


def worst_rel(ra, rb):
    """Largest relative difference of forces and rigid velocities."""
    return max(
        np.abs(ra[key] - rb[key]).max() / np.abs(rb[key]).max()
        for key in ("stokes_forces", "rigid_velocities")
    )


def phase_matfree_small(matfree_node, device):
    """Matrix-free frames on small spheres: the card against the CPU, where
    the sweep runs its plain version (create_sphere(2): on the CPU one plain
    sweep of create_sphere(3) takes seconds and a frame takes 50 to 70 of
    them), and the card against itself on create_sphere(3)."""
    from bemstokes_tpu_torch.config import SolverConfig

    for kernel in MATVEC_KERNELS:
        kw = dict(matrix_free=True, matfree_block_nodes=32, solver=SolverConfig(tolerance=1e-10))
        zero_counts(matfree_node)
        card, _ = solve_once(matfree_problem(device, kernel, 2, **kw))
        launches = dict(matfree_node.launches)
        check_one_sided("matrix-free small input", kernel, shapes_of(matfree_node, kernel), card["iterations"])
        host, _ = solve_once(matfree_problem("cpu", kernel, 2, **kw))
        diff = worst_rel(card, host)
        kw["matfree_block_nodes"] = 128
        first, _ = solve_once(matfree_problem(device, kernel, 3, **kw))
        again, _ = solve_once(matfree_problem(device, kernel, 3, **kw))
        log(
            f"matrix-free small input ({kernel}): create_sphere(2), card vs CPU max rel diff of forces "
            f"and rigid velocities {diff:.3e} (tol 1e-10), iterations card {card['iterations']}, CPU "
            f"{host['iterations']}, K5 launches {launches}; create_sphere(3) twice on the card: "
            f"iterations {first['iterations']} and {again['iterations']}, max rel diff "
            f"{worst_rel(again, first):.3e}"
        )
        if not (card["converged"] and host["converged"] and diff <= 1e-10):
            raise AssertionError(f"matrix-free {kernel}: the card disagrees with the CPU")
        if card["iterations"] != host["iterations"]:
            raise AssertionError(f"matrix-free {kernel}: card and CPU iteration counts differ")
        if not (first["converged"] and first["iterations"] == again["iterations"]):
            raise AssertionError(f"matrix-free {kernel}: two runs on the card took different iterations")
        if launches[kernel] < card["iterations"] or sum(launches.values()) != launches[kernel]:
            raise AssertionError(f"matrix-free {kernel}: unexpected K5 launches {launches}")


def phase_matfree_vs_materialized(matfree_node, node_kernel, device):
    """18,444 unknowns: each Green's function solved materialized and
    matrix-free; returns K5's launches per Green's function, in all and by
    launch shape."""
    from bemstokes_tpu_torch.config import SolverConfig

    out = {}
    for kernel in MATVEC_KERNELS:
        gc.collect()
        torch.cuda.empty_cache()
        solver = SolverConfig(tolerance=1e-11)
        dense, t_dense = solve_once(matfree_problem(device, kernel, REFINEMENTS, solver=solver))
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(matfree_node, node_kernel)
        free, t_free = solve_once(
            matfree_problem(device, kernel, REFINEMENTS, solver=solver, matrix_free=True)
        )
        launches = dict(matfree_node.launches)
        shapes = shapes_of(matfree_node, kernel)
        diff = worst_rel(free, dense)
        log(
            f"matrix-free vs materialized ({kernel}, 18,444 unknowns, f64, tolerance 1e-11): max rel "
            f"diff of forces and rigid velocities {diff:.3e} (tol 1e-7); matrix-free {t_free:.3f} s, "
            f"{free['iterations']} iterations, converged {free['converged']}, residual "
            f"{free['residual']:.3e}; materialized {t_dense:.3f} s, {dense['iterations']} iterations; "
            f"K5 launches {launches}, by launch shape {shapes}, block assemblies {dict(node_kernel.launches)}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
        )
        if not (free["converged"] and dense["converged"] and diff <= 1e-7):
            raise AssertionError(f"matrix-free {kernel} frame disagrees with the materialized frame")
        if launches[kernel] < free["iterations"] or sum(launches.values()) != launches[kernel]:
            raise AssertionError(f"matrix-free {kernel}: unexpected K5 launches {launches}")
        check_one_sided("matrix-free vs materialized", kernel, shapes, free["iterations"])
        out[kernel] = launches[kernel], shapes
    return out


def phase_capacity(matfree_node, device):
    """The 73,740-unknown frame, f64 and f32, CAPACITY_FRAMES each; returns
    K5's launches in the f64 run, in all and by launch shape."""
    from bemstokes_tpu_torch.config import SolverConfig

    settings = {
        "float64": (SolverConfig(), 1e-4),
        "float32": (
            SolverConfig(
                preconditioner_dtype="float32", gmres_restart=25, tolerance=3e-5, max_steps=200
            ),
            DRAG_TOL,
        ),
    }
    out = {}
    for dtype, (solver, drag_tol) in settings.items():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(matfree_node)
        prob = matfree_problem(
            device, "free_space", CAPACITY_REFINEMENTS, dtype=dtype, solver=solver,
            matrix_free=True, matfree_block_nodes=1024,
        )
        unknowns = 3 * prob.n + prob.num_rigid
        if (prob.n, unknowns) != (24578, 73740):
            raise AssertionError(f"capacity frame: {prob.n} nodes, {unknowns} unknowns")
        frames = [solve_once(prob) for _ in range(CAPACITY_FRAMES)]
        launches = dict(matfree_node.launches)
        shapes = shapes_of(matfree_node, "free_space")
        peak = torch.cuda.max_memory_allocated() / 2**30
        # the operator action alone, as the GMRES loop calls it
        solver_state = prob._matfree
        sys_state, _, _ = solver_state._setup(prob.initial_euler(), np.zeros(3 * prob.n), None)
        mv = solver_state._matvec(sys_state)
        mv_ms = cuda_ms(lambda: mv(sys_state["rhs"]), reps=3)
        m = solver_state.st.vmax * solver_state.st.nq
        for k, (res, seconds) in enumerate(frames):
            err = float(abs(abs(res["rigid_forces_pole"][0]) - 6 * np.pi) / (6 * np.pi))
            log(
                f"capacity frame {dtype} nodes={prob.n} unknowns={unknowns} frame {k}: {seconds:.3f} s, "
                f"{res['iterations']} iterations, converged {res['converged']}, residual "
                f"{res['residual']:.3e}, drag error {err:.4e} (tol {drag_tol:.1e})"
            )
            finite = bool(np.isfinite(res["stokes_forces"]).all() and np.isfinite(res["rigid_velocities"]).all())
            if not (finite and err <= drag_tol and (res["converged"] or dtype == "float32")):
                raise AssertionError(f"capacity frame {dtype} failed: {res['iterations']} iterations, drag error {err}")
        log(
            f"capacity frame {dtype}: matvec {mv_ms / 1e3:.4f} s "
            f"({prob.n * prob.n * m / (mv_ms * 1e-3):.4e} interactions/s), K5 launches in {CAPACITY_FRAMES} frame(s) "
            f"{launches}, by launch shape {shapes}, max_memory_allocated {peak:.3f} GiB; one materialized operator would be "
            f"{(3 * prob.n) ** 2 * torch.finfo(prob.asm_cfg.dtype).bits / 8 / 1e9:.1f} GB"
        )
        if launches["free_space"] < sum(res["iterations"] for res, _ in frames) or sum(launches.values()) != launches["free_space"]:
            raise AssertionError(f"capacity frame {dtype}: unexpected K5 launches {launches}")
        check_one_sided(
            f"capacity frame {dtype}", "free_space", shapes, sum(res["iterations"] for res, _ in frames)
        )
        out[dtype] = launches["free_space"], shapes
        del prob, solver_state, sys_state, mv
    return out["float64"]


def phase_gather_small(device):
    """Small inputs in gather mode: the card (K6) against the CPU (its plain
    version)."""
    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.problem import StokesBEMProblem, result_to_numpy

    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, assembly_backend="gather")
    out = []
    for dev in (device, torch.device("cpu")):
        prob = StokesBEMProblem(create_sphere(refinements=3), cfg, device=dev)
        e0 = prob.initial_euler().cpu().numpy()
        out.append([result_to_numpy(prob.solve_frame(e, np.zeros(3 * prob.n))) for e in frames_of(e0)])
    worst = 0.0
    for rc, rh in zip(*out):
        for key in ("rigid_forces_pole", "stokes_forces"):
            worst = max(worst, np.abs(rc[key] - rh[key]).max() / np.abs(rh[key]).max())
        if rc["iterations"] != rh["iterations"]:
            raise AssertionError("gather mode: card and CPU GMRES iteration counts differ")
    log(
        f"small input in gather mode (create_sphere(3), 3 free-space frames): card vs CPU max rel "
        f"force diff {worst:.3e} (tol 1e-10), iterations {[r['iterations'] for r in out[0]]}"
    )
    if not worst <= 1e-10:
        raise AssertionError("the gather path on the card disagrees with the CPU reference")


def own_node_errors(device):
    """The f32 K operator against the f64 one at create_sphere(5), largest
    difference over all entries and over the own-node 3x3 blocks (row node =
    column node), relative to max|K|: the smooth bulk alone and the assembled
    operator, in node and in gather mode."""
    from bemstokes_tpu_torch.ops import assemble

    def operators(dtype, mode):
        tables, euler, sp, *_ = slot_case(REFINEMENTS, 1, dtype, device)
        tables = with_cfg(tables, column_mode=mode)
        ids = torch.arange(sp.shape[0], device=device)
        if mode == "node":
            _, bulk = assemble.node_sweep(*assemble.node_sweep_inputs(euler, sp, tables))
        else:
            _, bulk = assemble._panel_bulk(euler, sp, ids, tables)
        _, full = assemble.assemble_V_K(euler, sp, tables)
        return bulk.double(), full.double()

    out = {}
    for mode in ("node", "gather"):
        b64, f64 = operators(torch.float64, mode)
        b32, f32 = operators(torch.float32, mode)
        n = b64.shape[0] // 3
        idx = torch.arange(n, device=device)
        for name, A, B in (("bulk", b32, b64), ("assembled", f32, f64)):
            diff = (A - B).abs()
            own = diff.view(3, n, 3, n)[:, idx, :, idx].max().item()
            out[mode, name] = (diff.max().item() / B.abs().max().item(), own / B.abs().max().item())
        del b64, f64, b32, f32
        torch.cuda.empty_cache()
    log(
        "f32 K against f64 at create_sphere(5), (largest error, largest own-node error) / max|K|: "
        + "; ".join(f"{mode} {name} ({a:.3e}, {b:.3e})" for (mode, name), (a, b) in out.items())
    )
    return out


def phase_gather_path(node_kernel, slot_kernel, device, node_forces):
    """This slice's path at full width: gather-mode frames (K6), one frame
    through K4 and one f32 gather frame; returns the launches of K6 and K4."""
    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig

    base = dict(grid_type="ImposedVelocity", imposed_component=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(node_kernel, slot_kernel)
    unknowns, recs = solve_frames(device, ProblemConfig(assembly_backend="gather", **base), 3)
    launches = dict(slot_kernel.launches)
    others = dict(node_kernel.launches)
    diffs = [
        float(np.abs(r["stokes_forces"] - f).max() / np.abs(f).max()) for r, f in zip(recs, node_forces)
    ]
    log(
        f"gather path f64: K6 launches {launches}, node-sweep launches {others}, forces against the "
        f"node-mode frames {diffs} (tol 1e-8), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    )
    if unknowns != 3 * (6 * 4**REFINEMENTS + 2) + 6:
        raise AssertionError(f"gather path: {unknowns} unknowns")
    if [r["refactored"] for r in recs] != [True, False, False]:
        raise AssertionError("gather path: frame 0 must factor a fresh LU and frames 1-2 reuse it")
    for r, d in zip(recs, diffs):
        if not (r["converged"] and r["finite"] and r["drag_rel_err"] <= DRAG_TOL and d <= 1e-8):
            raise AssertionError(f"gather frame {r['frame']} failed: drag {r['drag_rel_err']}, diff {d}")
    if launches["tile_slots"] < 3 or any(others.values()):
        raise AssertionError(f"gather path: unexpected launches {launches} {others}")

    # one frame with the node sweep stored component-major (K4)
    zero_counts(node_kernel, slot_kernel)
    _, (rec,) = solve_frames(device, ProblemConfig(assembly_backend="node_planes", **base), 1)
    planes = dict(node_kernel.launches)
    diff = float(np.abs(rec["stokes_forces"] - node_forces[0]).max() / np.abs(node_forces[0]).max())
    log(f"K4 frame f64: launches {planes}, forces against the node-mode frame 0 {diff:.3e} (tol 1e-12)")
    if not (rec["converged"] and diff <= 1e-12):
        raise AssertionError("the K4 frame disagrees with the K1 frame")
    if planes != {"free_space": 0, "free_surface": 0, "no_slip": 0, "planes": 1}:
        raise AssertionError(f"K4 frame: expected one launch of K4 alone, got {planes}")

    # one f32 gather frame
    cfg32 = ProblemConfig(
        dtype="float32", solver=SolverConfig(tolerance=1e-5), assembly_backend="gather", **base
    )
    _, (rec32,) = solve_frames(device, cfg32, 1)
    if not (rec32["converged"] and rec32["finite"] and rec32["drag_rel_err"] <= DRAG_TOL):
        raise AssertionError(f"f32 gather frame failed: {rec32['drag_rel_err']}")
    errors = own_node_errors(device)
    # own-cell pairs are masked in the gather bulk: no entry is a sum of
    # large cancelling terms there (node mode's own-node entries are ~1e-2)
    if not errors["gather", "bulk"][0] <= 1e-3:
        raise AssertionError("the f32 gather bulk of K is further from f64 than 1e-3 of max|K|")
    return launches["tile_slots"], planes["planes"]


def write_msh(path, vertices, cells):
    """A gmsh v2 file of a quad surface mesh (cells lexicographic, as
    `SurfaceMesh` stores them; the file holds them counterclockwise)."""
    n, nc = len(vertices), len(cells)
    with open(path, "w") as f:
        f.write(f"$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n{n}\n")
        np.savetxt(f, np.column_stack([np.arange(1, n + 1), vertices]), fmt="%d %.17g %.17g %.17g")
        f.write(f"$EndNodes\n$Elements\n{nc}\n")
        rows = np.column_stack(
            [np.arange(1, nc + 1), np.full((nc, 4), [3, 2, 0, 0]), cells[:, [0, 1, 3, 2]] + 1]
        )
        np.savetxt(f, rows, fmt="%d")
        f.write("$EndElements\n")


def phase_command_line():
    """`python3 -m bemstokes_tpu_torch run` as a subprocess on the card: a
    gait of three frame mesh files (create_sphere(5) growing into a pear
    along x), gather mode, frames 0 and 1."""
    import os

    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.config_io import save_config
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.swimmer import SwimmerState

    mesh = create_sphere(refinements=REFINEMENTS)
    with tempfile.TemporaryDirectory() as tmp:
        grids = os.path.join(tmp, "grids")
        os.makedirs(grids)
        for k in range(3):
            scale = 1.0 + 0.04 * k * mesh.vertices[:, :1]
            write_msh(os.path.join(grids, f"gait_{k}.msh"), mesh.vertices * scale, mesh.cells)
        cfg = ProblemConfig(
            grid_type="Real",
            n_frames=3,
            time_step=0.1,
            input_grid_path=grids + os.sep,
            input_grid_base_name="gait_",
            input_grid_format="msh",
            consider_rigid_displacements=True,
            rigid_displacement_axes=(True, True, True),
            assembly_backend="gather",
        )
        params, out = os.path.join(tmp, "params.json"), os.path.join(tmp, "out")
        save_config(cfg, params)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "bemstokes_tpu_torch", "run", "-p", params, "0", "2", "-o", out],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=600,
        )
        seconds = time.perf_counter() - t0
        for line in done.stdout.splitlines():
            if line.startswith("frame "):
                log(f"command line: {line}")
        if done.returncode != 0:
            raise AssertionError(f"the command line run exited {done.returncode}:\n{done.stderr[-2000:]}")
        U = []
        for k in range(2):
            state = SwimmerState.load(os.path.join(out, f"state_{k}.npz"))
            res = np.load(os.path.join(out, f"result_{k}.npz"))
            ok = state.frame == k and all(np.isfinite(res[key]).all() for key in res.files)
            ok = ok and np.isfinite(state.displacements).all() and res["euler"].shape == (mesh.n_vertices, 3)
            if not ok or not os.path.exists(os.path.join(out, f"stokes_{k}.vtu")):
                raise AssertionError(f"command line run: bad state or result files of frame {k}")
            U.append(res["rigid_velocities"])
        used = os.path.exists(os.path.join(out, "used_parameters_3d.json"))
        log(
            f"command line: `python3 -m bemstokes_tpu_torch run -p params.json 0 2 -o out`, gait of 3 gmsh "
            f"files ({mesh.n_vertices} nodes), gather mode: exit 0 in {seconds:.1f} s; U = "
            f"{[u.tolist() for u in U]}"
        )
        # the fore end grows: the stroke moves the body along x, and only along x
        for u in U:
            if not (used and abs(u[0]) > 1e-3 and np.all(np.abs(u[1:]) < 1e-6 * abs(u[0]) + 1e-9)):
                raise AssertionError(f"command line run: unexpected rigid velocities {u}")


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from bemstokes_tpu_torch.ops import cuda_build, matfree_node, node_kernel, slot_kernel

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    phase(phase_versions, cuda_build)
    phase(phase_build, cuda_build)
    records = phase(phase_kernel_vs_plain, node_kernel, device)
    phase(phase_small_reference, device)
    launches = {}
    launches["free_space"], node_forces = phase(phase_free_space_path, node_kernel, device)
    launches.update(phase(phase_wall_paths, node_kernel, device))
    phase(phase_float32, device)
    matvec_records = phase(phase_matvec_vs_plain, matfree_node, node_kernel, device)
    phase(phase_matfree_small, matfree_node, device)
    matvec_launches = phase(phase_matfree_vs_materialized, matfree_node, node_kernel, device)
    # K5's free-space count is the capacity frame's: its main path
    matvec_launches["free_space"] = phase(phase_capacity, matfree_node, device)
    planes_record = phase(phase_planes_vs_plain, node_kernel, device)
    slots_record = phase(phase_slots_vs_plain, slot_kernel, device)
    phase(phase_gather_small, device)
    slots_launches, planes_launches = phase(
        phase_gather_path, node_kernel, slot_kernel, device, node_forces
    )
    phase(phase_command_line)
    kernels = [
        dict(route="cuda", launches=launches[kernel], **KERNELS[kernel], **records[kernel])
        for kernel in KERNELS
    ] + [
        dict(
            route="cuda",
            launches=matvec_launches[kernel][0],
            launches_by_shape=matvec_launches[kernel][1],
            **MATVEC_KERNELS[kernel],
            **matvec_records[kernel],
        )
        for kernel in MATVEC_KERNELS
    ] + [
        dict(route="cuda", launches=planes_launches, **PLANES_KERNEL, **planes_record),
        dict(route="cuda", launches=slots_launches, **SLOT_KERNEL, **slots_record),
    ]
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
