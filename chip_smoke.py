#!/usr/bin/env python3
"""Smoke run of the torch port (bemstokes_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. versions (torch, CUDA, nvcc) and the card's name and power limit;
2. the build of the node-sweep kernels from csrc/ (one nvcc per source,
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
6. one f32 free-space frame at 18,444 unknowns (GMRES tolerance 1e-5).

Before the last line it prints the card's name and power limit and one JSON
object {"kernels": [...]} with each kernel's launches on its main path, its
error against the plain version, both times and its bound; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

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


def phase_versions(node_kernel):
    nvcc = subprocess.run(
        [node_kernel.nvcc_path(), "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__} cuda {torch.version.cuda} nvcc: {nvcc}")
    log(card_line())


def phase_build(node_kernel):
    t0 = time.perf_counter()
    built = node_kernel.build_all()
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
        log(f"frame {cfg.dtype} unknowns={unknowns} " + json.dumps(records[-1]))
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
    for k in node_kernel.launches:
        node_kernel.launches[k] = 0
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
    return launches["free_space"]


def wall_path(node_kernel, device, name, cfg, frames):
    """One full-width frame loop with the counters zeroed before it."""
    gc.collect()  # the previous path's results, so that the peak is this run's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in node_kernel.launches:
        node_kernel.launches[k] = 0
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
    if launches != {"free_space": 0, "free_surface": 0, "no_slip": 3}:
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
    if launches != {"free_space": 0, "free_surface": 3, "no_slip": 0}:
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


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from bemstokes_tpu_torch.ops import node_kernel

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)
    phase_versions(node_kernel)
    phase_build(node_kernel)
    records = phase_kernel_vs_plain(node_kernel, device)
    phase_small_reference(device)
    launches = {"free_space": phase_free_space_path(node_kernel, device)}
    launches.update(phase_wall_paths(node_kernel, device))
    phase_float32(device)
    kernels = [
        dict(route="cuda", launches=launches[kernel], **KERNELS[kernel], **records[kernel])
        for kernel in KERNELS
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
