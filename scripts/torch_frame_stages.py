#!/usr/bin/env python3
"""Where one wall-bounded frame of the torch port spends its time on the card.

    python3 scripts/torch_frame_stages.py [--kernel no_slip|free_surface|free_space]
                                          [--refinements 5] [--frames 3]
                                          [--matrix-free [--block-nodes 1024]]

Runs `SwimmerSimulation(...).run(0, frames)` of bemstokes_tpu_torch for the
unit sphere 2 radii above the image plane (chip_smoke.py's configuration) on
the CUDA card and prints, per frame, the seconds of each stage of
`StokesBEMProblem.solve_frame`, each measured on the host clock with a
`torch.cuda.synchronize()` before and after (so the stages do not overlap
and their sum is close to the frame), and the frame-loop work around the
solve (geometry, state, result files).  Frame 0 factors a fresh LU; later
frames reuse it.  Two frames of a 98-node sphere run first, untimed, so that
frame 0 does not pay the process's one-time CUDA set-up (`--no-warmup`
leaves them out).  With `--matrix-free` the frames take the matrix-free
solve (`matfree.py`) and the stages are its own: the setup sweep, the block
factors, the Schur tail, GMRES and the finish, with the K5 sweeps inside the
setup and GMRES also summed on their own; `--refinements 6` is the
73,740-unknown shape that no materialized path holds on one card.  Prints
the card's name and power limit first.
"""

import argparse
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bemstokes_tpu_torch.matfree as matfree  # noqa: E402
import bemstokes_tpu_torch.ops.assemble as asm  # noqa: E402
import bemstokes_tpu_torch.problem as problem  # noqa: E402
import bemstokes_tpu_torch.swimmer as swimmer  # noqa: E402
from bemstokes_tpu_torch.config import ProblemConfig, WallConfig  # noqa: E402
from bemstokes_tpu_torch.la.direct import LUPreconditioner  # noqa: E402


def timed(stages, name, fn):
    """fn with its synchronised host-clock time added to stages[name]."""

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + time.perf_counter() - t0
        return out

    return wrapper


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="no_slip", choices=["no_slip", "free_surface", "free_space"])
    ap.add_argument("--refinements", type=int, default=5)
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--no-warmup", action="store_true")
    ap.add_argument("--matrix-free", action="store_true")
    ap.add_argument("--block-nodes", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_frame_stages: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    print(
        subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True,
            text=True,
            check=True,
        ).stdout.strip()
    )
    cfg = ProblemConfig(
        build_sphere_in_code=True,
        internal_sphere_refinements=args.refinements,
        body_manifold="sphere",
        grid_type="ImposedForce",
        imposed_component=0 if args.kernel == "free_surface" else 1,
        no_slip_kernel=args.kernel == "no_slip",
        reflect_kernel=args.kernel == "free_surface",
        walls=(WallConfig(enabled=False, position=(0.0, -2.0, 0.0), span=(10.0, 0.0, 10.0)),),
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
        matrix_free=args.matrix_free,
        matfree_block_nodes=args.block_nodes,
    )
    if not args.no_warmup:
        with tempfile.TemporaryDirectory() as out:
            small = dataclasses.replace(cfg, internal_sphere_refinements=2)
            swimmer.SwimmerSimulation(small, out).run(0, 2)
    stages = {}
    # stages that run inside another named stage: left out of the sum
    nested = set()
    if args.matrix_free:
        nested = {"K5 sweeps (within setup and GMRES)", "L2 normal (CG, within setup)"}
        mf_cls = matfree.MatfreeSolver
        mf_cls._setup = timed(stages, "setup sweep (geometry, COO deltas, one batched K5 sweep)", mf_cls._setup)
        mf_cls._build_blocks = timed(stages, "block factors (assemble_rows + LU per block)", mf_cls._build_blocks)
        mf_cls._schur = timed(stages, "Schur tail", mf_cls._schur)
        mf_cls._gmres = timed(stages, "GMRES (K5 matvecs, block solves)", mf_cls._gmres)
        matfree.sweep_matvec = timed(stages, "K5 sweeps (within setup and GMRES)", matfree.sweep_matvec)
        matfree.normal_vector_l2 = timed(stages, "L2 normal (CG, within setup)", matfree.normal_vector_l2)
    # the stages of one solve_frame, by the module attribute each is called through
    if args.matrix_free:
        nested |= {"node sweep kernel", "column sample tables", "singular delta", "near delta"}
    asm.node_sweep = timed(stages, "node sweep kernel", asm.node_sweep)
    asm.node_sweep_inputs = timed(stages, "column sample tables", asm.node_sweep_inputs)
    asm._add_singular_rows = timed(stages, "singular delta", asm._add_singular_rows)
    asm._add_near_corrections = timed(stages, "near delta", asm._add_near_corrections)
    problem.normal_vector_l2 = timed(stages, "L2 normal (CG)", problem.normal_vector_l2)
    problem.v_nullspace_correction = timed(stages, "V correction", problem.v_nullspace_correction)
    problem.k_solid_angle_correction = timed(stages, "K correction", problem.k_solid_angle_correction)
    problem.build_monolithic_system = timed(stages, "system build", problem.build_monolithic_system)
    LUPreconditioner.set_up = timed(stages, "LU factor", LUPreconditioner.set_up)
    cls = problem.StokesBEMProblem
    cls._gmres_direct = timed(stages, "GMRES (with LU applies)", cls._gmres_direct)
    cls._finish = timed(stages, "finish (residual, packing)", cls._finish)
    cls.solve_frame = timed(stages, "solve_frame, whole", cls.solve_frame)
    sim_cls = swimmer.SwimmerSimulation
    sim_cls._save_frame = timed(stages, "result, state and VTU files", sim_cls._save_frame)
    sim_cls.euler_for_frame = timed(stages, "frame geometry (host)", sim_cls.euler_for_frame)

    with tempfile.TemporaryDirectory() as out:
        sim = swimmer.SwimmerSimulation(cfg, out)
        print(f"kernel {args.kernel}, {3 * sim.problem.n + 6} unknowns, {cfg.dtype}")
        for frame in range(args.frames):
            stages.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hist = sim.run(frame, frame + 1)[-1]
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            solve = stages["solve_frame, whole"]
            outside = {"solve_frame, whole", "result, state and VTU files", "frame geometry (host)"}
            named = sum(v for k, v in stages.items() if k not in outside | nested)
            stages["solve_frame, rest (geometry, rigid modes, projections)"] = solve - named
            stages["frame, whole"] = total
            print(
                json.dumps(
                    dict(
                        frame=frame,
                        iterations=hist["iterations"],
                        refactored=hist["refactored"],
                        seconds={k: round(v, 6) for k, v in stages.items()},
                    )
                )
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
