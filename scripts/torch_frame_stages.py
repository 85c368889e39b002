#!/usr/bin/env python3
"""Where one wall-bounded frame of the torch port spends its time on the card.

    python3 scripts/torch_frame_stages.py [--kernel no_slip|free_surface|free_space]
                                          [--refinements 5] [--frames 3]
                                          [--matrix-free [--block-nodes 1024]]
                                          [--column-mode node|gather|scatter|node_planes]
                                          [--dtype float64|float32] [--drag-gate]
                                          [--near-contact H [--near-chunk RC] | --meshed-wall]
                                          [--bacterium [--turn-frames 32]] [--heun]
                                          [--lu same|float32]

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
73,740-unknown shape that no materialized path holds on one card.  With
`--column-mode gather` (or `scatter`) the assembly takes the panel-centric
bulk and the stages name it whole and, within it, the slot kernel K6
(`tile_nodes`, which sums into the node columns itself, in free-space
gather mode; plain slot tensors beside a wall and in scatter mode), the
incidence gather-reduce of the plain slots and the inputs;
`node_planes` runs the node sweep through K4 (free space only).  With
`--drag-gate` the sphere takes the JAX package's drag-gate elements
(bench.py:474-503): a Q4 map snapped to the sphere, quadrature 6 / 9 (K1 at
144 samples per column node, the order-9 singular rules) and GMRES to 1e-12
on an f32 LU.  With `--near-contact H` the sphere sits H radii above the
image plane under chip_smoke.py phase 23's promoted quadrature (order 2,
`promote_boost` 6: below H = 1.035 or so the near-pair delta runs), whose
local blocks (`_pair_local_blocks`, both rules) are a stage within it and
whose rows go in chunks of `--near-chunk` (default: `_near_coo`'s); with
`--meshed-wall` the image plane gives way to phase 23's meshed no-slip plate
(span 12, refined near the body to threshold 0.5 within 7, per-component
solid angle; free-space kernel), whose hanging-node rows are their own
stage (`--refinements 4` is phase 23's 18,279-unknown size).  With
`--bacterium` the frames are chip_smoke.py phase 24's bacterium instead of
the sphere: the ellipsoidal head and the 384 x 16 flagellum (23,101
unknowns), its rate solved from the motor-torque balance each frame, on a
gait of `--turn-frames` frames a turn (gmsh files of the frames it runs,
which the script writes; `--kernel free_space` or `no_slip`); the
flagellum's torque mode is a stage.  `--heun` steps any configuration by
Heun's predictor-corrector: each frame solves twice, and the stages sum
both solves.  `--lu float32` factors the Direct preconditioner's LU in f32.
Prints the card's name and power limit first.
"""

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bemstokes_tpu_torch.matfree as matfree  # noqa: E402
import bemstokes_tpu_torch.mesh.constraints as constraints  # noqa: E402
import bemstokes_tpu_torch.ops.assemble as asm  # noqa: E402
import bemstokes_tpu_torch.ops.monolithic as monolithic  # noqa: E402
import bemstokes_tpu_torch.problem as problem  # noqa: E402
import bemstokes_tpu_torch.swimmer as swimmer  # noqa: E402
from bemstokes_tpu_torch.config import (  # noqa: E402
    ProblemConfig,
    QuadratureConfig,
    SolverConfig,
    WallConfig,
    WallRefinementConfig,
)
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
    ap.add_argument(
        "--column-mode", default="node", choices=["node", "gather", "scatter", "node_planes"]
    )
    ap.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    ap.add_argument("--drag-gate", action="store_true")
    place = ap.add_mutually_exclusive_group()
    place.add_argument("--near-contact", type=float, metavar="H")
    place.add_argument("--meshed-wall", action="store_true")
    ap.add_argument("--near-chunk", type=int, metavar="RC")
    ap.add_argument("--bacterium", action="store_true")
    ap.add_argument("--turn-frames", type=int, default=32)
    ap.add_argument("--heun", action="store_true")
    ap.add_argument("--lu", default="same", choices=["same", "float32"])
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
        assembly_backend=args.column_mode,
        dtype=args.dtype,
    )
    if args.drag_gate:
        cfg = dataclasses.replace(
            cfg,
            map_degree=4,
            quadrature=QuadratureConfig(order=6, singular_order=9),
            solver=SolverConfig(preconditioner_dtype="float32", tolerance=1e-12),
        )
    if args.near_contact is not None:
        cfg = dataclasses.replace(
            cfg,
            walls=(WallConfig(enabled=False, position=(0.0, -args.near_contact, 0.0), span=(10.0, 0.0, 10.0)),),
            quadrature=QuadratureConfig(order=2, promote_boost=6),
        )
    if args.meshed_wall:
        cfg = dataclasses.replace(
            cfg,
            no_slip_kernel=False,
            reflect_kernel=False,
            alpha_row_sum="component",
            walls=(WallConfig(enabled=True, wall_type="no_slip", position=(0.0, -2.0, 0.0), span=(12.0, 0.0, 12.0)),),
            wall_refinement=WallRefinementConfig(enabled=True, threshold=0.5, distance_from_center=7.0),
        )
    small = dataclasses.replace(cfg, internal_sphere_refinements=2)
    if args.bacterium:
        import chip_smoke

        gaits = tempfile.TemporaryDirectory()

        def bacterium(name, shape):
            folder = Path(gaits.name, name)
            folder.mkdir()
            chip_smoke.write_bacterium_gait(folder, *shape, files=max(args.frames, 2) + 1, turn=args.turn_frames)
            return chip_smoke.bacterium_config(f"{folder}/", args.kernel, args.turn_frames)

        cfg, small = bacterium("full", chip_smoke.GAIT_BACTERIUM), bacterium("small", chip_smoke.GAIT_BACTERIUM_SMALL)
    if args.heun:
        cfg, small = (dataclasses.replace(c, time_integration="Heun") for c in (cfg, small))
    if args.lu == "float32":
        cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, preconditioner_dtype="float32"))
    if not args.no_warmup:
        with tempfile.TemporaryDirectory() as out:
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
    if args.column_mode in ("gather", "scatter"):
        nested |= {"slot kernel (K6, or plain torch)", "incidence gather-reduce", "slot inputs and keep masks"}
        asm._panel_bulk = timed(stages, "panel-centric bulk, whole", asm._panel_bulk)
        asm.tile_nodes = timed(stages, "slot kernel (K6, or plain torch)", asm.tile_nodes)
        asm.tile_slots_reference = timed(stages, "slot kernel (K6, or plain torch)", asm.tile_slots_reference)
        asm.slot_kernel.gather_reduce = timed(stages, "incidence gather-reduce", asm.slot_kernel.gather_reduce)
        asm.slot_inputs = timed(stages, "slot inputs and keep masks", asm.slot_inputs)
        asm.slot_kernel.own_cell_keep = timed(stages, "slot inputs and keep masks", asm.slot_kernel.own_cell_keep)
    asm.node_sweep = timed(stages, "node sweep kernel", asm.node_sweep)
    asm.node_sweep_inputs = timed(stages, "column sample tables", asm.node_sweep_inputs)
    asm._add_singular_rows = timed(stages, "singular delta", asm._add_singular_rows)
    asm._add_near_corrections = timed(stages, "near delta", asm._add_near_corrections)
    nested.add("near delta: local blocks, both rules")
    asm._pair_local_blocks = timed(stages, "near delta: local blocks, both rules", asm._pair_local_blocks)
    if args.near_chunk:
        asm._near_coo = functools.partial(asm._near_coo, RC=args.near_chunk)
    constraints.apply_hanging_constraints_monolithic = timed(
        stages, "hanging-node rows", constraints.apply_hanging_constraints_monolithic
    )
    problem.normal_vector_l2 = timed(stages, "L2 normal (CG)", problem.normal_vector_l2)
    problem.v_nullspace_correction = timed(stages, "V correction", problem.v_nullspace_correction)
    problem.k_solid_angle_correction = timed(stages, "K correction", problem.k_solid_angle_correction)
    monolithic.SaddleTail.system = timed(stages, "system build", monolithic.SaddleTail.system)
    LUPreconditioner.set_up = timed(stages, "LU factor", LUPreconditioner.set_up)
    cls = problem.StokesBEMProblem
    cls.flagellum_torque_mode = timed(stages, "torque mode", cls.flagellum_torque_mode)
    cls._gmres_direct = timed(stages, "GMRES (with LU applies)", cls._gmres_direct)
    cls._finish = timed(stages, "finish (residual, packing)", cls._finish)
    cls.solve_frame = timed(stages, "solve_frame, whole", cls.solve_frame)
    sim_cls = swimmer.SwimmerSimulation
    sim_cls._save_frame = timed(stages, "result, state and VTU files", sim_cls._save_frame)
    sim_cls.euler_for_frame = timed(stages, "frame geometry (host)", sim_cls.euler_for_frame)

    with tempfile.TemporaryDirectory() as out:
        sim = swimmer.SwimmerSimulation(cfg, out)
        print(
            f"kernel {sim.problem.asm_cfg.kernel}, {3 * sim.problem.n + 6 + int(cfg.solve_with_torque)} unknowns, "
            f"{cfg.dtype}, LU {args.lu}, {cfg.time_integration}, column mode {args.column_mode}, map degree "
            f"{cfg.map_degree}, quadrature "
            f"{cfg.quadrature.order} / {cfg.quadrature.singular_order}, promoted "
            f"{sim.problem.quadrature_promoted}, {sim.problem.hanging.n} hanging nodes"
        )
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
