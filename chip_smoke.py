#!/usr/bin/env python3
"""Smoke run of the torch port (bemstokes_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. versions (torch, CUDA, nvcc) and the card's name and power limit;
2. the build of the kernels from csrc/ (the node sweeps K1, K2, K3 and K4,
   the fused sweep-matvec K5, the slot kernel K6 with its two entry
   points, `tile_slots` and `tile_nodes`, and the stale LU's `lu_trsv`; one nvcc per source, started
   together), with each kernel's registers and spills as ptxas reports
   them; and the pipe instructions per interaction of K1-K4's sample loops
   and per (row, panel point) of `tile_nodes`' loop, counted from their
   machine code (scripts/torch_sass_count.py);
3. K1 (free space), K2 (free-surface image) and K3 (Blake no-slip image)
   against their plain torch version on the card, f64 and f32, at the shapes
   the main paths give them: create_sphere(3) whole, a 512-row slab of
   create_sphere(5) and create_sphere(5) whole, wall at y = -2; K2 and K3
   once more at create_sphere(3) with the wall normal along x and z.  Timed
   with CUDA events after a warm-up; at create_sphere(5) whole with the SM
   clock read under load and the pipe floor beside the time.  In f32 the
   kernel and the plain version are also held against the f64 kernel, which
   shows how far each is from the exact sums;
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
   of create_sphere(5) and create_sphere(5) whole, timed beside K1 (with the
   SM clock and the pipe floor at create_sphere(5) whole);
12. K6 (`tile_slots`, the slot tensors) against its plain version, f64 and
   f32: Q1 panels at create_sphere(3) whole and at one row block of
   create_sphere(5), Q2 panels at create_sphere(3); a second call must give
   the same bits; in f32 kernel and plain version are also held against the
   f64 kernel; timed over all row blocks of create_sphere(5) (6,146 rows x
   6,144 panels x 16 points) with the incidence gather-reduce timed apart;
   then `assemble_V_K` in gather mode (through `tile_nodes`) against node
   mode on the card at create_sphere(5) (1e-10);
   K6's node-column entry point `tile_nodes`, the gather path's, against its
   plain version (the gather-reduce of `tile_slots_reference`), f64 and f32,
   with the tolerances of `tile_slots`: Q1 and Q2 at create_sphere(3) whole,
   one row block of create_sphere(5); a second call must give the same bits;
   timed over all rows of create_sphere(5) with the SM clock under load and
   the pipe floor, beside the old route (`tile_slots` and the gather-reduce),
   K1's node bulk, the relayout of the node columns into the dense
   operators and the whole gather bulk, all in the same call; and the
   redundancy of the node groups (panels evaluated per panel);
13. small inputs in gather mode, the card against the CPU: three free-space
   frames on create_sphere(3), 1e-10 and equal iterations;
14. the gather path at full width, launch counters set to 0 before and read
   after: StokesBEMProblem on create_sphere(5), 18,444 unknowns, f64,
   assembly_backend = "gather", three frames (fresh LU, two stale): drag
   error <= 2.5e-4 and forces within 1e-8 of phase 5's node-mode frames;
   `tile_nodes` launched, and neither `tile_slots` nor the plain-torch
   gather-reduce;
   one frame through K4 (assembly_backend = "node_planes") equal to phase
   5's frame 0 to 1e-12; one f32 gather frame; and the largest error of the
   f32 K against f64, over all entries and over the own-node 3x3 blocks,
   for the gather and the node assembly, bulk alone and with the deltas;
15. the command line: `python3 -m bemstokes_tpu_torch run -p <json> 0 2 -o
   <dir> --profile <dir>` as a subprocess on the card, on a gait of three
   gmsh files that the script writes from create_sphere(5), gather mode:
   exit code 0, the state and result files of both frames finite, the
   stroke swims along x, and the torch.profiler trace names the
   `tile_nodes` kernel among the card's events;
16. the preconditioners of the monolithic GMRES solve at 18,444 unknowns,
   one frame each of Jacobi, SOR, SSOR, ILU, AMG (both block-Jacobi) and
   SSOR limited to a band of 100, with the solver's defaults otherwise: each
   converges (true residual <= tol |b|), its rigid velocities and forces
   within 1e-7 of phase 5's Direct frame 0, one K1 launch a frame; its
   iterations, preconditioner set-up, GMRES and frame ms printed; and
   `print_matrices` on create_sphere(3) in a temporary working directory:
   the five files, `monolithic_matrix.txt` equal to the frame's A;
17. the grand-resistance strategy (monolithic=False) at 18,444 unknowns: a
   unit force along x in free space (6 pi U_x within 2.5e-4 of 1, the
   resistance diagonals within 2.5e-4 and 1e-3 of 6 pi and 8 pi, the
   off-diagonal entries below 1e-8 of 6 pi), a rigid-motion gait (grid
   Real) against the monolithic Direct frame to 1e-7, and
   SwimmerSimulation.run(0, 2) of phase 5's no-slip sphere (6 pi U_y within
   1e-3 of Brenner's, finite state and output files, two K3 launches); the
   LU of V and the Dirichlet-to-Neumann map timed;
18. post-processing of phase 5's frame 0: `evaluate_stokes_bie` at 4,096
   seeded points in the shell 1.2 <= r <= 5 against the exact flow past the
   translating sphere (5e-4, from the CPU trend), the single layer of the
   normal inside and outside (1e-6), the velocity gradient's trace at 64
   points (1e-6); `evaluate_stokes_bie_on_boundary` at 256 support points
   (finite, timed), and at every support point of create_sphere(3) the card
   against the CPU (1e-10);
19. the convergence command: `python3 -m bemstokes_tpu_torch convergence -p
   <json> --cycles 4` as a subprocess on the card, on a gmsh file of
   create_sphere(2) with the sphere manifold (98 to 6,146 nodes): exit code
   0, its table equal to the same study run in this process on the card,
   every rate positive, the first three errors within 1e-8 of the study on
   the CPU (run by this script with `--cpu-convergence DIR` in a process of
   its own, started before phase 2, so that its plain-torch assembly
   overlaps the card's phases);
20. the 2D problem, which runs no kernel (its bulk and matvec are plain
   torch, `ops/bulk_2d.py`, as the JAX package keeps 2D on its XLA path):
   the 10-cell clockwise circle built in code, refined 10 times (10,240
   nodes, 20,483 unknowns), rotating, f64: (a) a fresh and two stale
   node-mode frames with their stages (bulk, singular delta, L2 normal, LU,
   GMRES), peak memory and T / 4 pi - 1, one gather-mode frame (forces
   within 1e-10 of node mode) and one f32 frame at 5,120 nodes against f64
   there; (b) U_x R_xx = 1 to 1e-8 (imposed force against imposed
   velocity); (c) monolithic=False, its 3 x 3 resistance matrix against
   (a); (d) the matrix-free frame at 2,560 nodes, blocks of 1,024, GMRES
   tolerance 1e-11, against the materialized one (1e-7), with its
   iterations and ms per operator action; (e) `python3 -m
   bemstokes_tpu_torch run --dim 2` as a subprocess on the spinning gait of
   two `.inp` frames (U[2] within 2e-2 of -alpha/dt, the saved angle dt U[2]
   to 1e-12, files written); (f) `python3 -m bemstokes_tpu_torch
   convergence --dim 2 --cycles 8` (10 to 1,280 nodes), its table equal to
   the study on the card, the first six cycles equal to the CPU's to 1e-10;
   (g) the field at 1,024 points in 1.2 <= r <= 5 against u_theta = 1/r
   (1e-7); and no launch of any of the port's CUDA kernels;
21. the distributed frame step (`parallel/`) in a 1-rank NCCL group on the
   card (a broadcast and an all-gather checked first), f64: (a) the Direct
   step at 18,444 unknowns, fresh then stale, against `solve_frame` fresh
   then stale on the same inputs (forces, F and rigid velocities within
   1e-10, equal iterations and refactor flags, drag error 1.728e-4), with
   both frames' ms, the slab LU's ms against `solve_frame`'s LU and the
   peak memory; (e) `sharded_evaluate_stokes_bie` of its frame 0 at 4,096
   points against `evaluate_stokes_bie` (1e-12); (b) the Jacobi step
   (1e-8) and the resistance step (1e-10, 6 pi U_x within 2.5e-4 of 1)
   against their single-card frames; (c) the four slabs of a virtual
   4-rank partition, each assembled alone by the per-rank body of
   `sharded_assemble` (nloc 1,537, two padded rows on the last): K1 on
   create_sphere(5), K3 on create_sphere(4) beside the no-slip wall, every
   real row within 1e-13 of max|V|, max|K| of the single-card operators,
   padded rows zero; (d) `SwimmerSimulation.run(0, 2)` with `distributed`
   on a Real gait of three gmsh files from create_sphere(4) beside the
   no-slip wall against the same loop without it (rigid velocities within
   1e-10, the same output files, one K3 launch a frame); the group is
   destroyed at the end.  Around each distributed path with a slab LU ((a),
   the resistance step of (b), (d)) `lu_trsv`'s launches are set to 0 and
   the slab applies counted (`slab_applies`): every apply of one right-hand
   side solves both its triangles through the kernel's row-major
   instantiation (`slab triangles native` = 2 x the applies, one "Slab LU
   apply" span each, = the launches); after it that instantiation is held
   on the path's own slab block against `solve_triangular` (1e-11 in f64;
   the slab cast to f32, the kernel at most 4 times the library's distance
   from the f64 solution) and timed beside its bytes bound
   (`slab_trsv_check`);
22. the higher-order elements, f64, Direct, at 18,444 unknowns, each path
   with the launch counters set to 0 just before it and read just after,
   its frames' ms, iterations, drag error and peak memory printed: first
   every configuration on create_sphere(2), the card against the port on
   the CPU (1e-10); then (a) the JAX package's drag gate (a Q4 map snapped
   to the sphere, quadrature 6 / 9, GMRES to 1e-12 on an f32 LU) on
   create_sphere(5): a fresh and a stale node frame (K1 at 144 samples per
   column node) and a gather frame (`tile_nodes` at 36 panel points), drag
   error <= 1e-6, gather forces within 1e-8 of node mode's; (b) that map
   on phase 5's sphere beside the no-slip wall, one frame of the frame loop
   (K3 at 144), 6 pi U_y within 1e-3 of Brenner's; (c) one matrix-free
   frame of (a) (K5 at 144, GMRES to 1e-11) within 1e-7 of (a)'s frame 0;
   (d) Q2 unknowns on a Q2 map snapped to the sphere, create_sphere(4)
   (6,146 nodes; K1 at 64 with 44 % of the samples of zero weight,
   `tile_nodes` with 9 local nodes), and (e) Q0 unknowns on create_sphere(5)
   (6,144 panel centres; K1 at 16, `tile_nodes` with one local node): a
   node and a gather frame each, within 1e-8 of each other; (f) a Q2 map
   with Q1 unknowns, two frames of a translating gait (U_x within 2e-2 of
   the translation it cancels); (g) the prolate spheroid 2:1:1 from
   create_sphere(5), a Q3 map on the spheroid, quadrature 5 / 8 (K1 at 100,
   a last pass of 4 samples), along and across its axis within 2e-3 of
   Oberbeck's drag.  Each kernel at each new shape is held against its
   plain version on the card on the first 512 rows and timed over all rows
   with the SM clock read under load, its bound counting the samples of
   nonzero weight.
23. walls and near contact, f64, Direct, each path with the launch
   counters set to 0 just before it and read just after, its frames' ms,
   iterations, residual, drag, hanging nodes and peak memory printed:
   first each part's small twin (create_sphere(1-2), coarse walls, every
   vertex jittered by 1e-6 so that no near-pair selection meets a distance
   tie), the card against the port on the CPU (1e-10, equal iterations and
   column masks); then (a) create_sphere(4) 2 radii above a meshed no-slip
   plate (span 12) refined near the body to threshold 0.5 within 7 (6,091
   nodes, 152 hanging, 18,279 unknowns), per-component solid angle: fresh
   and stale node frames along x and toward the plate, the unrefined plate,
   the Blake image wall (K3) on the same sphere, a gather frame
   (`tile_nodes`, 1e-8), a matrix-free frame (blocks of 1,024, GMRES to
   1e-11, 1e-8) and two frames of the frame loop toward the plate on the
   stale LU; the refined x-drag's error against Lorentz's series under half
   the unrefined one's and under 2e-2, both under Lorentz's drag; (b) that
   sphere with a dirichlet, a neumann, a do-nothing and a free-surface plate
   8 away, each refined uniformly 5 times: a node frame (the unknowns follow
   the column mask, 6 pi < drag < 12 pi) and a matrix-free frame through
   K5's two-sided (1, 1) launch (1e-8); (c) create_sphere(5) moving toward
   the Blake wall at H = 2, 1.2, 1.1, 1.05, 1.02 under the order-2 far rule,
   the same with auto-promotion (boost 6) and uniform order 8: the
   promotion where the image gap is below the local panel diameter, lambda
   within 1e-2 of Brenner's at H >= 1.1, and where it promotes the
   promoted rule within 1e-4 of order 8 and the plain one more than 3
   times further; (d) two create_sphere(5) bodies 3.0 and 2.05 apart along
   x (12,292 nodes, 36,882 unknowns): lambda within 1e-2 of Stimson and
   Jeffery's, the promotion at 2.05 only, and a matrix-free frame at 2.05
   with the near-pair delta in each iteration (1e-8).  The promoted frame at
   H = 1.02 (the contact sphere) holds the stale LU's kernel on its own
   factor against cuBLAS's trsv (`lu_trsv_check`, as in 24 (a)).  K3 at m = 16 and
   256, K1 at 12,292 nodes and K5 (1, 1) on the four-wall mesh are held
   against their plain versions on the first 512 rows and timed.
24. the swimmer gaits through SwimmerSimulation.run, f64, each path with the
   launch counters set to 0 just before it and read just after, each solve's
   ms, iterations, refactor flag, residual and launches printed: first each
   path's small twin (a 128-node bacterium whose vertices are jittered by
   1e-6, create_sphere(2) otherwise), the card against the port on the CPU
   (1e-10, equal iterations; the f32 LU one iteration either way); then
   (a) the bacterium: a head sphere remapped each frame onto the ellipsoid
   of `spherical_head` (1,538 nodes) and the 384 x 16 tube deformed to the
   reference spiral (6,160), turned by 11.25 degrees a frame (gmsh files
   of the frames the loops read), its rate solved
   from the motor-torque balance (`solve_with_torque`: 23,101 unknowns),
   rigid displacements on every axis, auto-promotion on (whether it fires
   and the near delta's ms printed): three frames in free space (K1) and
   beside the no-slip wall at y = -3 (K3), the motor torque -2 within 1e-8
   every frame and in motor_torque.txt, the body counter-rotating against
   the flagellum and swimming head first, the centre-of-mass series
   written, every LU apply of both loops through the kernel `lu_trsv` (its
   launches set to 0 before each loop: two an apply, `lu applies native` =
   `lu applies`), and the free-space loop's own factor (23,101 unknowns)
   held against cuBLAS's trsv (1e-11 in f64; cast to f32, the kernel at most
   4 times cuBLAS's distance from the f64 solution) and timed beside its
   bytes bound; frame 0 on an f32 LU (GMRES to 1e-12) within 1e-8 of the f64
   frame; a gather frame (`tile_nodes`) within 1e-8 of the node frame; the
   matrix-free loop (K5 V alone, the torque unknown in the Schur tail)
   within 1e-7 of the materialized loop; the loop with `distributed` at
   world size 1 within 1e-10 with equal iterations; (b) Heun: phase 15's
   translation gait of create_sphere(5) under the free-surface image plane
   at y = -4 and phase 5's sphere beside the no-slip wall, three frames
   each, two K2 (K3) launches a frame, the velocities more than 1e-3 from a
   Forward loop's; (c) Blake's squirmer on frozen geometry
   (`velocity_type="Squirmer"`, `squirmer_change_geometry=False`),
   create_sphere(5) with gait files of B1 = 1, -0.5, 1 (one of them deal.II
   binary): three frames in free space (U.e within 1e-3 of (2/3) B1, the
   other components below 1e-6, frames 1-2 frozen with no bulk launch and
   no refactor, frame 1 within 1e-9 of a re-assembled frame), beside the
   no-slip wall and with `distributed` at world size 1 (the frozen step,
   1e-10).  The distributed loops of (a) and (c) count and check their slab
   applies as phase 21 does.  K1 and K3 at 7,698 nodes and `tile_nodes` on the head-and-tube
   node groups are held against their plain versions on the first 512 rows
   and timed.

Before the last line it prints the card's name and power limit and one JSON
object {"kernels": [...]} with each kernel's launches on its main paths
(K1-K4: summed over every path of phases 5, 6, 9, 10, 14, 16-19 and 21-24
that reaches them, the block factors of the matrix-free frames included, and
phase 21's frames, slabs and loop; beside that raw
count, what the launches were worth in whole create_sphere(5) sweeps per
type, and those sweeps times each type's gap between time and bound;
`tile_nodes` likewise over the gather frames of phases 14 and 22-24, in
whole create_sphere(5) bulks; K5's free-space count adds the matrix-free
frames of phases 22-24 to the capacity frame's; `tile_slots` is on no
path since the gather path takes `tile_nodes`: 0), its error against the
plain version, both times and its bound, for K1, K3, K5 and `tile_nodes`
the records of phase 22's new shapes (`higher_order_shapes`), for K1, K3
and K5 those of phase 23 (`walls_near_contact_shapes`) and for K1, K3 and
`tile_nodes` those of phase 24 (`swimmer_gaits_shapes`); `lu_trsv` with
its launches over phase 24's free-space bacterium loop, and its error, ms,
bound_ms (n^2 values, both triangles, at 3.35 TB/s) and library_ms (the
gather and cuBLAS's two trsv) at 23,101 unknowns, f64 and f32, beside the
contact sphere's record (`records`), and under `row_major` the row-major
instantiation's launches over the distributed paths of phases 21 and 24
(`blocks`: each path's applies, triangles and launches) and its error, ms,
bound_ms and library_ms (`solve_triangular` on the same block) on the
largest slab block, beside each block's record; the last line is
{"ok": true, "device": {...}}.  Without a CUDA device it exits non-zero and
prints no result.
"""

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

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

# Floating-point operations per (row, sample) interaction: those of the
# fewest-operation form of each Green's function's sums that is known, with a
# multiply-add as two and an rsqrt as one, so that the bound reads the same
# whatever implements it.  Per-sample work (weights, heights above the wall)
# is shared by all rows and not counted; the constants 1/8pi and 3/4pi are
# applied per output.
# - free space, 50: R 3, r^2 5, rsqrt 1, 1/r^2, w/r, w/r^3 3, the 1/r sum 1,
#   R.N 5, K's factor (R.N/r^2)(w/r^3) 2, the dyad 6, 12 multiply-adds 24;
# - free surface, 86: p and pI_w 4, r^2 and rI^2 from one off-wall sum 7, two
#   rsqrt 2, their powers and weights 6, two 1/r sums 2, p.N 5 and
#   pI.N = p.N + 2 h0 N_w 2, K's two factors 4, V's and K's 9 entries each
#   from the symmetric off-wall block and the wall row and column, 27 + 27;
# - no slip, 141: p, pI_w, r^2, rI^2 11; V 47 and K 83 as in
#   csrc/node_sweep_image.cu `add_no_slip`, the fewest known.
# What the card pays is the pipe instructions a kernel issues per
# interaction, counted from its machine code in phase 2 (`node_loop_counts`);
# the pipe floor is that count times the interactions over the SMs' 64 FP64
# (128 FP32) lanes a clock at the SM clock read under load.
FLOPS_PER_INTERACTION = {"free_space": 50, "free_surface": 86, "no_slip": 141}
# Peak rates of one H100 SXM at its full 700 W (NVIDIA data sheet): FP64 and
# FP32 outside the tensor cores, and the memory rate.
PEAK_FLOPS = {torch.float64: 33.5e12, torch.float32: 67e12}
PEAK_BYTES = 3.35e12
#: the stale LU's apply (no Pallas counterpart).  Held against
#: `la.direct.lu_apply` (the gather and cuBLAS's two trsv) on the same f64
#: factor relative to max|x|; on the factor cast to f32 both routes round far
#: from the f64 solution, and the kernel's distance from it may be at most
#: LU_TRSV_F32_RATIO times cuBLAS's.
LU_KERNEL = dict(
    name="lu_trsv",
    source="bemstokes_tpu_torch/csrc/lu_trsv.cu",
    replaces="none: the JAX package's triangular solves are XLA's",
)
TOL_LU_TRSV = 1e-11
LU_TRSV_F32_RATIO = 4.0
#: filled as the phases run: `lu_trsv_check`'s records and the kernel's
#: launches and the applies over phase 24's bacterium loop; under "slab",
#: the row-major instantiation's: each distributed block's applies, triangles
#: and launches (`slab_applies`) and `slab_trsv_check`'s records
LU_TRSV_RUNS = {"records": [], "loop": None, "slab": {"blocks": [], "records": []}}

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
NODES_KERNEL = dict(
    name="tile_nodes",
    source="bemstokes_tpu_torch/csrc/tile_slots.cu",
    replaces="bemstokes_tpu/ops/pallas_assemble.py:45",
)
#: K6 against its plain version, relative to max|V_slots| and max|K_slots|
#: (`tile_nodes`: max|V| and max|K| of the node columns).
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


#: launches of K1-K4 summed over every main path that reaches them (phases
#: 5, 6, 9, 10, 14, 16-19 and 21-24), each path's counts read just after it ran with the
#: counters set to 0 just before it; and the interactions they swept, per
#: (counter, "f32" or "f64")
PATH_LAUNCHES = {"free_space": 0, "free_surface": 0, "no_slip": 0, "planes": 0}
PATH_INTERACTIONS = {(k, suffix): 0 for k in PATH_LAUNCHES for suffix in ("f32", "f64")}


def tally(node_kernel):
    """Add the node-sweep counters' present values to PATH_LAUNCHES and
    PATH_INTERACTIONS and return the launches."""
    counts = dict(node_kernel.launches)
    for k, v in counts.items():
        PATH_LAUNCHES[k] += v
    for k, v in node_kernel.interactions.items():
        PATH_INTERACTIONS[k] += v
    return counts


def zero_counts(*modules):
    for mod in modules:
        for counts in (
            mod.launches,
            getattr(mod, "shape_launches", {}),
            getattr(mod, "interactions", {}),
            getattr(mod, "pairs", {}),
        ):
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


@functools.lru_cache(maxsize=None)
def sass_count():
    """scripts/torch_sass_count.py as a module: the counting of a kernel's
    machine code and the pipe floor that the count allows."""
    spec = importlib.util.spec_from_file_location(
        "torch_sass_count", Path(__file__).resolve().parent / "scripts" / "torch_sass_count.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def node_loop_counts(cuda_build):
    """{(kernel, dtype): counted row} of the sample loops of K1-K4 (kernel
    "planes" for K4) and of `tile_nodes`' loop over a panel's points (Q1,
    one pass of 4 local nodes), counted from the machine code of their
    sources by scripts/torch_sass_count.py (`count_loops`)."""
    sc = sass_count()
    sources = {"node_sweep.cu": ("K1", "K4"), "node_sweep_image.cu": ("K2", "K3"), "tile_slots.cu": ("K6n",)}
    kernel_of = {"K1": "free_space", "K2": "free_surface", "K3": "no_slip", "K4": "planes", "K6n": "tile_nodes"}
    counted = {**{k: v[3] for k, v in sc.NODE_SWEEPS.items()}, "K6n": ("tile_nodes_kernel", [4])}

    def count(name):
        with tempfile.TemporaryDirectory() as tmp:
            cubin = Path(tmp) / "kernel.cubin"
            sc.build_cubin(cuda_build.CSRC / name, [], cubin)
            return sc.count_loops(sc.disassemble(cubin)[1], None)

    with ThreadPoolExecutor(len(sources)) as pool:
        rows = dict(zip(sources, pool.map(count, sources)))
    out = {}
    for name, keys in sources.items():
        for key in keys:
            for dtype in (torch.float64, torch.float32):
                dtype_name = str(dtype)[6:]
                row = sc.node_row(rows[name], dtype_name, counted[key])
                if row is None:
                    raise AssertionError(f"no sample loop of {key} {dtype_name} found in {name}")
                out[kernel_of[key], dtype] = row
    return out


def pipe_floor(row, dtype, nr, n, m, clock):
    """(pipe instructions per interaction, pipe floor ms) of a counted sample
    loop over nr * n * m interactions at the SM clock (MHz) read under load,
    by scripts/torch_sass_count.py's own `pipe_floors`."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floors = sass_count().pipe_floors(row, str(dtype)[6:], nr * n * m, {"sm_clock_mhz": clock}, sms)
    return floors["pipe_instructions_per_sample"], floors["pipe_floor_ms"]


def sm_clock_mhz(clock):
    """The SM clock (MHz) of a `clock_under_load` line."""
    return float(clock.split(",")[0].split()[0])


def phase_build(cuda_build):
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    if not {"sweep_matvec.cu", "node_sweep.cu", "node_sweep_image.cu", "tile_slots.cu", "lu_trsv.cu"} <= set(built):
        raise AssertionError(f"kernel sources missing from the build: {sorted(built)}")
    log(f"kernel build {time.perf_counter() - t0:.2f} s: " + ", ".join(p.name for p, _ in built.values()))
    for name, (_, output) in built.items():
        # per kernel instantiation: its entry function, its stack frame and
        # spills, and its registers and shared memory, as ptxas reports them
        for line in output.splitlines():
            if any(key in line for key in ("Compiling entry function", "spill", "Used ")):
                log(f"ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    counts = node_loop_counts(cuda_build)
    log(
        f"sample loops of K1-K4 and tile_nodes counted from the machine code in {time.perf_counter() - t0:.1f} s, "
        f"pipe instructions per interaction (tile_nodes: per (row, panel point); FP64 in f64, FP32 in f32): "
        + ", ".join(
            f"{k} {str(d)[6:]} {row['per_sample']['fp64' if d == torch.float64 else 'fp32']:.2f}"
            for (k, d), row in counts.items()
        )
    )
    return counts


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


def bound(kernel, dtype, nr, n, m, live=None):
    """(bound_ms, bound_by): the least time the card could take, the larger
    of the bytes the sweep must move (every input read once, V and K written
    once) over the memory rate and its operations over the peak rate.  Where
    only `live` of the n * m column samples carry weight (the rest pad each
    node to the largest valence), the operations are the live samples'."""
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (3 * nr + 7 * n * m + 2 * 9 * nr * n)
    t_bytes = nbytes / PEAK_BYTES
    t_ops = FLOPS_PER_INTERACTION[kernel] * nr * (n * m if live is None else live) / PEAK_FLOPS[dtype]
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


def phase_planes_vs_plain(node_kernel, device, counts):
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
            floor = ""
            if rows is None and refinements == REFINEMENTS:
                clock = clock_under_load(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj, layout="planes"))
                instructions, floor_ms = pipe_floor(counts["planes", dtype], dtype, nr, n, m, sm_clock_mhz(clock))
                floor = (
                    f", {instructions:.2f} pipe instructions an interaction, pipe floor "
                    f"{floor_ms:.3f} ms; SM clock, its maximum and power under this load: {clock}"
                )
            log(
                f"planes (K4) {name} {str(dtype)[6:]} rows={nr} cols={n} m={m}: "
                f"rel err V {rel_v:.3e} K {rel_k:.3e} (tol {tol:.0e}), max abs err {abs_err:.3e}; "
                f"K1's bits after planes_to_dense: {same_bits}; K4 {ms:.3f} ms, K1 {ms_dense:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}{floor}"
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
                    fp64_instructions=instructions,
                    pipe_floor_ms=floor_ms,
                    sm_clock=clock,
                    interactions=nr * n * m,
                )
            elif rows is None and refinements == REFINEMENTS:
                record.update(
                    ms_f32=ms, bound_ms_f32=bound_ms, fp32_instructions=instructions, pipe_floor_ms_f32=floor_ms
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


def nodes_bound(dtype, nt, nc, nq, nl, n, own):
    """(bound_ms, bound_by) of `tile_nodes`: every input read once (the
    panels' nodes and the rows' node ids as int32) and the two node-column
    tensors [n, 9, nt] written once over the memory rate, against the
    operations of the fewest-operation form of the function over the peak
    rate, a multiply-add as two and an rsqrt as one, over the (row, panel)
    pairs this run's rows need (`own` of the nt * nc pairs are own-cell
    pairs, left out):

    - 39 per (row, panel point): R 3, r^2 5, the rsqrt 1, 1/r^2 and 1/r^3
      2, R.N 5, K's factor (R.N / r^2) / r^3 2, the dyad R_a R_b 6, G's six
      distinct entries 9 (three of them a multiply-add with 1/r), W.n's 6;
    - 24 per (row, panel point, local node): each of the 12 distinct sums
      (6 of V, 6 of K, both blocks symmetric) one multiply-add of the
      weight;
    - 12 adds per (row, slot) beyond the first slot of each node column:
      a row's S slots go into n - 1 columns (its own node's column takes
      none of them), S - (n - 1) adds of 12 sums;
    - 12 per (row, node): 1/8pi and 3/4pi on the distinct entries.

    (`slots_bound`'s count of `tile_slots`, 52 + 24 + 27, multiplies the
    constants in per sample and masks and signs each slot in floating
    point; this function needs neither.)"""
    item = torch.finfo(dtype).bits // 8
    nbytes = item * (3 * nt + nc * nq * (6 + nl) + 2 * 9 * n * nt) + 4 * (nt + nc * nl)
    pairs = nt * nc - own
    flops = pairs * nq * (39 + 24 * nl) + 12 * (pairs * nl - nt * (n - 1)) + 12 * nt * n
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
            keep = slot_kernel.own_cell_keep(tables.cells_nodes_fe, ids, xi)
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
        cells = tables.cells_nodes_fe
        blocks = [
            (sp[t0 : t0 + T].contiguous(), slot_kernel.own_cell_keep(cells, ids[t0 : t0 + T], sp))
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
        inc = (tables.inc_slot, tables.inc_mask)
        gather_ms = cuda_ms(
            lambda: (slot_kernel.gather_reduce(V, *inc), slot_kernel.gather_reduce(K, *inc)), reps=3
        )
        del V, K
        nc, nq, nl = wphi.shape
        nt = sp.shape[0]
        bound_ms, bound_by = slots_bound(dtype, nt, nc, nq, nl)
        log(
            f"tile_slots (K6) sphere{REFINEMENTS} {str(dtype)[6:]} rows={nt} panels={nc} nq={nq} nl={nl}, "
            f"{len(blocks)} row blocks of {T}: kernel {ms:.3f} ms ({nt * nc * nq / (ms * 1e-3):.4e} "
            f"evaluations/s, {2 * 9 * nc * nl * nt * torch.finfo(dtype).bits / 8 / (ms * 1e-3) / 1e12:.3f} TB/s stored), "
            f"plain {t_plain:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}, max abs err {abs_err:.3e}; "
            f"gather-reduce of one {T}-row block (V and K) {gather_ms:.3f} ms"
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
        f"assemble_V_K create_sphere({REFINEMENTS}) f64 on the card, gather (tile_nodes) against node mode: "
        f"V {err_v:.3e} K {err_k:.3e} of max (tol 1e-10)"
    )
    if not (err_v <= 1e-10 and err_k <= 1e-10):
        raise AssertionError("the gather assembly disagrees with node mode on the card")
    return records[torch.float64]


def phase_nodes_vs_plain(slot_kernel, node_kernel, device, counts):
    """K6's node-column entry point `tile_nodes` against its plain version;
    returns the record of all rows of create_sphere(5), f64 (with the f32
    time and bound), timed beside the old route, K1's node bulk and the
    relayout in the same call."""
    from bemstokes_tpu_torch.ops import assemble

    cases = [
        ("sphere3_Q1", 3, 1, False),
        ("sphere3_Q2", 3, 2, False),
        (f"sphere{REFINEMENTS}_Q1_block", REFINEMENTS, 1, True),
    ]
    V64 = K64 = None
    for dtype in (torch.float64, torch.float32):
        tol = TOL_SLOTS[dtype]
        for name, refinements, degree, main_shape in cases:
            tables, euler, sp, xq, nrm, wphi = slot_case(refinements, degree, dtype, device)
            groups = slot_kernel.node_groups(tables)
            # one row block as `_panel_bulk` cuts them on the card (f64 rows
            # at both types, so that f32 can be held against the f64 kernel)
            T = assemble.node_block_rows(with_cfg(tables, dtype=torch.float64)) if main_shape else sp.shape[0]
            xi = sp[:T].contiguous()
            ids = torch.arange(xi.shape[0], device=device)
            V, K = slot_kernel.tile_nodes(xi, xq, nrm, wphi, ids, groups)
            V2, K2 = slot_kernel.tile_nodes(xi, xq, nrm, wphi, ids, groups)
            torch.cuda.synchronize()
            if not (torch.equal(V, V2) and torch.equal(K, K2)):
                raise AssertionError(f"tile_nodes {name}: two calls gave different bits")
            del V2, K2
            Vr, Kr = slot_kernel.tile_nodes_reference(xi, xq, nrm, wphi, ids, groups)
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
                f"tile_nodes (K6) {name} {str(dtype)[6:]} rows={xi.shape[0]} nodes={groups.n_nodes} panels={nc} "
                f"nq={nq} nl={nl}, {groups.n_groups} groups of <= {groups.group_max} nodes, panels evaluated per "
                f"panel {groups.redundancy:.3f}: rel err V {rel_v:.3e} K {rel_k:.3e} (tol {tol:.0e}), "
                f"same bits twice{far}"
            )
            if not (finite and rel_v <= tol and rel_k <= tol):
                raise AssertionError(f"tile_nodes disagrees with its plain version on {name} {dtype}")
            del V, K, Vr, Kr
            torch.cuda.empty_cache()

    records = {}
    for dtype in (torch.float64, torch.float32):
        tables, euler, sp, xq, nrm, wphi = slot_case(REFINEMENTS, 1, dtype, device)
        groups = slot_kernel.node_groups(tables)
        nt, (nc, nq, nl), n = sp.shape[0], wphi.shape, groups.n_nodes
        ids = torch.arange(nt, device=device)
        T = assemble.node_block_rows(tables)
        blocks = [(sp[t0 : t0 + T].contiguous(), ids[t0 : t0 + T]) for t0 in range(0, nt, T)]

        def all_blocks():
            return [slot_kernel.tile_nodes(xi, xq, nrm, wphi, b, groups) for xi, b in blocks]

        ms = cuda_ms(all_blocks, reps=5)
        clock = clock_under_load(all_blocks)
        instructions, floor_ms = pipe_floor(
            counts["tile_nodes", dtype], dtype, nt, groups.union_panels, nq, sm_clock_mhz(clock)
        )
        # the plain version over the same blocks (the main path's), one run:
        # the largest difference over all blocks, held against TOL_SLOTS
        # relative to the largest entry
        t_plain = 0.0
        err, top = {"V": 0.0, "K": 0.0}, {"V": 0.0, "K": 0.0}
        for xi, b in blocks:
            V, K = slot_kernel.tile_nodes(xi, xq, nrm, wphi, b, groups)
            (Vr, Kr), t = event_ms(lambda: slot_kernel.tile_nodes_reference(xi, xq, nrm, wphi, b, groups))
            t_plain += t
            for key, A, B in (("V", V, Vr), ("K", K, Kr)):
                if not bool(torch.isfinite(A).all()):
                    raise AssertionError(f"tile_nodes sphere{REFINEMENTS} {dtype}: non-finite node columns")
                err[key] = max(err[key], (A - B).abs().max().item())
                top[key] = max(top[key], B.abs().max().item())
            del V, K, Vr, Kr
        torch.cuda.empty_cache()
        abs_err = max(err.values())
        bulk_rel = {key: err[key] / top[key] for key in err}
        if max(bulk_rel.values()) > TOL_SLOTS[dtype]:
            raise AssertionError(
                f"tile_nodes disagrees with its plain version over the sphere{REFINEMENTS} bulk {dtype}: "
                f"rel err V {bulk_rel['V']:.3e} K {bulk_rel['K']:.3e} (tol {TOL_SLOTS[dtype]:.0e})"
            )
        # the old route: the slot tensors of `tile_slots`, then the gather-reduce
        Ts = assemble.slot_block_rows(tables)
        slot_blocks = [
            (sp[t0 : t0 + Ts].contiguous(), slot_kernel.own_cell_keep(groups.cells_fe, ids[t0 : t0 + Ts], sp))
            for t0 in range(0, nt, Ts)
        ]

        def old_route():
            for xi, keep in slot_blocks:
                Vs, Ks = slot_kernel.tile_slots(xi, xq, nrm, wphi, keep)
                slot_kernel.gather_reduce(Vs, groups.inc_slot, groups.inc_mask)
                slot_kernel.gather_reduce(Ks, groups.inc_slot, groups.inc_mask)
                del Vs, Ks

        old_ms = cuda_ms(old_route, reps=2)
        del slot_blocks
        torch.cuda.empty_cache()
        # K1's node bulk: the column sample tables and the sweep
        node_tables = with_cfg(tables, column_mode="node")
        node_inputs_ms = cuda_ms(lambda: assemble.node_sweep_inputs(euler, sp, node_tables), reps=3)
        args = assemble.node_sweep_inputs(euler, sp, node_tables)
        k1_ms = cuda_ms(lambda: node_kernel.node_sweep(*args), reps=3)
        del args
        # the relayout of the node columns [n, 9, T] into the dense operators
        columns = all_blocks()
        dense = torch.empty((3, nt, 3, n), dtype=dtype, device=device)

        def relayout():
            for k, pair in enumerate(columns):
                for Mt in pair:
                    dense[:, k * T : (k + 1) * T] = Mt.reshape(n, 3, 3, -1).permute(1, 3, 2, 0)

        relayout_ms = cuda_ms(relayout, reps=3)
        del columns, dense
        torch.cuda.empty_cache()
        bulk_ms = cuda_ms(lambda: assemble._panel_bulk(euler, sp, ids, tables), reps=2)
        # own-cell pairs of these rows: each row's node's valence
        valence = np.bincount(groups.cells_fe.reshape(-1), minlength=n)
        own = int(valence[ids.cpu().numpy()].sum())
        bound_ms, bound_by = nodes_bound(dtype, nt, nc, nq, nl, n, own)
        # a block's shared memory (csrc/tile_slots.cu `node_smem`): the
        # accumulators [group][12][32 rows], two stages of a panel a warp,
        # the group's round tables
        item = torch.finfo(dtype).bits // 8
        warps = slot_kernel.NODE_GROUP_WARPS
        smem = (
            groups.group_max * 12 * 32 * item
            + 2 * warps * nq * (6 + nl) * item
            + groups.round_max * warps * (1 + 2 * nl) * 4
        )
        log(
            f"tile_nodes (K6) sphere{REFINEMENTS} {str(dtype)[6:]} rows={nt} nodes={n} panels={nc} nq={nq} "
            f"nl={nl}, {len(blocks)} row blocks of {T}, {groups.n_groups} groups, panels evaluated per panel "
            f"{groups.redundancy:.4f}, rounds {groups.round_fill:.3f} full, {smem} B of shared memory a block: "
            f"kernel {ms:.3f} ms, plain {t_plain:.3f} ms, bound {bound_ms:.3f} ms by {bound_by}, "
            f"{instructions:.2f} {'FP64' if dtype == torch.float64 else 'FP32'} instructions a (row, panel "
            f"point), pipe floor {floor_ms:.3f} ms, max abs err {abs_err:.3e}, rel err V {bulk_rel['V']:.3e} "
            f"K {bulk_rel['K']:.3e} (tol {TOL_SLOTS[dtype]:.0e}); SM clock, its maximum and power "
            f"under this load: {clock}; in the same call: old route (tile_slots and the gather-reduce) "
            f"{old_ms:.3f} ms, K1's node bulk {k1_ms:.3f} ms (its column sample tables {node_inputs_ms:.3f} ms), "
            f"relayout of the node columns into the dense V and K {relayout_ms:.3f} ms, "
            f"the whole gather bulk (_panel_bulk) {bulk_ms:.3f} ms"
        )
        records[dtype] = dict(
            max_abs_err=abs_err,
            ms=ms,
            plain_ms=t_plain,
            bound_ms=bound_ms,
            bound_by=bound_by,
            # no one PyTorch call computes the node columns
            library_ms=None,
            fp64_instructions=instructions,
            pipe_floor_ms=floor_ms,
            sm_clock=clock,
            pairs=nt * nc,
            panels_evaluated_per_panel=groups.redundancy,
            old_route_ms=old_ms,
            node_bulk_k1_ms=k1_ms,
            relayout_ms=relayout_ms,
            gather_bulk_ms=bulk_ms,
        )
        del blocks
        torch.cuda.empty_cache()
    record = records[torch.float64]
    f32 = records[torch.float32]
    record.update(
        ms_f32=f32["ms"],
        bound_ms_f32=f32["bound_ms"],
        fp32_instructions=f32["fp64_instructions"],
        old_route_ms_f32=f32["old_route_ms"],
        node_bulk_k1_ms_f32=f32["node_bulk_k1_ms"],
        gather_bulk_ms_f32=f32["gather_bulk_ms"],
    )
    return record


def with_cfg(tables, **changes):
    """Assembly tables with fields of their AssemblyConfig replaced."""
    return dataclasses.replace(tables, cfg=dataclasses.replace(tables.cfg, **changes))


def phase_kernel_vs_plain(node_kernel, device, counts):
    """Every kernel against its plain version; returns, per kernel, the
    record of the main-path shape (create_sphere(5) whole, f64).  At that
    shape the SM clock is read under load and the pipe floor printed beside
    the time, f64 and f32."""
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
                floor = ""
                if main_shape:
                    clock = clock_under_load(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj, **kw))
                    instructions, floor_ms = pipe_floor(counts[kernel, dtype], dtype, nr, n, m, sm_clock_mhz(clock))
                    floor = (
                        f"; {FLOPS_PER_INTERACTION[kernel]} operations an interaction, "
                        f"{instructions:.2f} {'FP64' if dtype == torch.float64 else 'FP32'} instructions, "
                        f"pipe floor {floor_ms:.3f} ms; SM clock, its maximum and power under this load: {clock}"
                    )
                log(
                    f"{kernel} {name} {str(dtype)[6:]} rows={nr} cols={n} m={m}: "
                    f"rel err V {rel_v:.3e} K {rel_k:.3e} (tol {tol:.0e}), "
                    f"max abs err {abs_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
                    f"bound {bound_ms:.3f} ms by {bound_by} "
                    f"({nr * n * m / (ms * 1e-3):.4e} interactions/s){floor}{far}"
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
                        fp64_instructions=instructions,
                        pipe_floor_ms=floor_ms,
                        sm_clock=clock,
                        interactions=nr * n * m,
                    )
                elif main_shape:
                    records[kernel].update(
                        ms_f32=ms, bound_ms_f32=bound_ms, fp32_instructions=instructions, pipe_floor_ms_f32=floor_ms
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
                # the grand-resistance strategy solves directly: no GMRES
                refactored=res.get("refactored", False),
                converged=res.get("converged", True),
                residual=res["residual"],
                gmres_residual=res.get("gmres_residual", res["residual"]),
                finite=bool(torch.isfinite(res["stokes_forces"]).all())
                and bool(np.all(np.isfinite(res["rigid_velocities"]))),
            )
        )
        return res

    problem.solve_frame = solve_frame
    return records


#: the arrays a frame record keeps beside its scalars
ARRAYS = ("stokes_forces", "rigid_velocities", "rigid_forces_pole")


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
        records[-1]["rigid_velocities"] = np.asarray(res["rigid_velocities"])
        records[-1]["rigid_forces_pole"] = np.asarray(res["rigid_forces_pole"])
        shown = {k: v for k, v in records[-1].items() if k not in ARRAYS}
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
    launches = tally(node_kernel)
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
    return recs


def wall_path(node_kernel, device, name, cfg, frames):
    """One full-width frame loop with the counters zeroed before it."""
    gc.collect()  # the previous path's results, so that the peak is this run's
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(node_kernel)
    t0 = time.perf_counter()
    history, records, _, unknowns = run_simulation(cfg, device, frames)
    wall = time.perf_counter() - t0
    launches = tally(node_kernel)
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


def phase_float32(node_kernel, device):
    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig

    cfg = ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        dtype="float32",
        solver=SolverConfig(tolerance=1e-5),
    )
    zero_counts(node_kernel)
    _, (rec,) = solve_frames(device, cfg, 1)
    launches = tally(node_kernel)
    log(f"f32 free-space frame: launches {launches}")
    if not (rec["converged"] and rec["finite"]):
        raise AssertionError(f"f32 frame failed: {rec}")
    if launches["free_space"] != 1:
        raise AssertionError(f"f32 frame: expected one launch of K1, got {launches}")


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
        zero_counts(node_kernel)
        dense, t_dense = solve_once(matfree_problem(device, kernel, REFINEMENTS, solver=solver))
        dense_launches = tally(node_kernel)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(matfree_node, node_kernel)
        free, t_free = solve_once(
            matfree_problem(device, kernel, REFINEMENTS, solver=solver, matrix_free=True)
        )
        launches = dict(matfree_node.launches)
        shapes = shapes_of(matfree_node, kernel)
        blocks = tally(node_kernel)
        diff = worst_rel(free, dense)
        log(
            f"matrix-free vs materialized ({kernel}, 18,444 unknowns, f64, tolerance 1e-11): max rel "
            f"diff of forces and rigid velocities {diff:.3e} (tol 1e-7); matrix-free {t_free:.3f} s, "
            f"{free['iterations']} iterations, converged {free['converged']}, residual "
            f"{free['residual']:.3e}; materialized {t_dense:.3f} s, {dense['iterations']} iterations; "
            f"K5 launches {launches}, by launch shape {shapes}, node sweeps of the materialized frame "
            f"{dense_launches} and of the block factors {blocks}, "
            f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
        )
        if not (free["converged"] and dense["converged"] and diff <= 1e-7):
            raise AssertionError(f"matrix-free {kernel} frame disagrees with the materialized frame")
        if launches[kernel] < free["iterations"] or sum(launches.values()) != launches[kernel]:
            raise AssertionError(f"matrix-free {kernel}: unexpected K5 launches {launches}")
        check_one_sided("matrix-free vs materialized", kernel, shapes, free["iterations"])
        if dense_launches[kernel] != 1 or blocks[kernel] < 1:
            raise AssertionError(f"matrix-free {kernel}: unexpected node-sweep launches {dense_launches} {blocks}")
        out[kernel] = launches[kernel], shapes
    return out


def phase_capacity(matfree_node, node_kernel, device):
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
        zero_counts(matfree_node, node_kernel)
        prob = matfree_problem(
            device, "free_space", CAPACITY_REFINEMENTS, dtype=dtype, solver=solver,
            matrix_free=True, matfree_block_nodes=1024,
        )
        unknowns = 3 * prob.n + prob.num_rigid
        if (prob.n, unknowns) != (24578, 73740):
            raise AssertionError(f"capacity frame: {prob.n} nodes, {unknowns} unknowns")
        frames = [solve_once(prob) for _ in range(CAPACITY_FRAMES)]
        launches = dict(matfree_node.launches)
        # the block factors: assemble_rows sweeps K1 over row blocks
        blocks = tally(node_kernel)
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
            f"{launches}, by launch shape {shapes}, K1 launches of the block factors {blocks}, "
            f"max_memory_allocated {peak:.3f} GiB; one materialized operator would be "
            f"{(3 * prob.n) ** 2 * torch.finfo(prob.asm_cfg.dtype).bits / 8 / 1e9:.1f} GB"
        )
        if launches["free_space"] < sum(res["iterations"] for res, _ in frames) or sum(launches.values()) != launches["free_space"]:
            raise AssertionError(f"capacity frame {dtype}: unexpected K5 launches {launches}")
        check_one_sided(
            f"capacity frame {dtype}", "free_space", shapes, sum(res["iterations"] for res, _ in frames)
        )
        if blocks["free_space"] < 1:
            raise AssertionError(f"capacity frame {dtype}: the block factors did not launch K1: {blocks}")
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


def counting(module, name, calls):
    """Replace module.name by a wrapper that counts its calls in calls[name];
    returns the original."""
    inner = getattr(module, name)

    def counted(*args, **kwargs):
        calls[name] += 1
        return inner(*args, **kwargs)

    setattr(module, name, counted)
    return inner


def phase_gather_path(node_kernel, slot_kernel, device, node_forces):
    """This slice's path at full width: gather-mode frames (K6's
    `tile_nodes`), one frame through K4 and one f32 gather frame; returns
    the launches of `tile_slots` and of `tile_nodes` on the gather frames,
    and the (row, panel) pairs those `tile_nodes` launches covered per type."""
    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig

    base = dict(grid_type="ImposedVelocity", imposed_component=0)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(node_kernel, slot_kernel)
    # the plain-torch gather-reduce must not run on the card's gather path
    calls = {"gather_reduce": 0}
    inner = counting(slot_kernel, "gather_reduce", calls)
    try:
        unknowns, recs = solve_frames(device, ProblemConfig(assembly_backend="gather", **base), 3)
    finally:
        slot_kernel.gather_reduce = inner
    launches = dict(slot_kernel.launches)
    pairs = dict(slot_kernel.pairs)
    others = dict(node_kernel.launches)
    diffs = [
        float(np.abs(r["stokes_forces"] - f).max() / np.abs(f).max()) for r, f in zip(recs, node_forces)
    ]
    log(
        f"gather path f64: K6 launches {launches}, plain gather-reduce calls {calls['gather_reduce']}, "
        f"node-sweep launches {others}, forces against the node-mode frames {diffs} (tol 1e-8), "
        f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    )
    if unknowns != 3 * (6 * 4**REFINEMENTS + 2) + 6:
        raise AssertionError(f"gather path: {unknowns} unknowns")
    if [r["refactored"] for r in recs] != [True, False, False]:
        raise AssertionError("gather path: frame 0 must factor a fresh LU and frames 1-2 reuse it")
    for r, d in zip(recs, diffs):
        if not (r["converged"] and r["finite"] and r["drag_rel_err"] <= DRAG_TOL and d <= 1e-8):
            raise AssertionError(f"gather frame {r['frame']} failed: drag {r['drag_rel_err']}, diff {d}")
    if launches["tile_nodes"] < 3 or launches["tile_slots"] or calls["gather_reduce"] or any(others.values()):
        raise AssertionError(f"gather path: unexpected launches {launches} {others} or calls {calls}")

    # one frame with the node sweep stored component-major (K4)
    zero_counts(node_kernel, slot_kernel)
    _, (rec,) = solve_frames(device, ProblemConfig(assembly_backend="node_planes", **base), 1)
    planes = tally(node_kernel)
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
    zero_counts(slot_kernel)
    _, (rec32,) = solve_frames(device, cfg32, 1)
    launches32 = dict(slot_kernel.launches)
    log(f"f32 gather frame: K6 launches {launches32}")
    if not (rec32["converged"] and rec32["finite"] and rec32["drag_rel_err"] <= DRAG_TOL):
        raise AssertionError(f"f32 gather frame failed: {rec32['drag_rel_err']}")
    if launches32["tile_nodes"] < 1 or launches32["tile_slots"]:
        raise AssertionError(f"f32 gather frame: unexpected launches {launches32}")
    launches["tile_nodes"] += launches32["tile_nodes"]
    pairs["f32"] += slot_kernel.pairs["f32"]
    errors = own_node_errors(device)
    # own-cell pairs are masked in the gather bulk: no entry is a sum of
    # large cancelling terms there (node mode's own-node entries are ~1e-2)
    if not errors["gather", "bulk"][0] <= 1e-3:
        raise AssertionError("the f32 gather bulk of K is further from f64 than 1e-3 of max|K|")
    return launches["tile_slots"], launches["tile_nodes"], pairs


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


def write_translation_gait(folder, refinements):
    """A gait of three gmsh files `gait_<k>.msh` in folder: create_sphere(
    refinements) growing into a pear along x (the fore end by 4 % a frame);
    returns the frame-0 mesh."""
    import os

    from bemstokes_tpu_torch.mesh import create_sphere

    mesh = create_sphere(refinements=refinements)
    for k in range(3):
        scale = 1.0 + 0.04 * k * mesh.vertices[:, :1]
        write_msh(os.path.join(folder, f"gait_{k}.msh"), mesh.vertices * scale, mesh.cells)
    return mesh


def translation_config(grids, **kw):
    """The frame loop over write_translation_gait's files, rigid
    displacements on every axis."""
    from bemstokes_tpu_torch.config import ProblemConfig

    return ProblemConfig(
        grid_type="Real",
        n_frames=3,
        time_step=0.1,
        input_grid_path=grids,
        input_grid_base_name="gait_",
        input_grid_format="msh",
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        **kw,
    )


def phase_command_line():
    """`python3 -m bemstokes_tpu_torch run` as a subprocess on the card: a
    gait of three frame mesh files (create_sphere(5) growing into a pear
    along x), gather mode, frames 0 and 1."""
    import os

    from bemstokes_tpu_torch.config_io import save_config
    from bemstokes_tpu_torch.swimmer import SwimmerState

    with tempfile.TemporaryDirectory() as tmp:
        grids = os.path.join(tmp, "grids")
        os.makedirs(grids)
        mesh = write_translation_gait(grids, REFINEMENTS)
        cfg = translation_config(grids + os.sep, assembly_backend="gather")
        params, out = os.path.join(tmp, "params.json"), os.path.join(tmp, "out")
        prof = os.path.join(tmp, "profile")
        save_config(cfg, params)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "bemstokes_tpu_torch", "run", "-p", params, "0", "2", "-o", out, "--profile", prof],
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
        # the torch.profiler trace of the frame loop names the gather path's
        # kernel among the card's events
        trace = os.path.join(prof, "trace.json")
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        kernels = sorted({e["name"] for e in events if e.get("cat") == "kernel"})
        ours = [name for name in kernels if "tile_nodes_kernel" in name]
        log(
            f"command line: `python3 -m bemstokes_tpu_torch run -p params.json 0 2 -o out --profile DIR`, gait of "
            f"3 gmsh files ({mesh.n_vertices} nodes), gather mode: exit 0 in {seconds:.1f} s; U = "
            f"{[u.tolist() for u in U]}; trace {os.path.getsize(trace) / 2**20:.1f} MiB, {len(events)} events, "
            f"{len(kernels)} kernels on the card, of them {ours}"
        )
        if not ours:
            raise AssertionError(f"command line run: the profiler trace names no tile_nodes kernel: {kernels[:20]}")
        # the fore end grows: the stroke moves the body along x, and only along x
        for u in U:
            if not (used and abs(u[0]) > 1e-3 and np.all(np.abs(u[1:]) < 1e-6 * abs(u[0]) + 1e-9)):
                raise AssertionError(f"command line run: unexpected rigid velocities {u}")


#: phase 16: the non-Direct preconditioners of the monolithic GMRES solve,
#: with the solver's defaults otherwise (restart 100, tolerance 1e-10,
#: max_steps 1000); each frame against phase 5's Direct frame 0
PRECONDITIONER_CASES = (
    ("Jacobi", dict(preconditioner_type="Jacobi")),
    ("SOR", dict(preconditioner_type="SOR")),
    ("SSOR", dict(preconditioner_type="SSOR")),
    ("ILU", dict(preconditioner_type="ILU")),
    ("AMG", dict(preconditioner_type="AMG")),
    ("SSOR, band 100", dict(preconditioner_type="SSOR", bandwith_preconditioner=True, bandwith=100)),
)
TOL_AGAINST_DIRECT = 1e-7
#: phase 18: the BIE field of the translating sphere against the exact
#: Stokes flow.  The port's largest relative error over 512 seeded points in
#: the shell 1.2 <= r <= 5 falls 3.8x a refinement on the CPU (1.40e-2,
#: 3.69e-3, 9.60e-4 at create_sphere(2), (3), (4)), which predicts ~2.5e-4
#: at (5)
FIELD_TOL = 5e-4
#: the single layer of the normal field vanishes off the surface: on the
#: CPU 6.0e-7, 2.3e-7, 6.1e-8 inside at (0.1, 0.1, 0.1) and 3.0e-8, 1.6e-8,
#: 4.8e-9 outside at (4, 4, 4) at create_sphere(2), (3), (4)
SINGLE_LAYER_TOL = 1e-6
FIELD_POINTS = 4096
#: phase 17: the sphere's mobility 6 pi U_x and resistance diagonals (against
#: 6 pi and 8 pi, relative), the off-diagonal entries (over 6 pi), and the
#: mobility beside the no-slip wall against Brenner's (absolute)
RESISTANCE_TOL = dict(mobility=2.5e-4, translation=2.5e-4, rotation=1e-3, off_diagonal=1e-8, brenner=1e-3)


def frame_timed(prob, euler, sdot):
    """One `solve_frame` with the timers reset before it: the result, its
    host-clock ms (device synchronised) and the timers' totals in ms.  The
    timers do not synchronise: a timer's ms is the host's, the card's work
    inside it only where the host blocks on it."""
    from bemstokes_tpu_torch.utils import timers

    timers.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = prob.solve_frame(euler, sdot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return res, ms, {k: v["total_s"] * 1e3 for k, v in timers.as_dict().items()}


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def phase_preconditioners(node_kernel, device, direct):
    """One frame per preconditioner type at 18,444 unknowns against phase
    5's Direct frame 0, and the `print_matrices` dumps on create_sphere(3)."""
    import os

    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    mesh = create_sphere(refinements=REFINEMENTS)
    ref = direct[0]
    for name, solver in PRECONDITIONER_CASES:
        cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, solver=SolverConfig(**solver))
        prob = StokesBEMProblem(mesh, cfg, device=device)
        e0 = prob.initial_euler()
        gc.collect()
        torch.cuda.empty_cache()
        zero_counts(node_kernel)
        res, frame_ms, spent = frame_timed(prob, e0, np.zeros(3 * prob.n))
        launches = tally(node_kernel)
        b_norm = float(torch.linalg.vector_norm(res["rhs"]))
        dU = max_rel(res["rigid_velocities"], ref["rigid_velocities"])
        dF = max_rel(res["rigid_forces_pole"], ref["rigid_forces_pole"])
        dT = max_rel(res["stokes_forces"].cpu().numpy(), ref["stokes_forces"])
        log(
            f"preconditioner {name}: iterations {res['iterations']}, host time of the set-up "
            f"{spent['Preconditioner Set Up']:.1f} ms and of GMRES {spent['GMRES']:.1f} ms, frame "
            f"{frame_ms:.1f} ms; true residual / |b| {res['residual'] / b_norm:.3e} (tol "
            f"{cfg.solver.tolerance:g}); against the Direct frame 0: rigid velocities {dU:.3e}, "
            f"rigid forces {dF:.3e} (tol {TOL_AGAINST_DIRECT:g}), tractions {dT:.3e}; K1 launches "
            f"{launches['free_space']}"
        )
        if not (res["converged"] and res["residual"] <= cfg.solver.tolerance * b_norm):
            raise AssertionError(f"preconditioner {name}: GMRES did not converge")
        if not (dU <= TOL_AGAINST_DIRECT and dF <= TOL_AGAINST_DIRECT):
            raise AssertionError(f"preconditioner {name}: disagrees with the Direct frame")
        if launches != {"free_space": 1, "free_surface": 0, "no_slip": 0, "planes": 0}:
            raise AssertionError(f"preconditioner {name}: expected one launch of K1, got {launches}")
        del prob, res
    gc.collect()
    torch.cuda.empty_cache()

    # print_matrices: the five dumps in the working directory (at full width
    # each text file would hold ~8 GB, so create_sphere(3))
    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, print_matrices=True)
    prob = StokesBEMProblem(create_sphere(refinements=3), cfg, device=device)
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            zero_counts(node_kernel)
            res = prob.solve_frame(prob.initial_euler(), np.zeros(3 * prob.n))
            launches = tally(node_kernel)
        finally:
            os.chdir(cwd)
        names = sorted(os.listdir(tmp))
        A = np.loadtxt(os.path.join(tmp, "monolithic_matrix.txt"))
        M = np.loadtxt(os.path.join(tmp, "Mass_matrix.txt"))
    expected = sorted(
        ["monolithic_matrix.txt", "V_matrix.txt", "K_matrix.txt", "Mass_matrix.txt", "normals_matrix.txt"]
    )
    same = np.array_equal(A, res["A"].cpu().numpy())
    area = abs(M.sum() - float(res["diagnostics"]["mass_body"])) / M.sum()
    log(
        f"print_matrices (create_sphere(3), {A.shape[0]} unknowns): files {names}; monolithic_matrix.txt "
        f"equals the frame's A: {same}; mass matrix sums to the surface area to {area:.1e}; K1 launches "
        f"{launches['free_space']}"
    )
    if not (names == expected and same and area <= 1e-12 and launches["free_space"] == 1):
        raise AssertionError("print_matrices: wrong dumps")


def phase_resistance(node_kernel, device, direct):
    """The grand-resistance strategy (monolithic=False) at 18,444 unknowns:
    the sphere's mobility and resistance matrix in free space, a rigid-motion
    gait against the monolithic Direct frame, and the sphere beside the
    no-slip wall through SwimmerSimulation."""
    import os

    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.problem import StokesBEMProblem
    from bemstokes_tpu_torch.swimmer import SwimmerSimulation, SwimmerState
    from bemstokes_tpu_torch.utils import timers

    mesh = create_sphere(refinements=REFINEMENTS)
    # (a) unit force along x in free space
    cfg = ProblemConfig(grid_type="ImposedForce", imposed_component=0, monolithic=False)
    prob = StokesBEMProblem(mesh, cfg, device=device)
    e0 = prob.initial_euler()
    zero_counts(node_kernel)
    res, frame_ms, spent = frame_timed(prob, e0, np.zeros(3 * prob.n))
    launches = tally(node_kernel)
    tol = RESISTANCE_TOL
    mob = 6 * np.pi * res["rigid_velocities"][0]
    Rm = res["resistance_matrix"]
    d = np.diag(Rm)
    trans = np.abs(d[:3] / (6 * np.pi) - 1).max()
    rot = np.abs(d[3:] / (8 * np.pi) - 1).max()
    off = np.abs(Rm - np.diag(d)).max() / (6 * np.pi)
    log(
        f"resistance, free space, unit force along x: 6 pi U_x = {mob:.8f} (|.-1| {abs(mob - 1):.3e}, tol "
        f"{tol['mobility']:g}); resistance diagonal / (6 pi, 8 pi) "
        f"{(d / np.repeat([6 * np.pi, 8 * np.pi], 3)).tolist()}: translation {trans:.3e} (tol "
        f"{tol['translation']:g}), rotation {rot:.3e} (tol {tol['rotation']:g}), off-diagonal / 6 pi "
        f"{off:.3e} (tol {tol['off_diagonal']:g}); host time of the V LU {spent['Resistance V factor']:.1f} ms and of the D2N {spent['Resistance D2N']:.1f} "
        f"ms, frame {frame_ms:.1f} ms; K1 launches {launches['free_space']}"
    )
    if not (
        abs(mob - 1) <= tol["mobility"]
        and trans <= tol["translation"]
        and rot <= tol["rotation"]
        and off <= tol["off_diagonal"]
    ):
        raise AssertionError("resistance: wrong mobility or resistance matrix")
    if launches["free_space"] != 1:
        raise AssertionError(f"resistance: expected one launch of K1, got {launches}")
    del prob, res

    # a rigid-motion gait (grid Real): the strategy against the monolithic
    # Direct frame of the same gait
    e1 = e0.cpu().numpy() @ rotation(1, 0.01).T + np.array([0.01, -0.005, 0.002])
    U = {}
    for monolithic in (False, True):
        cfg = ProblemConfig(grid_type="Real", force_pole="Origin", monolithic=monolithic)
        prob = StokesBEMProblem(mesh, cfg, device=device)
        sdot = prob.shape_velocities_fd(e0, e1, time_step=0.1)
        zero_counts(node_kernel)
        res = prob.solve_frame(e0, sdot)
        launches = tally(node_kernel)
        U[monolithic] = np.asarray(res["rigid_velocities"])
        if launches["free_space"] != 1:
            raise AssertionError(f"resistance: expected one launch of K1, got {launches}")
        del prob, res
        gc.collect()
        torch.cuda.empty_cache()
    diff = max_rel(U[False], U[True])
    log(f"resistance, rigid-motion gait: U = {U[False].tolist()}, against the monolithic Direct frame {diff:.3e} (tol 1e-7)")
    if not diff <= 1e-7:
        raise AssertionError("resistance: disagrees with the monolithic frame")

    # (b), (c) the sphere sedimenting beside the no-slip wall, two frames
    exact = 1.0 / brenner_lambda(-WALL_Y)
    with tempfile.TemporaryDirectory() as out:
        sim = SwimmerSimulation(wall_config("no_slip", REFINEMENTS, monolithic=False), out, device=device)
        records = timed_solves(sim.problem)
        zero_counts(node_kernel)
        timers.reset()
        history = sim.run(0, 2)
        spent = {k: v["total_s"] * 1e3 for k, v in timers.as_dict().items()}
        launches = tally(node_kernel)
        ok = True
        for k in range(2):
            state = SwimmerState.load(os.path.join(out, f"state_{k}.npz"))
            saved = np.load(os.path.join(out, f"result_{k}.npz"))
            ok = ok and state.frame == k and np.isfinite(state.displacements).all()
            ok = ok and all(np.isfinite(saved[key]).all() for key in saved.files)
            ok = ok and os.path.exists(os.path.join(out, f"stokes_{k}.vtu"))
        series = np.loadtxt(os.path.join(out, "point_velocities.txt"))
        ok = ok and series.shape == (12, 3) and np.isfinite(series).all()
    mobility = [6 * np.pi * h["rigid_velocities"][1] for h in history]
    log(
        f"resistance, no-slip wall, SwimmerSimulation.run(0, 2): 6 pi U_y = {mobility}, Brenner "
        f"{exact:.6f}, frame 0 off by {abs(mobility[0] - exact):.3e} (tol {tol['brenner']:g}); frames "
        f"{[round(r['seconds'], 3) for r in records]} s; host time of the V LU {spent['Resistance V factor']:.1f} ms and of the D2N "
        f"{spent['Resistance D2N']:.1f} ms over both frames; state and output files finite: {ok}; "
        f"K3 launches {launches['no_slip']}"
    )
    if not (ok and abs(mobility[0] - exact) <= tol["brenner"] and mobility[0] < mobility[1]):
        raise AssertionError("resistance beside the wall: wrong mobility or files")
    if launches != {"free_space": 0, "free_surface": 0, "no_slip": 2, "planes": 0}:
        raise AssertionError(f"resistance beside the wall: expected 2 launches of K3 alone, got {launches}")


def exact_translating_sphere(x, U):
    """Stokes flow past a unit sphere translating with velocity U."""
    r = np.linalg.norm(x, axis=1, keepdims=True)
    Ux = (x @ U)[:, None]
    return 0.75 * (U / r + Ux * x / r**3) + 0.25 * (U / r**3 - 3 * Ux * x / r**5)


def shell_points(n, seed, r=(1.2, 5.0)):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return d * rng.uniform(*r, size=(n, 1))


def phase_postprocess(node_kernel, device, direct):
    """The BIE field of phase 5's frame 0, off and on the boundary."""
    from bemstokes_tpu_torch import postprocess
    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.physics.rigid import flatten
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    def solved(refinements, dev):
        cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0)
        prob = StokesBEMProblem(create_sphere(refinements=refinements), cfg, device=dev)
        e0 = prob.initial_euler()
        res = prob.solve_frame(e0, np.zeros(3 * prob.n))
        U = np.asarray(res["rigid_velocities"][:3])
        u_b = torch.as_tensor(np.tile(U, (prob.n, 1)), dtype=torch.float64, device=dev)
        return prob, e0, res, U, flatten(u_b)

    zero_counts(node_kernel)
    prob, e0, res, U, u_flat = solved(REFINEMENTS, device)
    launches = tally(node_kernel)
    f_flat = res["stokes_forces"]
    same = max_rel(f_flat.cpu().numpy(), direct[0]["stokes_forces"])
    if not (same <= 1e-10 and launches["free_space"] == 1):
        raise AssertionError(f"post-processing: frame 0 differs from phase 5's ({same:.3e}) or launches {launches}")
    tables = prob.tables
    pts = shell_points(FIELD_POINTS, seed=2026)
    chunk = postprocess.points_per_chunk(tables.cells_nodes_fe.shape[0] * len(tables.q_weights), 3, torch.float64)

    def field():
        return postprocess.evaluate_stokes_bie(pts, u_flat, f_flat, e0, tables)

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = field().cpu().numpy()
    ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    exact = exact_translating_sphere(pts, U)
    rel_err = np.linalg.norm(u - exact, axis=1) / np.linalg.norm(exact, axis=1)
    n_flat = flatten(res["operators"]["normal"]["normal"])
    single = postprocess.evaluate_stokes_bie(
        [[0.1, 0.1, 0.1], [4.0, 4.0, 4.0]], torch.zeros_like(n_flat), n_flat, e0, tables
    ).abs().max(dim=1).values.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    grad = postprocess.approximate_velocity_gradient(pts[:64], u_flat, f_flat, e0, tables)
    trace = float(torch.diagonal(grad, dim1=-2, dim2=-1).sum(-1).abs().max())
    grad_ms = (time.perf_counter() - t0) * 1e3
    log(
        f"post-processing (create_sphere({REFINEMENTS}), {tables.cells_nodes_fe.shape[0]} panels x "
        f"{len(tables.q_weights)} points): evaluate_stokes_bie at {FIELD_POINTS} points in 1.2 <= r <= 5, "
        f"{ms:.1f} ms ({ms * 1000 / FIELD_POINTS:.1f} ms per 1,000 points), chunks of {chunk} points, "
        f"peak {peak:.2f} GiB; relative error against the exact translating-sphere flow max "
        f"{rel_err.max():.3e} (tol {FIELD_TOL:g}), median {np.median(rel_err):.3e}; single layer of the "
        f"normal inside {single[0]:.3e}, outside {single[1]:.3e} (tol {SINGLE_LAYER_TOL:g}); velocity "
        f"gradient at 64 points in {grad_ms:.1f} ms, max |trace| {trace:.3e} (tol 1e-6)"
    )
    if not (np.isfinite(u).all() and rel_err.max() <= FIELD_TOL):
        raise AssertionError("post-processing: the field disagrees with the exact flow")
    if not (single.max() <= SINGLE_LAYER_TOL and trace <= 1e-6):
        raise AssertionError("post-processing: the single layer of the normal or the trace is off")

    # on the boundary: 256 seeded support points at full width on the card
    sp = support_points(e0, prob.map_space, prob.fe_space)
    pick = np.random.default_rng(7).choice(prob.n, min(256, prob.n), replace=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on = postprocess.evaluate_stokes_bie_on_boundary(sp[pick], u_flat, f_flat, e0, sp, tables)
    torch.cuda.synchronize()
    on_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(on).all())
    del prob, res, f_flat, u_flat, e0
    gc.collect()
    torch.cuda.empty_cache()

    # on the boundary at create_sphere(3): the card against the CPU at
    # every support point, the same fields on both
    prob, e0, res, U, u_flat = solved(3, device)
    sp = support_points(e0, prob.map_space, prob.fe_space)
    args = (sp, u_flat, res["stokes_forces"], e0, sp)
    card = postprocess.evaluate_stokes_bie_on_boundary(*args, prob.tables).cpu().numpy()
    host = postprocess.evaluate_stokes_bie_on_boundary(*(a.cpu() for a in args), prob.tables).numpy()
    diff = max_rel(card, host)
    log(
        f"post-processing on the boundary: {len(pick)} support points of create_sphere({REFINEMENTS}) in "
        f"{on_ms:.1f} ms ({on_ms * 1000 / len(pick):.1f} ms per 1,000 points), finite: {finite}; "
        f"create_sphere(3), all "
        f"{prob.n} support points, the card against the CPU {diff:.3e} (tol 1e-10)"
    )
    if not (finite and diff <= 1e-10):
        raise AssertionError("post-processing on the boundary: wrong values")


#: phase 19: the study's cycles from create_sphere(2) on the card, and how
#: many of them the CPU repeats
CONVERGENCE_CYCLES = 4
CPU_CONVERGENCE_CYCLES = 3
#: torch threads of the CPU study, which runs in a process of its own beside
#: phases 2-18 (its 1,538-node cycle assembles through the plain torch node
#: sweep, a minute or two of the host's CPU)
CPU_CONVERGENCE_THREADS = 2


def convergence_inputs(folder):
    """The gmsh file of create_sphere(2) and the parameter file of phase 19
    in `folder`; returns the params path and the study's arguments."""
    import os

    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.config_io import save_config
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.problem import _resolve_manifold

    cfg = ProblemConfig(
        input_grid_path=folder + os.sep,
        input_grid_base_name="ball_",
        input_grid_format="msh",
        body_manifold="sphere",
    )
    params = os.path.join(folder, "params.json")
    if not os.path.exists(params):
        mesh = create_sphere(refinements=2)
        write_msh(os.path.join(folder, "ball_0.msh"), mesh.vertices, mesh.cells)
        save_config(cfg, params)
    study = dict(
        dim=3,
        source=(0.3, 0.3, 0.3),
        manifold=_resolve_manifold(cfg),
        quad_order=cfg.quadrature.order,
        sing_order=cfg.quadrature.singular_order,
    )
    return params, study


def base_mesh(folder):
    import os

    from bemstokes_tpu_torch.mesh import read_mesh

    return read_mesh(os.path.join(folder, "ball_0.msh"), dim=3, force_material=0)


def cpu_convergence(folder):
    """`chip_smoke.py --cpu-convergence DIR`: phase 19's study on the CPU,
    its first cycles, printed as one JSON list of errors."""
    from bemstokes_tpu_torch.convergence import convergence_study

    torch.set_num_threads(CPU_CONVERGENCE_THREADS)
    _, study = convergence_inputs(folder)
    t0 = time.perf_counter()
    rows = convergence_study(base_mesh(folder), n_cycles=CPU_CONVERGENCE_CYCLES, device="cpu", **study)
    print(json.dumps(dict(errors=[r.error for r in rows], seconds=time.perf_counter() - t0)))
    return 0


def start_cpu_convergence(folder):
    """Phase 19's inputs in `folder`, and its CPU study started beside the
    card's phases."""
    convergence_inputs(folder)
    return subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--cpu-convergence", folder],
        cwd=str(Path(__file__).resolve().parent),
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        text=True,
    )


def phase_convergence(node_kernel, device, folder, cpu_study):
    """`python3 -m bemstokes_tpu_torch convergence` as a subprocess on the
    card, four cycles from create_sphere(2) to 6,146 nodes; the same study
    in this process on the card (its K1 launches counted), and its first
    three cycles on the CPU (the process `start_cpu_convergence` began)."""
    from bemstokes_tpu_torch.convergence import convergence_study, format_table

    params, study = convergence_inputs(folder)
    t0 = time.perf_counter()
    done = subprocess.run(
        [sys.executable, "-m", "bemstokes_tpu_torch", "convergence", "-p", params, "--cycles",
         str(CONVERGENCE_CYCLES), "-o", folder],
        cwd=str(Path(__file__).resolve().parent),
        capture_output=True,
        text=True,
        timeout=600,
    )
    seconds = time.perf_counter() - t0
    if done.returncode != 0:
        raise AssertionError(f"the convergence command exited {done.returncode}:\n{done.stderr[-2000:]}")
    printed = done.stdout.strip()
    zero_counts(node_kernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = convergence_study(base_mesh(folder), n_cycles=CONVERGENCE_CYCLES, device=device, **study)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = tally(node_kernel)
    out, err = cpu_study.communicate(timeout=900)
    if cpu_study.returncode != 0:
        raise AssertionError(f"the CPU convergence study exited {cpu_study.returncode}:\n{err[-2000:]}")
    host = json.loads(out.strip().splitlines()[-1])
    for line in printed.splitlines():
        log(f"convergence: {line}")
    diff = max(abs(c.error - h) / h for c, h in zip(card, host["errors"]))
    log(
        f"convergence: `python3 -m bemstokes_tpu_torch convergence -p params.json --cycles "
        f"{CONVERGENCE_CYCLES}` exit 0 in {seconds:.1f} s, its table equal to the in-process study's on "
        f"the card ({card_s:.1f} s, K1 launches {launches['free_space']}): {printed == format_table(card)}; "
        f"the first {len(host['errors'])} errors against the CPU study ({host['seconds']:.1f} s on "
        f"{CPU_CONVERGENCE_THREADS} threads beside the card's phases) {diff:.3e} (tol 1e-8)"
    )
    if not (printed == format_table(card) and [r.n_nodes for r in card] == [98, 386, 1538, 6146]):
        raise AssertionError("convergence: the command's table differs from the study")
    if len(host["errors"]) != CPU_CONVERGENCE_CYCLES or not diff <= 1e-8:
        raise AssertionError(f"convergence: the card and the CPU differ by {diff:.3e}")
    if not (all(r.rate > 0 for r in card[1:]) and launches["free_space"] == CONVERGENCE_CYCLES):
        raise AssertionError(f"convergence: rates {[r.rate for r in card]}, launches {launches}")


#: phase 20: the 10-cell unit circle built in code, ordered clockwise (the
#: reference's tests/grid_test/circle_0.inp), refined onto the circle:
#: 10 times for the materialized frames (10,240 line cells, Q1: 10,240 nodes,
#: 20,483 unknowns), 8 times for the matrix-free frame (2,560 nodes, 5,123
#: unknowns)
CIRCLE_REFINEMENTS = 10
CIRCLE_MATFREE_REFINEMENTS = 8
#: the f32 frame's size, 5,120 nodes: at 10,240 the first point of the
#: singular rule lies 6.3e-8 from its node, within an f32 coordinate's
#: rounding, so R = 0 there and the singular delta is not finite, in the JAX
#: package's f32 as in the port's
CIRCLE_F32_REFINEMENTS = 9
#: the spinning gait's angle between its two frames (tests/test_2d_problem.py)
CIRCLE_ALPHA = 0.04
CIRCLE_CONVERGENCE_CYCLES = 8  # 10 -> 1,280 nodes
CIRCLE_CPU_CYCLES = 6  # 10 -> 320 nodes, computed here on CPU tensors
CIRCLE_FIELD_POINTS = 1024
#: what phase 20 holds its numbers to, relative unless stated: the gather
#: frame against the node frame's forces, the f32 frame against an f64 frame
#: of its size (the port's f32 frame on the CPU is 1.1e-5, 3.1e-5, 8.0e-5
#: from f64 at 80, 160, 320 nodes, ~2.7x a refinement: ~4e-3 at 5,120; on
#: the card 6.7e-3); the duality U_x R_xx = 1
#: (tests/test_2d_problem.py); the resistance matrix against the monolithic
#: frame's forces; the matrix-free frame against the materialized one; the
#: spinning gait's U[2] against -alpha / dt (the JAX test's bound) and the
#: saved angle against dt U[2] (absolute); the convergence study's first
#: cycles against the CPU's; the field against the exact flow (the JAX
#: package's largest error over the same 1,024 points, 1.252e-4 and 3.115e-5
#: at 160 and 320 nodes, falls 4.02x a refinement: ~3e-8 at 10,240 nodes)
CIRCLE_TOL = dict(
    gather=1e-10,
    f32=5e-2,
    duality=1e-8,
    resistance=1e-8,
    matfree=1e-7,
    gait=2e-2,
    angle=1e-12,
    convergence=1e-10,
    field=1e-7,
)


def circle_mesh(refinements):
    """The 10-cell unit circle ordered clockwise, so that each cell's normal
    (the left rotation of its tangent) points outward, refined `refinements`
    times onto the circle."""
    from bemstokes_tpu_torch.mesh import SurfaceMesh
    from bemstokes_tpu_torch.mesh.refine import SphericalManifold, refine_uniform

    th = -2.0 * np.pi * np.arange(10) / 10
    mesh = SurfaceMesh(
        np.stack([np.cos(th), np.sin(th)], axis=1),
        np.stack([np.arange(10), (np.arange(10) + 1) % 10], axis=1),
        np.zeros(10, np.int32),
    )
    return refine_uniform(mesh, SphericalManifold((0.0, 0.0)), times=refinements) if refinements else mesh


def write_inp(path, vertices, cells):
    """An AVS UCD file of a line-cell mesh in the plane."""
    with open(path, "w") as f:
        f.write(f"{len(vertices)} {len(cells)} 0 0 0\n")
        np.savetxt(f, np.column_stack([np.arange(1, len(vertices) + 1), vertices, np.zeros(len(vertices))]),
                   fmt="%d %.17g %.17g %g")
        for i, c in enumerate(cells):
            f.write(f"{i + 1} 0 line {c[0] + 1} {c[1] + 1}\n")


def rotation_2d(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def timed_stage(stages, name, fn):
    """fn with its synchronised host-clock ms added to stages[name]."""

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        stages[name] = stages.get(name, 0.0) + (time.perf_counter() - t0) * 1e3
        return out

    return wrapper


@contextlib.contextmanager
def circle_stages(stages):
    """Time the stages of a 2D frame while the block runs: the plain-torch
    bulk, the singular delta, the L2-normal CG, the LU factor and GMRES."""
    import bemstokes_tpu_torch.ops.assemble as asm
    import bemstokes_tpu_torch.problem as problem
    from bemstokes_tpu_torch.la.direct import LUPreconditioner

    targets = [
        (asm, "_bulk_2d", "bulk"),
        (asm, "_add_singular_rows", "singular delta"),
        (problem, "normal_vector_l2", "L2 normal"),
        (LUPreconditioner, "set_up", "LU"),
        (problem.StokesBEMProblem, "_gmres_direct", "GMRES"),
    ]
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in targets]
    for owner, name, label in targets:
        setattr(owner, name, timed_stage(stages, label, getattr(owner, name)))
    try:
        yield
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


def circle_problem(device, refinements, **kw):
    from bemstokes_tpu_torch.config import ProblemConfig
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    kw = {"grid_type": "ImposedVelocity", "imposed_component": 2, **kw}
    return StokesBEMProblem(circle_mesh(refinements), ProblemConfig(dim=2, force_pole="Origin", **kw), device=device)


def circle_frame(prob, euler, stages=None):
    """One timed frame of a circle problem (stages timed into `stages`): the
    result with its operators dropped, and the frame's ms."""
    sdot = torch.zeros(2 * prob.n, dtype=torch.float64, device=prob.device)
    with circle_stages(stages if stages is not None else {}):
        res, ms, spent = frame_timed(prob, euler, sdot)
    for key in ("operators", "A", "rhs"):
        res.pop(key, None)
    return res, ms, spent


def port_launches(*modules):
    """Every CUDA-kernel counter of the port's wrapper modules, summed."""
    return sum(sum(getattr(mod, "launches").values()) for mod in modules)


def phase_2d(node_kernel, matfree_node, slot_kernel, device):
    """The 2D problem on the card (no kernel: the 2D bulk and matvec are
    plain torch, as the JAX package keeps 2D on its XLA path): materialized
    frames of the rotating circle at 10,240 nodes in node, gather and f32
    form; force/velocity duality; the resistance strategy; the matrix-free
    frame at 2,560 nodes against the materialized one; the spinning gait
    through the command line; the convergence command; the field."""
    import os

    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig
    from bemstokes_tpu_torch.config_io import save_config
    from bemstokes_tpu_torch.convergence import convergence_study, format_table
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.mesh import read_mesh
    from bemstokes_tpu_torch.postprocess import evaluate_stokes_bie
    from bemstokes_tpu_torch.problem import _resolve_manifold
    from bemstokes_tpu_torch.swimmer import SwimmerState

    tol = CIRCLE_TOL
    out = {}
    zero_counts(node_kernel, matfree_node, slot_kernel)

    # an 80-node frame first, untimed: frame 0 below does not pay the first
    # use of the 2D route's operations in this process
    warm = circle_problem(device, 3)
    circle_frame(warm, warm.initial_euler())
    del warm

    # (a) materialized frames at 10,240 nodes: fresh, then two stale (the
    # circle turned and moved), node mode
    torch.cuda.reset_peak_memory_stats()
    prob = circle_problem(device, CIRCLE_REFINEMENTS)
    e0 = prob.initial_euler()
    e0_np = e0.cpu().numpy()
    frames = [e0_np, e0_np @ rotation_2d(0.1).T + [0.05, -0.02], e0_np @ rotation_2d(-0.2).T + [-0.1, 0.03]]
    records = []
    for k, e in enumerate(frames):
        stages = {}
        res, ms, _ = circle_frame(prob, torch.as_tensor(e, device=device), stages)
        records.append(dict(frame=k, ms=ms, stages=stages, iterations=res["iterations"],
                            refactored=res["refactored"], converged=res["converged"]))
        if k == 0:
            node0 = res
            # about the origin, which is the centre of frame 0 alone
            records[0]["torque_rel_err"] = float(np.asarray(res["rigid_forces_pole"])[2] / (4 * np.pi) - 1)
        log(f"2D frame {k}, {2 * prob.n + 3} unknowns, f64 node mode: " + json.dumps(records[-1]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    forces0 = node0["stokes_forces"].cpu().numpy()
    F0 = np.asarray(node0["rigid_forces_pole"])
    if not (records[0]["refactored"] and not any(r["refactored"] for r in records[1:])
            and all(r["converged"] for r in records)):
        raise AssertionError(f"2D frames: expected one fresh LU and two stale converged frames: {records}")
    if not abs(records[0]["torque_rel_err"]) < 1e-6:
        raise AssertionError(f"2D frames: torque off 4 pi by {records[0]['torque_rel_err']:.3e}")
    out["frames"] = records
    out["peak_gib"] = peak

    # the field of the rotating circle (g), from frame 0 while its problem lives
    rng = np.random.default_rng(20)
    ang = rng.uniform(0.0, 2.0 * np.pi, CIRCLE_FIELD_POINTS)
    rad = rng.uniform(1.2, 5.0, CIRCLE_FIELD_POINTS)
    pts = np.stack([rad * np.cos(ang), rad * np.sin(ang)], axis=1)
    exact = np.stack([-pts[:, 1], pts[:, 0]], axis=1) / rad[:, None] ** 2  # u_theta = omega a^2 / r
    sp = support_points(e0, prob.map_space, prob.fe_space)
    u_b = torch.cat([-sp[:, 1], sp[:, 0]])  # the rigid rotation on the boundary
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    u = evaluate_stokes_bie(pts, u_b, node0["stokes_forces"], e0, prob.tables).cpu().numpy()
    torch.cuda.synchronize()
    field_ms = (time.perf_counter() - t0) * 1e3
    field_err = float((np.linalg.norm(u - exact, axis=1) / np.linalg.norm(exact, axis=1)).max())
    out["field"] = dict(points=CIRCLE_FIELD_POINTS, ms=field_ms, max_rel_err=field_err)
    log(f"2D field at {CIRCLE_FIELD_POINTS} points in 1.2 <= r <= 5: {field_ms:.1f} ms, largest error "
        f"against u_theta = 1/r {field_err:.3e} (tol {tol['field']:g})")
    if not field_err <= tol["field"]:
        raise AssertionError("2D field: off the exact flow")
    del prob, node0, sp, u_b
    gc.collect()
    torch.cuda.empty_cache()

    # one gather-mode frame against the node-mode forces; an f32 frame
    # against an f64 frame of its size
    reference = {CIRCLE_REFINEMENTS: forces0}
    for name, refinements, kw in (
        ("gather", CIRCLE_REFINEMENTS, dict(assembly_backend="gather")),
        ("f64", CIRCLE_F32_REFINEMENTS, {}),
        ("f32", CIRCLE_F32_REFINEMENTS, dict(dtype="float32", solver=SolverConfig(tolerance=1e-5))),
    ):
        prob = circle_problem(device, refinements, **kw)
        stages = {}
        res, ms, _ = circle_frame(prob, prob.initial_euler(), stages)
        forces = res["stokes_forces"].double().cpu().numpy()
        if name == "f64":
            reference[refinements] = forces
            out["f64_at_f32_size"] = dict(nodes=prob.n, ms=ms, stages=stages)
            del prob, res
            continue
        diff = max_rel(forces, reference[refinements])
        out[name] = dict(nodes=prob.n, ms=ms, stages=stages, iterations=res["iterations"], forces_rel_diff=diff)
        log(f"2D frame, {name}: " + json.dumps(out[name]) + f" (tol {tol[name]:g})")
        if not (res["converged"] and diff <= tol[name]):
            raise AssertionError(f"2D {name} frame: forces {diff:.3e} from the node-mode frame")
        del prob, res
        gc.collect()
        torch.cuda.empty_cache()

    # (b) force/velocity duality: U_x of a unit x-force against the x-drag
    R_xx = None
    for grid in ("ImposedVelocity", "ImposedForce"):
        prob = circle_problem(device, CIRCLE_REFINEMENTS, grid_type=grid, imposed_component=0)
        res, ms, _ = circle_frame(prob, prob.initial_euler())
        if grid == "ImposedVelocity":
            R_xx = float(np.asarray(res["rigid_forces_pole"])[0])
        else:
            U = np.asarray(res["rigid_velocities"])
        del prob, res
        gc.collect()
        torch.cuda.empty_cache()
    duality = abs(U[0] * R_xx - 1.0)
    out["duality"] = dict(R_xx=R_xx, U_x=float(U[0]), rel_err=duality)
    log(f"2D duality: R_xx = {R_xx:.12g}, U_x = {U[0]:.12g}, |U_x R_xx - 1| = {duality:.3e} (tol "
        f"{tol['duality']:g}); U_y, omega = {U[1]:.3e}, {U[2]:.3e}")
    if not (duality <= tol["duality"] and abs(U[1]) < 1e-10 and abs(U[2]) < 1e-10):
        raise AssertionError("2D duality: mobility is not the inverse of the drag")

    # (c) the resistance strategy on the rotating circle
    prob = circle_problem(device, CIRCLE_REFINEMENTS, monolithic=False)
    res, ms, spent = circle_frame(prob, prob.initial_euler())
    Rm = res["resistance_matrix"]
    diff = max_rel(Rm[:, 2], F0)
    out["resistance"] = dict(ms=ms, v_lu_host_ms=spent["Resistance V factor"], d2n_host_ms=spent["Resistance D2N"],
                             torque_rel_err=float(Rm[2, 2] / (4 * np.pi) - 1), against_monolithic=diff)
    log("2D resistance: " + json.dumps(out["resistance"]) + f" (tol {tol['resistance']:g}); R = {Rm.tolist()}")
    if not diff <= tol["resistance"]:
        raise AssertionError("2D resistance: its matrix disagrees with the monolithic frame")
    del prob, res
    gc.collect()
    torch.cuda.empty_cache()

    # (d) matrix-free at 2,560 nodes against the materialized frame
    solver = SolverConfig(tolerance=1e-11)
    rec = {}
    for mf in (False, True):
        prob = circle_problem(device, CIRCLE_MATFREE_REFINEMENTS, matrix_free=mf, matfree_block_nodes=1024,
                              solver=solver)
        res, ms, _ = circle_frame(prob, prob.initial_euler())
        rec[mf] = (res["stokes_forces"].cpu().numpy(), res["iterations"], ms, res["converged"])
        if mf:
            sys_, _, _ = prob._matfree._setup(prob.initial_euler(), torch.zeros(2 * prob.n, dtype=torch.float64,
                                                                                  device=device), None)
            mv = prob._matfree._matvec(sys_)
            x = torch.randn(2 * prob.n + 3, dtype=torch.float64, device=device)
            action_ms = cuda_ms(lambda: mv(x), 5)
            del sys_, mv
        del prob, res
        gc.collect()
        torch.cuda.empty_cache()
    diff = max_rel(rec[True][0], rec[False][0])
    out["matrix_free"] = dict(nodes=2560, iterations=rec[True][1], ms=rec[True][2], action_ms=action_ms,
                              materialized_ms=rec[False][2], forces_rel_diff=diff)
    log("2D matrix-free: " + json.dumps(out["matrix_free"]) + f" (tol {tol['matfree']:g})")
    if not (rec[True][3] and diff <= tol["matfree"]):
        raise AssertionError("2D matrix-free frame: disagrees with the materialized frame")

    with tempfile.TemporaryDirectory() as tmp:
        # (e) the spinning gait through the command line
        mesh = circle_mesh(CIRCLE_REFINEMENTS)
        write_inp(os.path.join(tmp, "spin_0.inp"), mesh.vertices, mesh.cells)
        write_inp(os.path.join(tmp, "spin_1.inp"), mesh.vertices @ rotation_2d(CIRCLE_ALPHA).T, mesh.cells)
        cfg = ProblemConfig(dim=2, input_grid_path=tmp + os.sep, input_grid_base_name="spin_",
                            input_grid_format="inp", n_frames=2, time_step=0.1, grid_type="Real",
                            force_pole="Origin", consider_rigid_rotations=True,
                            solver=SolverConfig(solve_directly=True))
        params, run_out = os.path.join(tmp, "params.json"), os.path.join(tmp, "out")
        save_config(cfg, params)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "bemstokes_tpu_torch", "run", "--dim", "2", "-p", params, "0", "1", "-o", run_out],
            cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError(f"the 2D command line run exited {done.returncode}:\n{done.stderr[-2000:]}")
        U = np.load(os.path.join(run_out, "result_0.npz"))["rigid_velocities"]
        rot = SwimmerState.load(os.path.join(run_out, "state_0.npz")).rotation
        omega = -CIRCLE_ALPHA / cfg.time_step
        gait = abs(U[2] - omega) / abs(omega)
        angle = abs(np.arctan2(rot[1, 0], rot[0, 0]) - cfg.time_step * U[2])
        files = all(os.path.exists(os.path.join(run_out, f)) for f in ("stokes_0.vtu", "point_velocities.txt"))
        out["gait"] = dict(seconds=seconds, U=U.tolist(), rel_err=gait, angle_err=angle, files=files)
        log("2D spinning gait, `python3 -m bemstokes_tpu_torch run --dim 2 -p params.json 0 1 -o out`: "
            + json.dumps(out["gait"]) + f" (tol {tol['gait']:g}, angle {tol['angle']:g})")
        if not (files and gait <= tol["gait"] and angle <= tol["angle"]
                and np.abs(U[:2]).max() < 1e-6 * abs(omega)):
            raise AssertionError("2D spinning gait: wrong counter-rotation, angle or files")

        # (f) the convergence command from the 10-cell circle
        coarse = circle_mesh(0)
        write_inp(os.path.join(tmp, "circle_0.inp"), coarse.vertices, coarse.cells)
        quad = dataclasses.replace(ProblemConfig().quadrature, order=8, singular_order=10)
        cfg = ProblemConfig(dim=2, input_grid_path=tmp + os.sep, input_grid_base_name="circle_",
                            input_grid_format="inp", body_manifold="sphere", quadrature=quad)
        save_config(cfg, params)
        t0 = time.perf_counter()
        done = subprocess.run(
            [sys.executable, "-m", "bemstokes_tpu_torch", "convergence", "--dim", "2", "-p", params, "--cycles",
             str(CIRCLE_CONVERGENCE_CYCLES), "-o", tmp],
            cwd=str(Path(__file__).resolve().parent), capture_output=True, text=True, timeout=600,
        )
        seconds = time.perf_counter() - t0
        if done.returncode != 0:
            raise AssertionError(f"the 2D convergence command exited {done.returncode}:\n{done.stderr[-2000:]}")
        base = read_mesh(os.path.join(tmp, "circle_0.inp"), dim=2, force_material=0)
        study = dict(dim=2, source=(0.1, 0.2), manifold=_resolve_manifold(cfg), quad_order=8, sing_order=10)
        card = convergence_study(base, n_cycles=CIRCLE_CONVERGENCE_CYCLES, device=device, **study)
        host = convergence_study(base, n_cycles=CIRCLE_CPU_CYCLES, device="cpu", **study)
    printed = done.stdout.strip()
    for line in printed.splitlines():
        log(f"2D convergence: {line}")
    diff = max(abs(c.error - h.error) / h.error for c, h in zip(card, host))
    out["convergence"] = dict(seconds=seconds, errors=[r.error for r in card], rates=[r.rate for r in card[1:]],
                              against_cpu=diff)
    log("2D convergence, `python3 -m bemstokes_tpu_torch convergence --dim 2 -p params.json --cycles 8`: "
        + json.dumps(out["convergence"]) + f" (tol {tol['convergence']:g})")
    if not (printed == format_table(card) and [r.n_nodes for r in card] == [10 * 2**k for k in range(8)]):
        raise AssertionError("2D convergence: the command's table differs from the study")
    if not (diff <= tol["convergence"] and all(r.rate > 1.5 for r in card[1:])):
        raise AssertionError(f"2D convergence: rates {[r.rate for r in card]}, CPU {diff:.3e}")

    launched = port_launches(node_kernel, matfree_node, slot_kernel)
    log(f"2D: the port's CUDA kernels launched {launched} times (the 2D route is plain torch)")
    if launched:
        raise AssertionError("2D: a CUDA sweep ran on a 2D problem")
    log("phase 20 " + json.dumps(out))


#: phase 21: the distributed frame step (parallel/) at world size 1 in a
#: 1-rank NCCL group; every replicated value there is the rank's own, so
#: the distributed frames equal the single-card ones up to the order of
#: their sums (1e-10 relative), with equal iterations
DIST_TOL = 1e-10
#: the Jacobi frames: GMRES stopped at 1e-10 of |rhs| in two runs whose
#: products round differently, times the operator's conditioning
DIST_JACOBI_TOL = 1e-8
#: drag error of the Direct frame at create_sphere(5) (PR 1's 1.728e-4)
DIST_DRAG = 1.728e-4
#: (c): a virtual partition into 4 slabs, each assembled alone by
#: `parallel.sharded.assemble_slab`; its real rows against the single-card
#: V and K relative to max|V|, max|K|
SLAB_WORLD = 4
SLAB_TOL = 1e-13
FIELD_DIST_TOL = 1e-12


def dist_frame(step, euler, sdot):
    """One distributed step with the timers reset before it: its outputs,
    host-clock ms (device synchronised), the LU timer's host ms (the timers
    do not synchronise) and the peak memory (GiB) since the step began."""
    from bemstokes_tpu_torch.utils import timers

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timers.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = step(euler, sdot)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    spent = {k: v["total_s"] * 1e3 for k, v in timers.as_dict().items()}
    return out, ms, spent.get("DirectPreconditioner Refactorisation", 0.0), torch.cuda.max_memory_allocated() / 2**30


def single_frame(prob, euler, sdot):
    """`frame_timed` of one single-card frame, as the record `dist_frame`'s
    outputs are compared with."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    from bemstokes_tpu_torch.physics.rigid import flatten

    res, ms, spent = frame_timed(prob, euler, sdot)
    if "rigid_forces_pole" not in res:  # the resistance strategy's result
        res["rigid_forces_pole"] = (flatten(res["operators"]["N_dual"]) @ res["stokes_forces"]).cpu().numpy()
    rec = dict(
        U=np.asarray(res["rigid_velocities"]),
        F=np.asarray(res["rigid_forces_pole"]),
        forces=res["stokes_forces"].cpu().numpy(),
        iterations=res["iterations"],
        refactored=res.get("refactored", False),
        ms=ms,
        lu_ms=spent.get("DirectPreconditioner Refactorisation", 0.0),
        peak=torch.cuda.max_memory_allocated() / 2**30,
    )
    return rec


def dist_record(out, ms, lu_ms, peak, step):
    U, _, info, f = out
    return dict(
        U=U.cpu().numpy(),
        F=f["F"].cpu().numpy(),
        forces=f["forces"].cpu().numpy(),
        iterations=int(info["iterations"]),
        refactored=getattr(step, "stale_state", {}).get("refactored", False),
        ms=ms,
        lu_ms=lu_ms,
        peak=peak,
    )


def shown(rec):
    return {k: (round(v, 3) if isinstance(v, float) else v) for k, v in rec.items() if k not in ("U", "F", "forces")}


def phase_distributed(node_kernel, device):
    """The distributed frame step (`parallel/solve.py`) in a 1-rank NCCL
    group at 18,444 unknowns against the single-card frames, the slabs of a
    virtual 4-rank partition through K1 and K3, the distributed frame loop
    and the points-split BIE field."""
    import os

    import torch.distributed as dist

    from bemstokes_tpu_torch import postprocess
    from bemstokes_tpu_torch.config import ProblemConfig, SolverConfig
    from bemstokes_tpu_torch.config_io import save_config
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.ops.assemble import assemble_V_K
    from bemstokes_tpu_torch.parallel import row_mesh
    from bemstokes_tpu_torch.parallel.sharded import assemble_slab
    from bemstokes_tpu_torch.parallel.solve import make_sharded_frame_step
    from bemstokes_tpu_torch.physics.rigid import flatten
    from bemstokes_tpu_torch.problem import StokesBEMProblem
    from bemstokes_tpu_torch.swimmer import SwimmerSimulation

    dmesh = row_mesh()
    probe = torch.arange(4.0, device=device)
    gathered = [torch.empty_like(probe)]
    dist.broadcast(probe, src=0)
    dist.all_gather(gathered, probe)
    log(f"distributed: backend {dist.get_backend()}, world {dmesh.world}, rank {dmesh.rank}, device {dmesh.device}")
    if str(dist.get_backend()) != "nccl" or dmesh.world != 1 or not torch.equal(gathered[0], probe):
        raise AssertionError("distributed: expected a working 1-rank NCCL group")
    mesh5 = create_sphere(refinements=REFINEMENTS)

    def rel(a, b):
        return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())

    def compare(name, single, dist_recs, tol):
        for k, (s, d) in enumerate(zip(single, dist_recs)):
            F_err = float(np.abs(d["F"] - s["F"]).max() / max(np.abs(s["F"]).max(), np.abs(s["forces"]).max()))
            errs = dict(U=rel(d["U"], s["U"]), forces=rel(d["forces"], s["forces"]), F=F_err)
            log(f"distributed {name} frame {k}: single {json.dumps(shown(s))}; distributed {json.dumps(shown(d))}; against single {errs} (tol {tol:g})")
            if max(errs.values()) > tol or (d["iterations"] != s["iterations"] and tol == DIST_TOL):
                raise AssertionError(f"distributed {name} frame {k} differs from the single-card frame")

    # (a) Direct, fresh then stale, against solve_frame on the same inputs
    cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0)
    prob = StokesBEMProblem(mesh5, cfg, device=device)
    e0 = prob.initial_euler().cpu().numpy()
    frames = frames_of(e0)[:2]
    sdot = np.zeros(3 * prob.n)
    zero_counts(node_kernel)
    single = [single_frame(prob, e, sdot) for e in frames]
    tally(node_kernel)
    del prob
    prob = StokesBEMProblem(mesh5, cfg, device=device)
    step = make_sharded_frame_step(prob, dmesh, return_fields=True)
    zero_counts(node_kernel)
    dist_recs, field_in = [], None
    with slab_applies(f"Direct, {3 * prob.n + prob.num_rigid} unknowns (21 (a))") as slab:
        for e in frames:
            out = dist_frame(step, e, sdot)
            dist_recs.append(dist_record(*out, step))
            if field_in is None:
                U = dist_recs[0]["U"][:3]
                u_b = torch.as_tensor(np.tile(U, (prob.n, 1)), dtype=torch.float64, device=device)
                field_in = (flatten(u_b), out[0][3]["forces"], torch.as_tensor(e, device=device))
            del out
    launches = tally(node_kernel)
    slab_apply_check(slab)
    compare("Direct", single, dist_recs, DIST_TOL)
    drags = [abs(abs(r["F"][0]) - 6 * np.pi) / (6 * np.pi) for r in dist_recs]
    log(
        f"distributed Direct at {3 * prob.n + prob.num_rigid} unknowns: frames {[round(r['ms'], 1) for r in dist_recs]} ms "
        f"(single {[round(r['ms'], 1) for r in single]}), host time of the slab LU {dist_recs[0]['lu_ms']:.1f} ms "
        f"against solve_frame's LU {single[0]['lu_ms']:.1f} ms, peak {[round(r['peak'], 2) for r in dist_recs]} GiB (single "
        f"{[round(r['peak'], 2) for r in single]}), drag error {drags}, K1 launches {launches['free_space']}"
    )
    if [r["refactored"] for r in dist_recs] != [True, False] or [r["refactored"] for r in single] != [True, False]:
        raise AssertionError("distributed Direct: frame 0 must factor and frame 1 reuse the factors")
    if not all(abs(dr - DIST_DRAG) < 5e-8 for dr in drags[:1]) or launches["free_space"] != 2:
        raise AssertionError(f"distributed Direct: drag error {drags} or launches {launches}")

    # (e) the BIE field of frame 0, the points split over the ranks
    pts = shell_points(FIELD_POINTS, seed=2026)
    u_flat, f_flat, e0_t = field_in
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = postprocess.sharded_evaluate_stokes_bie(pts, u_flat, f_flat, e0_t, prob.tables, dmesh)
    torch.cuda.synchronize()
    sharded_ms = (time.perf_counter() - t0) * 1e3
    ref = postprocess.evaluate_stokes_bie(pts, u_flat, f_flat, e0_t, prob.tables)
    field_err = rel(got.cpu().numpy(), ref.cpu().numpy())
    log(f"distributed field: sharded_evaluate_stokes_bie at {FIELD_POINTS} points {sharded_ms:.1f} ms, against evaluate_stokes_bie {field_err:.3e} (tol {FIELD_DIST_TOL:g})")
    if not (got.shape == (FIELD_POINTS, 3) and field_err <= FIELD_DIST_TOL):
        raise AssertionError("distributed field disagrees")
    del step, prob, field_in, u_flat, f_flat, got, ref

    # (b) Jacobi and the resistance strategy against their single-card frames
    for name, cfg, tol in (
        ("Jacobi", ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, solver=SolverConfig(preconditioner_type="Jacobi")), DIST_JACOBI_TOL),
        ("resistance", ProblemConfig(grid_type="ImposedForce", imposed_component=0, monolithic=False), DIST_TOL),
    ):
        prob = StokesBEMProblem(mesh5, cfg, device=device)
        zero_counts(node_kernel)
        s = single_frame(prob, e0, sdot)
        step = make_sharded_frame_step(prob, dmesh, return_fields=True)
        with slab_applies(f"resistance, {prob.n} nodes (21 (b))") as slab:
            d = dist_record(*dist_frame(step, e0, sdot), step)
        launches = tally(node_kernel)
        if name == "resistance":  # the Jacobi step has no slab LU
            slab_apply_check(slab)
        compare(name, [s], [d], tol)
        mobility = 6 * np.pi * d["U"][0] - 1
        log(
            f"distributed {name}: 6 pi U_x - 1 = {mobility:.4e}, |F_x| / 6 pi - 1 = "
            f"{abs(d['F'][0]) / (6 * np.pi) - 1:.4e}, iterations {d['iterations']} (single {s['iterations']}), "
            f"K1 launches {launches['free_space']}"
        )
        if launches["free_space"] != 2 or (name == "resistance" and abs(mobility) > RESISTANCE_TOL["mobility"]):
            raise AssertionError(f"distributed {name}: launches {launches} or mobility {mobility}")
        del prob, step

    # (c) the slabs of a virtual 4-rank partition, K1 and K3, against the
    # single-card operators
    for name, refinements, kw in (
        ("free_space", REFINEMENTS, {}),
        ("no_slip", REFINEMENTS - 1, dict(no_slip_kernel=True, walls=wall_config("no_slip", 1).walls)),
    ):
        cfg = ProblemConfig(grid_type="ImposedVelocity", imposed_component=0, **kw)
        prob = StokesBEMProblem(create_sphere(refinements=refinements), cfg, device=device)
        e = prob.initial_euler()
        sp = support_points(e, prob.map_space, prob.fe_space)
        n = prob.n
        V, K = assemble_V_K(e, sp, prob.tables)
        scale_v, scale_k = float(V.abs().max()), float(K.abs().max())
        nloc = -(-n // SLAB_WORLD)
        zero_counts(node_kernel)
        errs, pad_max = [], 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for rank in range(SLAB_WORLD):
            Vs, Ks = assemble_slab(e, sp, prob.tables, rank, SLAB_WORLD)
            r0 = rank * nloc
            nr = min(nloc, n - r0)
            Vs, Ks = Vs.reshape(3, nloc, 3 * n), Ks.reshape(3, nloc, 3 * n)
            Vr, Kr = V.reshape(3, n, 3 * n)[:, r0 : r0 + nr], K.reshape(3, n, 3 * n)[:, r0 : r0 + nr]
            errs.append(
                (float((Vs[:, :nr] - Vr).abs().max()) / scale_v, float((Ks[:, :nr] - Kr).abs().max()) / scale_k)
            )
            if nr < nloc:
                pad_max = max(pad_max, float(Vs[:, nr:].abs().max()), float(Ks[:, nr:].abs().max()))
            del Vs, Ks
        torch.cuda.synchronize()
        slab_ms = (time.perf_counter() - t0) * 1e3
        launches = tally(node_kernel)
        log(
            f"distributed slabs, {name}, create_sphere({refinements}) ({n} nodes), {SLAB_WORLD} slabs of nloc {nloc} "
            f"(last {n - (SLAB_WORLD - 1) * nloc} real rows): per rank (V, K) error / max {errs} (tol {SLAB_TOL:g}), "
            f"padded rows max {pad_max}, {slab_ms:.1f} ms for the four, launches {launches}"
        )
        if max(max(x) for x in errs) > SLAB_TOL or pad_max != 0.0 or launches[name] != SLAB_WORLD:
            raise AssertionError(f"distributed slabs, {name}: wrong rows or launches")
        del prob, V, K, e, sp
        gc.collect()
        torch.cuda.empty_cache()

    # (d) the distributed frame loop: two frames of a Real gait beside the
    # no-slip wall, against the same loop without `distributed`
    mesh4 = create_sphere(refinements=REFINEMENTS - 1)
    with tempfile.TemporaryDirectory() as tmp:
        grids = os.path.join(tmp, "grids")
        os.makedirs(grids)
        for k in range(3):
            write_msh(os.path.join(grids, f"gait_{k}.msh"), mesh4.vertices * (1.0 + 0.04 * k * mesh4.vertices[:, :1]), mesh4.cells)
        runs = {}
        for distributed in (False, True):
            cfg = ProblemConfig(
                grid_type="Real",
                n_frames=3,
                time_step=0.1,
                input_grid_path=grids + os.sep,
                input_grid_base_name="gait_",
                input_grid_format="msh",
                consider_rigid_displacements=True,
                rigid_displacement_axes=(True, True, True),
                no_slip_kernel=True,
                walls=wall_config("no_slip", 1).walls,
                distributed=distributed,
            )
            out = os.path.join(tmp, f"out_{distributed}")
            zero_counts(node_kernel)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with slab_applies(f"frame loop beside the no-slip wall, create_sphere({REFINEMENTS - 1}) (21 (d))") as slab:
                history = SwimmerSimulation(cfg, out, device=device).run(0, 2)
            seconds = time.perf_counter() - t0
            launches = tally(node_kernel)
            if distributed:
                slab_apply_check(slab)
            runs[distributed] = (history, sorted(os.listdir(out)), seconds, launches)
        (h_s, files_s, sec_s, l_s), (h_d, files_d, sec_d, l_d) = runs[False], runs[True]
        errs = [rel(a["rigid_velocities"], b["rigid_velocities"]) for a, b in zip(h_d, h_s)]
        log(
            f"distributed frame loop, create_sphere({REFINEMENTS - 1}) gait beside the no-slip wall: U {[h['rigid_velocities'] for h in h_d]}, "
            f"against the single-card loop {errs} (tol {DIST_TOL:g}); iterations {[h['iterations'] for h in h_d]} (single "
            f"{[h['iterations'] for h in h_s]}); {sec_d:.2f} s (single {sec_s:.2f} s); files {files_d == files_s} "
            f"({len(files_d)}); K3 launches {l_d['no_slip']} (single {l_s['no_slip']})"
        )
        if max(errs) > DIST_TOL or files_d != files_s or l_d["no_slip"] != 2:
            raise AssertionError("distributed frame loop differs from the single-card loop")
    dist.destroy_process_group()


#: phase 22: the higher-order element configurations at the bench's size
#: class, f64, Direct.  (a) is the JAX package's drag gate (bench.py:474-503:
#: a Q4 map snapped to the sphere, quadrature 6 / 9, GMRES to 1e-12 on an f32
#: LU); the others are the configurations that tests/test_torch_high_order.py
#: and tests/test_torch_spheroid.py hold against the JAX package on the CPU.
HO_DRAG_GATE = 1e-6
HO_MODES_TOL = 1e-8  # node mode against gather mode: forces relative to max
HO_MATFREE_TOL = 1e-7
HO_CPU_TOL = 1e-10  # the card against the port on the CPU at create_sphere(2)
HO_BRENNER_TOL = 1e-3
HO_OBERBECK_TOL = 2e-3
HO_PLAIN_ROWS = 512  # rows of the plain versions' run at the new shapes
SPHEROID_RADII = (2.0, 1.0, 1.0)
GAIT_STEP = 1.0 / 120.0  # the translating gait's step a frame (time_step 0.1)
#: the drag errors the same configurations give at create_sphere(2), on the
#: CPU in both packages (tests/test_torch_high_order.py): a finer mesh must
#: do better
HO_COARSE_DRAG = {"q2q2": 8.470e-4, "q0": 2.640e-2}


def ho_config(case, **changes):
    from bemstokes_tpu_torch.config import ProblemConfig, QuadratureConfig, SolverConfig

    imposed = dict(grid_type="ImposedVelocity", imposed_component=0, force_pole="Origin")
    cases = {
        "gate": dict(
            imposed,
            map_degree=4,
            body_manifold="sphere",
            quadrature=QuadratureConfig(order=6, singular_order=9),
            solver=SolverConfig(preconditioner_dtype="float32", tolerance=1e-12),
        ),
        "q2q2": dict(imposed, fe_degree=2, map_degree=2, body_manifold="sphere"),
        "q0": dict(imposed, fe_degree=0, map_degree=1),
        "q2map": dict(grid_type="Real", force_pole="Origin", fe_degree=1, map_degree=2),
        "spheroid": dict(
            imposed,
            map_degree=3,
            body_manifold="spheroid",
            body_manifold_radii=SPHEROID_RADII,
            quadrature=QuadratureConfig(order=5, singular_order=8),
        ),
    }
    # (c): the gate's elements matrix-free, GMRES to phase 9's 1e-11
    cases["gate_free"] = dict(cases["gate"], solver=SolverConfig(tolerance=1e-11), matrix_free=True)
    return ProblemConfig(**{**cases[case], **changes})


def ho_wall_config(refinements):
    """(b): phase 5's sphere 2 radii above the no-slip wall, pushed towards
    it, with the drag gate's map and quadrature."""
    from bemstokes_tpu_torch.config import QuadratureConfig

    return wall_config(
        "no_slip", refinements, map_degree=4, quadrature=QuadratureConfig(order=6, singular_order=9)
    )


def ho_mesh(case, refinements):
    from bemstokes_tpu_torch.mesh import SurfaceMesh, create_sphere

    mesh = create_sphere(refinements=refinements)
    if case == "spheroid":
        mesh = SurfaceMesh(mesh.vertices * np.array(SPHEROID_RADII), mesh.cells, mesh.material_id)
    return mesh


def ho_frames(prob, case, frames):
    """[(euler, shape velocity)]: `frames` rigid motions of frame 0 under an
    imposed motion (frames_of); on the gait (q2map) a translation by
    GAIT_STEP, then the same translation with a pear-shaped stroke, whose
    shape velocities go through the degree-mismatch interpolation."""
    e0 = prob.initial_euler().cpu().numpy()
    if case != "q2map":
        return [(e, np.zeros(3 * prob.n)) for e in frames_of(e0)[:frames]]
    shift = np.array([GAIT_STEP, 0.0, 0.0])
    es = [e0, e0 + shift, e0 + 2 * shift + 0.04 * e0 * e0[:, :1]]
    return [(a, prob.shape_velocities_fd(a, b)) for a, b in zip(es[:2], es[1:])]


def ho_solve(device, case, refinements, frames=1, **changes):
    """(problem, [frame record]) of a case on `device`: ms (host clock, the
    card synchronised), iterations, refactored, convergence, the forces, the
    rigid velocities and forces, and the drag |F_c| along the imposed
    component c."""
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    prob = StokesBEMProblem(ho_mesh(case, refinements), ho_config(case, **changes), device=device)
    out = []
    for e, sdot in ho_frames(prob, case, frames):
        if prob.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prob.solve_frame(e, sdot)
        if prob.device.type == "cuda":
            torch.cuda.synchronize()
        F = np.asarray(res["rigid_forces_pole"])
        out.append(
            dict(
                ms=(time.perf_counter() - t0) * 1e3,
                iterations=res["iterations"],
                refactored=res["refactored"],
                converged=res["converged"],
                residual=res["residual"],
                stokes_forces=res["stokes_forces"].cpu().numpy(),
                rigid_velocities=np.asarray(res["rigid_velocities"]),
                rigid_forces_pole=F,
                drag=float(abs(F[prob.cfg.imposed_component])),
            )
        )
        del res
    return prob, out


def ho_diff(a, b):
    """Largest relative difference of two frame records' forces, rigid
    velocities and rigid forces, each relative to its largest entry (on
    the gait's translating frame, whose tractions vanish, to the larger of
    that and the gait's speed)."""
    worst = 0.0
    for key in ARRAYS:
        scale = max(np.abs(b[key]).max(), GAIT_STEP / 0.1 if key != "rigid_velocities" else 0.0)
        worst = max(worst, float(np.abs(a[key] - b[key]).max() / scale))
    return worst


#: the configurations of phase 22 on create_sphere(2), the card against the
#: CPU: (name, case, frames, changes)
HO_SMALL = (
    ("(a) node", "gate", 2, {}),
    ("(a) gather", "gate", 1, dict(assembly_backend="gather")),
    ("(c) matrix-free", "gate_free", 1, dict(matfree_block_nodes=32)),
    ("(d) node", "q2q2", 1, {}),
    ("(d) gather", "q2q2", 1, dict(assembly_backend="gather")),
    ("(e) node", "q0", 1, {}),
    ("(e) gather", "q0", 1, dict(assembly_backend="gather")),
    ("(f)", "q2map", 2, {}),
    ("(g) axial", "spheroid", 1, {}),
    ("(g) transverse", "spheroid", 1, dict(imposed_component=1)),
)


def ho_small_reference(device):
    """Every configuration of phase 22 on create_sphere(2): the card against
    the port on the CPU (plain versions), 1e-10."""
    worst_all = 0.0
    for name, case, frames, changes in HO_SMALL:
        _, card = ho_solve(device, case, 2, frames, **changes)
        _, host = ho_solve("cpu", case, 2, frames, **changes)
        worst = max(ho_diff(a, b) for a, b in zip(card, host))
        iters = [(a["iterations"], b["iterations"]) for a, b in zip(card, host)]
        log(f"higher order, create_sphere(2), {name}: card vs CPU {worst:.3e} (tol {HO_CPU_TOL:g}), iterations {iters}")
        # the drag gate's f32 LU rounds differently on the card: one GMRES
        # iteration more or fewer to the same 1e-12
        slack = 1 if case == "gate" else 0
        if worst > HO_CPU_TOL or any(abs(a - b) > slack for a, b in iters):
            raise AssertionError(f"higher order {name}: the card disagrees with the CPU")
        worst_all = max(worst_all, worst)
    hc, _, fc, _ = run_simulation(ho_wall_config(2), device, 1)
    hh, _, fh, _ = run_simulation(ho_wall_config(2), "cpu", 1)
    ua, ub = np.asarray(hc[0]["rigid_velocities"]), np.asarray(hh[0]["rigid_velocities"])
    worst = max(np.abs(ua - ub).max() / np.abs(ub).max(), np.abs(fc[0] - fh[0]).max() / np.abs(fh[0]).max())
    log(f"higher order, create_sphere(2), (b) no-slip wall: card vs CPU {worst:.3e} (tol {HO_CPU_TOL:g})")
    if worst > HO_CPU_TOL:
        raise AssertionError("higher order (b): the card disagrees with the CPU")
    return max(worst_all, worst)


def ho_log(name, prob, recs, launches, extra=""):
    peak = torch.cuda.max_memory_allocated() / 2**30
    unknowns = 3 * prob.n + prob.num_rigid
    frames = "; ".join(
        f"frame {k}: {r['ms']:.1f} ms, {r['iterations']} iterations, refactored {r['refactored']}, "
        f"converged {r['converged']}, residual {r['residual']:.3e}, drag {r['drag']:.10f}"
        for k, r in enumerate(recs)
    )
    log(
        f"higher order {name}: {prob.n} nodes, {unknowns} unknowns, vmax x nq = "
        f"{prob.tables.inc_slot.shape[1]} x {len(prob.tables.q_weights)}; {frames}; peak "
        f"{peak:.3f} GiB; launches {launches}{extra}"
    )
    if not all(r["converged"] and np.isfinite(r["stokes_forces"]).all() for r in recs):
        raise AssertionError(f"higher order {name}: a frame did not converge")


def ho_path(device, case, refinements, frames, kernels, calls, **changes):
    """One full-width path with the launch counters (and the count of calls
    of the plain gather-reduce) set to 0 just before it and read just after;
    returns (problem, records, launches and calls that were not 0)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*kernels.values())
    calls["gather_reduce"] = 0
    prob, recs = ho_solve(device, case, refinements, frames, **changes)
    launches = {f"{name}:{k}": v for name, mod in kernels.items() for k, v in mod.launches.items() if v}
    if calls["gather_reduce"]:
        launches["gather_reduce"] = calls["gather_reduce"]
    return prob, recs, launches


def ho_sweep_check(node_kernel, counts, label, args, kernel="free_space", phase="higher order"):
    """K1 (or K3, wall at y = WALL_Y) at a new shape against its plain
    version on the first HO_PLAIN_ROWS rows; timed over all rows with the SM
    clock read under load and the pipe floor beside it; `phase` names the
    phase in the log and in a failure."""
    dtype = torch.float64
    xi, Yj, Nj, Wj = args
    kw = dict(kernel=kernel, wall_axis=1, wall_position=WALL_Y)
    rows = xi[:HO_PLAIN_ROWS].contiguous()
    V, K = node_kernel.node_sweep(rows, Yj, Nj, Wj, **kw)
    (Vr, Kr), plain_ms = event_ms(
        lambda: node_kernel.node_sweep_reference(rows, Yj, Nj, Wj, row_tile=64, col_chunk=1024, **kw)
    )
    err = max(rel(V, Vr), rel(K, Kr))
    abs_err = max((V - Vr).abs().max().item(), (K - Kr).abs().max().item())
    finite = bool(torch.isfinite(V).all() and torch.isfinite(K).all())
    del V, K, Vr, Kr
    ms = cuda_ms(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj, **kw), reps=5)
    clock = clock_under_load(lambda: node_kernel.node_sweep(xi, Yj, Nj, Wj, **kw))
    nr, n, m = xi.shape[0], Yj.shape[0], Yj.shape[1]
    live = int((Wj != 0).sum())
    bound_ms, bound_by = bound(kernel, dtype, nr, n, m, live)
    instructions, floor_ms = pipe_floor(counts[kernel, dtype], dtype, nr, n, m, sm_clock_mhz(clock))
    tol = tolerance(kernel, dtype)
    rec = dict(
        shape=label, m=m, rows=nr, cols=n, live_sample_share=live / (n * m), ms=ms,
        ps_per_interaction=ms * 1e9 / (nr * n * m), plain_ms=plain_ms, plain_rows=rows.shape[0],
        bound_ms=bound_ms, bound_by=bound_by, pipe_floor_ms=floor_ms, max_abs_err=abs_err,
        max_rel_err=err, sm_clock=clock,
    )
    log(
        f"{phase} {kernel} {label}: rows={nr} cols={n} m={m} ({100 * live / (n * m):.1f} % of the samples "
        f"carry weight): rel err on {rows.shape[0]} rows {err:.3e} (tol {tol:.0e}), max abs err {abs_err:.3e}; "
        f"kernel {ms:.3f} ms ({rec['ps_per_interaction']:.3f} ps an interaction), plain {plain_ms:.3f} ms on "
        f"{rows.shape[0]} rows, bound {bound_ms:.3f} ms by {bound_by}, {instructions:.2f} FP64 instructions an "
        f"interaction, pipe floor {floor_ms:.3f} ms; SM clock, its maximum and power under this load: {clock}"
    )
    if not (finite and err <= tol):
        raise AssertionError(f"{phase}: {kernel} disagrees with its plain version at {label}")
    return rec


def ho_matvec_check(matfree_node, label, prob):
    """K5 (free space) at the drag gate's m = 144: V alone (1, 0), the GMRES
    matvec, and the setup sweep (1, 10) against the plain version on the
    first HO_PLAIN_ROWS rows; V alone timed over all rows."""
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.physics.rigid import build_mass_operator

    dtype = torch.float64
    e = prob.initial_euler()
    sp = support_points(e, prob.map_space, prob.fe_space)
    _, (xq, normals, jxw) = build_mass_operator(e, prob.tables)
    st, arrs = matfree_node.build_sweep(prob.tables, sp, xq, normals, jxw)
    st_r, arrs_r = matfree_node.build_sweep(prob.tables, sp[:HO_PLAIN_ROWS], xq, normals, jxw)
    rng = np.random.default_rng(22)
    X = torch.as_tensor(rng.standard_normal((3 * st.n, 11)), dtype=dtype, device=prob.device)
    XV, XK = X[:, :1], X[:, 1:]
    (Vr, Kr), plain_ms = event_ms(
        lambda: matfree_node.sweep_matvec_reference(st_r, arrs_r, XV, XK, row_tile=64, col_chunk=1024)
    )
    V, _ = matfree_node.sweep_matvec(st_r, arrs_r, XV, XK[:, :0])
    Vs, Ks = matfree_node.sweep_matvec(st_r, arrs_r, XV, XK)
    err = max(rel(V, Vr), rel(Vs, Vr), rel(Ks, Kr))
    abs_err = (V - Vr).abs().max().item()
    ms = cuda_ms(lambda: matfree_node.sweep_matvec(st, arrs, XV, XK[:, :0]), reps=5)
    setup_ms = cuda_ms(lambda: matfree_node.sweep_matvec(st, arrs, XV, XK), reps=2)
    clock = clock_under_load(lambda: matfree_node.sweep_matvec(st, arrs, XV, XK[:, :0]))
    nr, n, m = st.nr, st.n, st.vmax * st.nq
    bound_ms, bound_by = matvec_bound("free_space", dtype, nr, n, m)
    rec = dict(
        shape=label, m=m, rows=nr, cols=n, ms=ms, ps_per_interaction=ms * 1e9 / (nr * n * m),
        setup_ms=setup_ms, plain_ms=plain_ms, plain_rows=st_r.nr, bound_ms=bound_ms, bound_by=bound_by,
        max_abs_err=abs_err, max_rel_err=err, sm_clock=clock,
    )
    log(
        f"higher order sweep_matvec free_space {label}: rows={nr} cols={n} m={m}: rel err of (1,0) and (1,10) on "
        f"{st_r.nr} rows {err:.3e} (tol {TOL_MATVEC[dtype]:.0e}); V alone {ms:.3f} ms "
        f"({rec['ps_per_interaction']:.3f} ps an interaction), setup shape (1,10) {setup_ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms on {st_r.nr} rows, bound {bound_ms:.3f} ms by {bound_by}; SM clock, its maximum and "
        f"power under this load: {clock}"
    )
    if not (bool(torch.isfinite(V).all()) and err <= TOL_MATVEC[dtype]):
        raise AssertionError(f"higher order: sweep_matvec disagrees with its plain version at {label}")
    return rec


def ho_nodes_check(slot_kernel, counts, label, prob, phase="higher order"):
    """`tile_nodes` at a new shape (the gather frames' tables): against its
    plain version on the first HO_PLAIN_ROWS rows, timed over all rows in
    the gather path's row blocks with the SM clock read under load; `phase`
    names the phase in the log and in a failure."""
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.ops import assemble

    dtype = torch.float64
    tables = prob.tables
    e = prob.initial_euler()
    sp = support_points(e, prob.map_space, prob.fe_space)
    xq, nrm, wphi = assemble.slot_inputs(e, tables)
    groups = slot_kernel.node_groups(tables)
    nt, (nc, nq, nl), n = sp.shape[0], wphi.shape, groups.n_nodes
    ids = torch.arange(nt, device=sp.device)
    rows, rids = sp[:HO_PLAIN_ROWS].contiguous(), ids[:HO_PLAIN_ROWS]
    V, K = slot_kernel.tile_nodes(rows, xq, nrm, wphi, rids, groups)
    (Vr, Kr), plain_ms = event_ms(lambda: slot_kernel.tile_nodes_reference(rows, xq, nrm, wphi, rids, groups))
    err = max(rel(V, Vr), rel(K, Kr))
    abs_err = max((V - Vr).abs().max().item(), (K - Kr).abs().max().item())
    finite = bool(torch.isfinite(V).all() and torch.isfinite(K).all())
    del V, K, Vr, Kr
    T = assemble.node_block_rows(tables)
    blocks = [(sp[t0 : t0 + T].contiguous(), ids[t0 : t0 + T]) for t0 in range(0, nt, T)]

    def all_blocks():
        return [slot_kernel.tile_nodes(xi, xq, nrm, wphi, b, groups) for xi, b in blocks]

    ms = cuda_ms(all_blocks, reps=3)
    clock = clock_under_load(all_blocks)
    valence = np.bincount(groups.cells_fe.reshape(-1), minlength=n)
    bound_ms, bound_by = nodes_bound(dtype, nt, nc, nq, nl, n, int(valence.sum()))
    floor = ""
    if nl == 4:
        # the loop counted in phase 2 is Q1's: one pass of 4 local nodes
        instructions, floor_ms = pipe_floor(counts["tile_nodes", dtype], dtype, nt, groups.union_panels, nq, sm_clock_mhz(clock))
        floor = f", {instructions:.2f} FP64 instructions a (row, panel point), pipe floor {floor_ms:.3f} ms"
    smem = groups.group_max * 12 * 32 * 8 + 2 * slot_kernel.NODE_GROUP_WARPS * nq * (6 + nl) * 8 + (
        groups.round_max * slot_kernel.NODE_GROUP_WARPS * (1 + 2 * nl) * 4
    )
    rec = dict(
        shape=label, nq=nq, nl=nl, rows=nt, panels=nc, nodes=n, row_blocks=len(blocks), ms=ms,
        plain_ms=plain_ms, plain_rows=rows.shape[0], bound_ms=bound_ms, bound_by=bound_by, max_abs_err=abs_err,
        max_rel_err=err, shared_memory_bytes=smem, panels_evaluated_per_panel=groups.redundancy, sm_clock=clock,
    )
    log(
        f"{phase} tile_nodes {label}: rows={nt} panels={nc} nq={nq} nl={nl} nodes={n}, {len(blocks)} row "
        f"blocks of {T}, {groups.n_groups} groups, panels evaluated per panel {groups.redundancy:.4f}, {smem} B of "
        f"shared memory a block: rel err on {rows.shape[0]} rows {err:.3e} (tol {TOL_SLOTS[dtype]:.0e}), max abs "
        f"err {abs_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms on {rows.shape[0]} rows, bound "
        f"{bound_ms:.3f} ms by {bound_by}{floor}; SM clock, its maximum and power under this load: {clock}"
    )
    if not (finite and err <= TOL_SLOTS[dtype]):
        raise AssertionError(f"{phase}: tile_nodes disagrees with its plain version at {label}")
    return rec


def phase_higher_order(node_kernel, matfree_node, slot_kernel, device, counts):
    """Phase 22: the higher-order element configurations at full width;
    returns the new-shape records per kernel and the launches of K5 (free
    space, in all and by shape) and of `tile_nodes` (with the (row, panel)
    pairs it covered) on these paths."""
    log(f"higher order: {card_line()}")
    t0 = time.perf_counter()
    small = ho_small_reference(device)
    log(f"higher order: create_sphere(2) references {time.perf_counter() - t0:.1f} s, worst {small:.3e}")
    shapes = {"free_space": [], "no_slip": [], "matvec": [], "tile_nodes": []}
    kernels = {"K1-K4": node_kernel, "K6": slot_kernel, "K5": matfree_node}
    calls = {"gather_reduce": 0}
    inner = counting(slot_kernel, "gather_reduce", calls)
    try:
        out = higher_order_paths(node_kernel, matfree_node, slot_kernel, device, counts, shapes, kernels, calls)
    finally:
        slot_kernel.gather_reduce = inner
    return (shapes, *out)


def sweep_args(prob):
    """(xi, Yj, Nj, Wj) of a problem's node sweep under its initial geometry."""
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.ops import assemble

    e = prob.initial_euler()
    return assemble.node_sweep_inputs(e, support_points(e, prob.map_space, prob.fe_space), prob.tables)


def higher_order_paths(node_kernel, matfree_node, slot_kernel, device, counts, shapes, kernels, calls):
    def path(case, refinements, frames, **changes):
        return ho_path(device, case, refinements, frames, kernels, calls, **changes)

    nodes_launches, nodes_pairs = 0, {"f32": 0, "f64": 0}

    # (a) the drag gate: a fresh and a stale node frame, one gather frame
    prob, node, launches = path("gate", REFINEMENTS, 2)
    tally(node_kernel)
    errs = [abs(r["drag"] - 6 * np.pi) / (6 * np.pi) for r in node]
    ho_log("(a) drag gate, node", prob, node, launches, f"; drag errors {errs} (gate {HO_DRAG_GATE:g})")
    if launches != {"K1-K4:free_space": 2} or [r["refactored"] for r in node] != [True, False] or max(errs) > HO_DRAG_GATE:
        raise AssertionError(f"higher order (a): launches {launches} or drag errors {errs}")
    args = sweep_args(prob)
    shapes["free_space"].append(ho_sweep_check(node_kernel, counts, "Q4 map, quadrature 6 (a)", args))
    shapes["no_slip"].append(ho_sweep_check(node_kernel, counts, "Q4 map, quadrature 6 (b)", args, "no_slip"))
    del args
    shapes["matvec"].append(ho_matvec_check(matfree_node, "Q4 map, quadrature 6 (c)", prob))
    del prob
    prob, gather, launches = path("gate", REFINEMENTS, 1, assembly_backend="gather")
    nodes_launches += slot_kernel.launches["tile_nodes"]
    nodes_pairs["f64"] += slot_kernel.pairs["f64"]
    diff = ho_diff(gather[0], node[0])
    err = abs(gather[0]["drag"] - 6 * np.pi) / (6 * np.pi)
    ho_log(
        "(a) drag gate, gather", prob, gather, launches,
        f"; drag error {err:.4e}, forces against node mode {diff:.3e} (tol {HO_MODES_TOL:g})",
    )
    if set(launches) != {"K6:tile_nodes"} or diff > HO_MODES_TOL or err > HO_DRAG_GATE:
        raise AssertionError(f"higher order (a) gather: launches {launches}, diff {diff}, drag error {err}")
    shapes["tile_nodes"].append(ho_nodes_check(slot_kernel, counts, "Q1 panels, nq 36 (a)", prob))
    del prob

    # (b) the same map beside the no-slip wall: one frame of the frame loop
    history, records, launches, _ = wall_path(
        node_kernel, device, "higher order (b) no-slip wall", ho_wall_config(REFINEMENTS), 1
    )
    mobility = 6 * np.pi * history[0]["rigid_velocities"][1]
    exact = 1.0 / brenner_lambda(-WALL_Y)
    log(
        f"higher order (b) no-slip wall: 6 pi U_y = {mobility:.6f}, Brenner {exact:.6f}, off by "
        f"{abs(mobility - exact):.3e} (tol {HO_BRENNER_TOL:g}); {records[0]['seconds'] * 1e3:.1f} ms, "
        f"{records[0]['iterations']} iterations, peak {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB"
    )
    if abs(mobility - exact) > HO_BRENNER_TOL or launches != {"free_space": 0, "free_surface": 0, "no_slip": 1, "planes": 0}:
        raise AssertionError(f"higher order (b): mobility {mobility} or launches {launches}")

    # (c) one matrix-free frame of (a) against its materialized frame 0
    prob, (free,), launches = path("gate_free", REFINEMENTS, 1, matfree_block_nodes=1024)
    blocks = tally(node_kernel)
    k5 = shapes_of(matfree_node, "free_space")
    matvec_launches = (matfree_node.launches["free_space"], k5)
    diff = ho_diff(free, node[0])
    ho_log(
        "(c) matrix-free", prob, [free], launches,
        f", K5 by shape {k5}; forces against (a)'s materialized frame 0 {diff:.3e} (tol {HO_MATFREE_TOL:g})",
    )
    check_one_sided("higher order (c)", "free_space", k5, free["iterations"])
    if diff > HO_MATFREE_TOL or blocks["free_space"] < 1:
        raise AssertionError(f"higher order (c): diff {diff}, block factor launches {blocks}")
    del prob

    # (d) Q2 / Q2 and (e) Q0: a node frame and a gather frame each
    for tag, case, refinements, label in (
        ("(d) Q2/Q2", "q2q2", REFINEMENTS - 1, "Q2 unknowns (d)"),
        ("(e) Q0", "q0", REFINEMENTS, "Q0 unknowns (e)"),
    ):
        prob, (nd,), launches = path(case, refinements, 1)
        tally(node_kernel)
        ho_log(f"{tag} node", prob, [nd], launches)
        if launches != {"K1-K4:free_space": 1}:
            raise AssertionError(f"higher order {tag}: node launches {launches}")
        args = sweep_args(prob)
        shapes["free_space"].append(ho_sweep_check(node_kernel, counts, label, args))
        del args, prob
        prob, (ga,), launches = path(case, refinements, 1, assembly_backend="gather")
        nodes_launches += slot_kernel.launches["tile_nodes"]
        nodes_pairs["f64"] += slot_kernel.pairs["f64"]
        diff = ho_diff(ga, nd)
        errs = [abs(r["drag"] - 6 * np.pi) / (6 * np.pi) for r in (nd, ga)]
        ho_log(
            f"{tag} gather", prob, [ga], launches,
            f"; drag errors node, gather {errs} (at create_sphere(2): {HO_COARSE_DRAG[case]:g}); forces "
            f"against node mode {diff:.3e} (tol {HO_MODES_TOL:g})",
        )
        if set(launches) != {"K6:tile_nodes"} or diff > HO_MODES_TOL or max(errs) > HO_COARSE_DRAG[case]:
            raise AssertionError(f"higher order {tag}: gather launches {launches}, diff {diff}, drag errors {errs}")
        shapes["tile_nodes"].append(ho_nodes_check(slot_kernel, counts, label, prob))
        del prob

    # (f) a Q2 map with Q1 unknowns: two frames of the translating gait
    prob, recs, launches = path("q2map", REFINEMENTS, 2)
    tally(node_kernel)
    speed = GAIT_STEP / prob.cfg.time_step
    err = abs(recs[0]["rigid_velocities"][0] + speed) / speed
    ho_log(
        "(f) Q2 map, Q1 unknowns", prob, recs, launches,
        f"; U_x of the translating frame against -{speed:.6f}: {err:.3e} (tol 2e-2)",
    )
    if launches != {"K1-K4:free_space": 2} or [r["refactored"] for r in recs] != [True, False] or err > 2e-2:
        raise AssertionError(f"higher order (f): launches {launches} or U_x error {err}")
    del prob

    # (g) the prolate spheroid, along and across its axis, against Oberbeck
    a, b = SPHEROID_RADII[:2]
    ecc = np.sqrt(1.0 - (b / a) ** 2)
    L = np.log((1.0 + ecc) / (1.0 - ecc))
    oberbeck = {
        0: 16.0 * np.pi * a * ecc**3 / ((1.0 + ecc * ecc) * L - 2.0 * ecc),
        1: 32.0 * np.pi * a * ecc**3 / ((3.0 * ecc * ecc - 1.0) * L + 2.0 * ecc),
    }
    for component, exact in oberbeck.items():
        prob, (rec,), launches = path("spheroid", REFINEMENTS, 1, imposed_component=component)
        tally(node_kernel)
        err = abs(rec["drag"] - exact) / exact
        ho_log(
            f"(g) spheroid {('axial', 'transverse')[component]}", prob, [rec], launches,
            f"; Oberbeck {exact:.6f}, off by {err:.3e} (tol {HO_OBERBECK_TOL:g})",
        )
        if launches != {"K1-K4:free_space": 1} or err > HO_OBERBECK_TOL:
            raise AssertionError(f"higher order (g): launches {launches} or Oberbeck error {err}")
        if component == 0:
            args = sweep_args(prob)
            shapes["free_space"].append(ho_sweep_check(node_kernel, counts, "Q3 map, quadrature 5 (g)", args))
            del args
        del prob
    return matvec_launches, nodes_launches, nodes_pairs


#: phase 23: the sphere's height above each wall, in radii
WN_H = 2.0
#: (a) the meshed no-slip plate and its local refinement: with create_sphere(4)
#: 6,091 nodes (152 hanging), 18,279 unknowns; the small twin's, with
#: create_sphere(2), 171 nodes (24 hanging)
WN_SPAN = (12.0, 0.0, 12.0)
WN_REFINEMENT = dict(threshold=0.5, distance_from_center=7.0)
WN_SMALL_REFINEMENT = dict(threshold=2.0, distance_from_center=2.5)
#: the stale frames move the body along the wall, not the wall
WN_BODY_SHIFT = np.array([0.1, 0.0, 0.0])
#: (b) the four wall kinds: (kind, position, span); each meshed plate refined
#: uniformly WN_MIXED_REFINEMENTS times (1,089 nodes; the small twin's once)
WN_MIXED = (
    ("dirichlet", (0.0, -8.0, 0.0), (8.0, 0.0, 8.0)),
    ("neumann", (0.0, 8.0, 0.0), (8.0, 0.0, 8.0)),
    ("do_nothing", (8.0, 0.0, 0.0), (0.0, 8.0, 8.0)),
    ("free_surface", (0.0, 0.0, -8.0), (8.0, 8.0, 0.0)),
)
WN_MIXED_REFINEMENTS = 5
#: (c) the gaps and quadratures of the near-contact sweep (scripts/
#: near_contact_sweep.py's, with order 8 where the TPU compiler took 6)
WN_GAPS = (2.0, 1.2, 1.1, 1.05, 1.02)
WN_QUADRATURES = {
    "far2": dict(order=2, auto_promote=False),
    "far2+auto": dict(order=2, auto_promote=True, promote_boost=6),
    "uniform8": dict(order=8, auto_promote=False),
}
#: (d) two create_sphere(5) bodies, centre distances
WN_DISTANCES = (3.0, 2.05)
WN_CPU_TOL = 1e-10  # each small twin: the card against the port on the CPU
WN_MATFREE_TOL = 1e-8  # a matrix-free frame against its materialized frame
WN_MODES_TOL = 1e-8  # the gather frame against the node frame
WN_RESIDUAL = 1e-8
WN_BRENNER_TOL = 1e-2  # (c) at H >= 1.1, each quadrature
WN_RECOVERY = 1e-4  # (c) the promoted far rule against uniform order 8
WN_SJ_TOL = 1e-2  # (d) against Stimson and Jeffery
WN_JITTER = 1e-6  # the small twins' vertex jitter
WN_SMALL_BLOCK = 128  # the small twins' matrix-free blocks (their CPU runs pay each iteration in plain torch)


def lorentz_drag(H):
    """The drag of a unit sphere translating parallel to an infinite no-slip
    plane at height H (Lorentz / Faxen series, tests/test_wall_refinement.py:
    30-33)."""
    lam = 1.0 / H
    return 6.0 * np.pi / (1.0 - 9.0 / 16.0 * lam + lam**3 / 8.0 - 45.0 / 256.0 * lam**4 - lam**5 / 16.0)


def stimson_jeffery_lambda(Hd, terms=5000):
    """Two equal spheres translating with equal velocity along their line of
    centres: the exact drag correction of each (Stimson and Jeffery 1926),
    Hd = d / (2a) with d the centre separation (tests/test_near_contact.py:53)."""
    al = np.arccosh(np.float64(Hd))
    n = np.arange(1, terms + 1, dtype=np.float64)
    k = 2 * n + 1
    e = np.exp(-k * al)
    sha, sh2a = np.sinh(al), np.sinh(2 * al)
    den = (1 - e * e) + k * sh2a * e
    num = (1 - e) ** 2 - (k * sha) ** 2 * e
    return (4.0 / 3.0) * sha * np.sum(n * (n + 1) / ((2 * n - 1) * (2 * n + 3)) * (1.0 - num / den))


def wn_jittered(mesh):
    """`mesh` with every vertex moved by a seeded WN_JITTER: the small twins'
    near-pair selections then meet no exact distance tie, which the card's
    and the CPU's roundings could break apart."""
    from bemstokes_tpu_torch.mesh import SurfaceMesh

    v = mesh.vertices + WN_JITTER * np.random.default_rng(23).standard_normal(mesh.vertices.shape)
    return SurfaceMesh(v, mesh.cells, mesh.material_id, mesh.flip_normal, mesh.edge_midpoints)


def wn_wall_config(refinement, component, y=-WN_H, **kw):
    """(a): the sphere moving along x (component 0) or y beside the meshed
    no-slip plate at y, refined near the body by `refinement` (None: the
    plate as `create_wall` makes it, 2 x 2 panels), per-component solid angle."""
    from bemstokes_tpu_torch.config import ProblemConfig, WallConfig, WallRefinementConfig

    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=component,
        force_pole="Origin",
        body_manifold="sphere",
        alpha_row_sum="component",
        walls=(WallConfig(enabled=True, wall_type="no_slip", position=(0.0, y, 0.0), span=WN_SPAN),),
        wall_refinement=WallRefinementConfig(enabled=refinement is not None, **(refinement or {})),
        **kw,
    )


def wn_mixed_config(**kw):
    from bemstokes_tpu_torch.config import ProblemConfig, WallConfig

    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        walls=tuple(WallConfig(enabled=True, wall_type=k, position=p, span=s) for k, p, s in WN_MIXED),
        **kw,
    )


def wn_mixed_mesh(refinements, wall_refinements):
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.mesh.factories import create_wall

    mesh = create_sphere(refinements=refinements)
    for kind, position, span in WN_MIXED:
        mesh = mesh.merged_with(create_wall(position, span, kind, False, refinements=wall_refinements))
    return mesh


def wn_blake_config(H, quadrature=None, component=1):
    """(c): the sphere moving toward (component 1) or along the Blake image
    wall at y = -H."""
    from bemstokes_tpu_torch.config import ProblemConfig, QuadratureConfig, WallConfig

    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=component,
        force_pole="Origin",
        no_slip_kernel=True,
        body_manifold="sphere",
        walls=(WallConfig(enabled=False, position=(0.0, -H, 0.0), span=(10.0, 0.0, 10.0)),),
        quadrature=QuadratureConfig(**(quadrature or {})),
    )


def wn_spheres_config(d, refinements, **kw):
    from bemstokes_tpu_torch.config import ProblemConfig

    return ProblemConfig(
        grid_type="ImposedVelocity",
        imposed_component=0,
        force_pole="Origin",
        build_sphere_in_code=True,
        internal_sphere_refinements=refinements,
        two_spheres=True,
        spheres_distance=d,
        **kw,
    )


def wn_solve(device, mesh, cfg, shifts=((0.0, 0.0, 0.0),)):
    """(problem, [frame record]) of one problem on `device`, a frame per body
    shift (the first fresh, the rest on its stale LU): ms (host clock, the
    card synchronised), iterations, refactored, convergence, residual, the
    unknowns (tractions, wall velocities), the rigid velocities and forces,
    the drag |F_c| along the imposed component c and the column mask."""
    from bemstokes_tpu_torch.problem import StokesBEMProblem

    prob = StokesBEMProblem(mesh, cfg, device=device)
    e0 = prob.initial_euler().cpu().numpy()
    body = prob.body_node_mask > 0
    if e0.shape[0] != prob.n:
        raise AssertionError("phase 23 moves the body's nodes: the map must be the unknowns' space")
    out = []
    for shift in shifts:
        e = e0.copy()
        e[body] += np.asarray(shift)
        if prob.device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prob.solve_frame(e, np.zeros(3 * prob.n))
        if prob.device.type == "cuda":
            torch.cuda.synchronize()
        F = np.asarray(res["rigid_forces_pole"])
        out.append(
            dict(
                ms=(time.perf_counter() - t0) * 1e3,
                iterations=int(res["iterations"]),
                refactored=bool(res["refactored"]),
                converged=bool(res["converged"]),
                residual=float(res["residual"]),
                stokes_forces=res["stokes_forces"].cpu().numpy(),
                wall_velocities=res["wall_velocities"].cpu().numpy(),
                rigid_velocities=np.asarray(res["rigid_velocities"]),
                rigid_forces_pole=F,
                drag=float(abs(F[prob.cfg.imposed_component])),
                sel_V=res["operators"]["sel_V"].cpu().numpy(),
            )
        )
        del res
    return prob, out


def wn_diff(a, b):
    """Largest relative difference of two frame records' unknowns and rigid
    velocities and forces, each relative to its largest entry."""
    worst = 0.0
    for key in ("stokes_forces", "wall_velocities", "rigid_velocities", "rigid_forces_pole"):
        scale = np.abs(b[key]).max()
        if scale > 0:
            worst = max(worst, float(np.abs(a[key] - b[key]).max() / scale))
    return worst


def wn_small(device):
    """Each part's small twin, the card against the port on the CPU: equal
    column masks and iterations, unknowns within WN_CPU_TOL."""
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.mesh.factories import add_walls_to_mesh, create_body_in_code

    shifts = ((0.0, 0.0, 0.0), WN_BODY_SHIFT)
    cfg_a = wn_wall_config(WN_SMALL_REFINEMENT, 0)
    mesh_a = wn_jittered(add_walls_to_mesh(create_sphere(refinements=2), cfg_a))
    cases = [
        ("(a) refined wall, fresh and stale", mesh_a, cfg_a, shifts),
        ("(a) gather", mesh_a, wn_wall_config(WN_SMALL_REFINEMENT, 0, assembly_backend="gather"), shifts[:1]),
        (
            "(a) matrix-free",
            mesh_a,
            wn_wall_config(WN_SMALL_REFINEMENT, 0, matrix_free=True, matfree_block_nodes=WN_SMALL_BLOCK),
            shifts[:1],
        ),
        ("(b) four wall kinds", wn_jittered(wn_mixed_mesh(2, 1)), wn_mixed_config(), shifts[:1]),
        (
            "(b) four wall kinds, matrix-free",
            wn_jittered(wn_mixed_mesh(2, 1)),
            wn_mixed_config(matrix_free=True, matfree_block_nodes=32),
            shifts[:1],
        ),
    ]
    for name, quad in (("far2+auto", WN_QUADRATURES["far2+auto"]), ("uniform8", WN_QUADRATURES["uniform8"])):
        cases.append((f"(c) H = 1.1, {name}", wn_jittered(create_sphere(refinements=2)), wn_blake_config(1.1, quad), shifts[:1]))
    cfg_d = wn_spheres_config(2.2, 1)
    mesh_d = wn_jittered(create_body_in_code(cfg_d))
    cases.append(("(d) two spheres at 2.2", mesh_d, cfg_d, shifts[:1]))
    cases.append(
        ("(d) matrix-free", mesh_d, wn_spheres_config(2.2, 1, matrix_free=True, matfree_block_nodes=16), shifts[:1])
    )
    worst_all = 0.0
    for name, mesh, cfg, frame_shifts in cases:
        t0 = time.perf_counter()
        prob_c, card = wn_solve(device, mesh, cfg, frame_shifts)
        t1 = time.perf_counter()
        prob_h, host = wn_solve("cpu", mesh, cfg, frame_shifts)
        t2 = time.perf_counter()
        worst = max(wn_diff(a, b) for a, b in zip(card, host))
        iters = [(a["iterations"], b["iterations"]) for a, b in zip(card, host)]
        same_mask = all(np.array_equal(a["sel_V"], b["sel_V"]) for a, b in zip(card, host))
        log(
            f"walls and near contact, small twin {name}: {prob_c.n} nodes ({prob_c.hanging.n} hanging), promoted "
            f"{prob_c.quadrature_promoted}; card vs CPU {worst:.3e} (tol {WN_CPU_TOL:g}), iterations {iters}, "
            f"equal column masks {same_mask} ({int(card[0]['sel_V'].sum())} V columns of {len(card[0]['sel_V'])}); "
            f"card {t1 - t0:.1f} s, CPU {t2 - t1:.1f} s"
        )
        if (
            worst > WN_CPU_TOL
            or any(a != b for a, b in iters)
            or not same_mask
            or prob_c.quadrature_promoted != prob_h.quadrature_promoted
        ):
            raise AssertionError(f"walls and near contact {name}: the card disagrees with the CPU")
        worst_all = max(worst_all, worst)
    return worst_all


def wn_path(device, mesh, cfg, kernels, shifts=((0.0, 0.0, 0.0),)):
    """One full-width problem with the launch counters set to 0 just before
    it and read just after; returns (problem, records, launches that were
    not 0, peak GiB)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(*kernels.values())
    prob, recs = wn_solve(device, mesh, cfg, shifts)
    launches = {f"{name}:{k}": v for name, mod in kernels.items() for k, v in mod.launches.items() if v}
    return prob, recs, launches, torch.cuda.max_memory_allocated() / 2**30


def wn_log(name, prob, recs, launches, peak, extra=""):
    unknowns = 3 * prob.n + prob.num_rigid
    frames = "; ".join(
        f"frame {k}: {r['ms']:.1f} ms, {r['iterations']} iterations, refactored {r['refactored']}, "
        f"converged {r['converged']}, residual {r['residual']:.3e}, drag {r['drag']:.10f}"
        for k, r in enumerate(recs)
    )
    log(
        f"walls and near contact {name}: {prob.n} nodes ({prob.hanging.n} hanging, {3 * prob.hanging.n} "
        f"constrained rows), {unknowns} unknowns, promoted {prob.quadrature_promoted}, vmax x nq = "
        f"{prob.tables.inc_slot.shape[1]} x {len(prob.tables.q_weights)}; {frames}; peak {peak:.3f} GiB; "
        f"launches {launches}{extra}"
    )
    if not all(r["converged"] and np.isfinite(r["stokes_forces"]).all() for r in recs):
        raise AssertionError(f"walls and near contact {name}: a frame did not converge")
    if max(r["residual"] for r in recs) > WN_RESIDUAL:
        raise AssertionError(f"walls and near contact {name}: residual above {WN_RESIDUAL:g}")


class StageTimer:
    """Wraps a module function with a synchronised host timer: its calls and
    their ms summed, until `restore`."""

    def __init__(self, module, name):
        self.module, self.name, self.inner = module, name, getattr(module, name)
        self.calls, self.ms = 0, 0.0

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.inner(*args, **kwargs)
            torch.cuda.synchronize()
            self.calls += 1
            self.ms += (time.perf_counter() - t0) * 1e3
            return out

        setattr(module, name, timed)

    def reset(self):
        self.calls, self.ms = 0, 0.0

    def restore(self):
        setattr(self.module, self.name, self.inner)


def wn_matvec_check(matfree_node, label, prob, shape=(1, 1)):
    """K5 (free space) in `shape` on the problem's sweep against its plain
    version on the first HO_PLAIN_ROWS rows, timed over all rows."""
    from bemstokes_tpu_torch.fem.geometry import support_points
    from bemstokes_tpu_torch.physics.rigid import build_mass_operator

    dtype = torch.float64
    e = prob.initial_euler()
    sp = support_points(e, prob.map_space, prob.fe_space)
    _, (xq, normals, jxw) = build_mass_operator(e, prob.tables)
    st, arrs = matfree_node.build_sweep(prob.tables, sp, xq, normals, jxw)
    st_r, arrs_r = matfree_node.build_sweep(prob.tables, sp[:HO_PLAIN_ROWS], xq, normals, jxw)
    BV, BK = shape
    rng = np.random.default_rng(23)
    X = torch.as_tensor(rng.standard_normal((3 * st.n, BV + BK)), dtype=dtype, device=prob.device)
    XV, XK = X[:, :BV], X[:, BV:]
    (Vr, Kr), plain_ms = event_ms(
        lambda: matfree_node.sweep_matvec_reference(st_r, arrs_r, XV, XK, row_tile=64, col_chunk=1024)
    )
    V, K = matfree_node.sweep_matvec(st_r, arrs_r, XV, XK)
    err = max(rel(a, b) for a, b in ((V, Vr), (K, Kr)) if b.numel())
    abs_err = max((a - b).abs().max().item() for a, b in ((V, Vr), (K, Kr)) if b.numel())
    finite = bool(torch.isfinite(V).all() and torch.isfinite(K).all())
    ms = cuda_ms(lambda: matfree_node.sweep_matvec(st, arrs, XV, XK), reps=5)
    clock = clock_under_load(lambda: matfree_node.sweep_matvec(st, arrs, XV, XK))
    nr, n, m = st.nr, st.n, st.vmax * st.nq
    bound_ms, bound_by = matvec_bound("free_space", dtype, nr, n, m, shape)
    rec = dict(
        shape=label, launch_shape=shape_name(shape), m=m, rows=nr, cols=n, ms=ms,
        ps_per_interaction=ms * 1e9 / (nr * n * m), plain_ms=plain_ms, plain_rows=st_r.nr, bound_ms=bound_ms,
        bound_by=bound_by, max_abs_err=abs_err, max_rel_err=err, sm_clock=clock,
    )
    log(
        f"walls and near contact sweep_matvec free_space {shape} {label}: rows={nr} cols={n} m={m}: rel err on "
        f"{st_r.nr} rows {err:.3e} (tol {TOL_MATVEC[dtype]:.0e}), max abs err {abs_err:.3e}; kernel {ms:.3f} ms "
        f"({rec['ps_per_interaction']:.3f} ps an interaction), plain {plain_ms:.3f} ms on {st_r.nr} rows, bound "
        f"{bound_ms:.3f} ms by {bound_by}; SM clock, its maximum and power under this load: {clock}"
    )
    if not (finite and err <= TOL_MATVEC[dtype]):
        raise AssertionError(f"walls and near contact: sweep_matvec disagrees with its plain version at {label}")
    return rec


def phase_walls_near_contact(node_kernel, matfree_node, slot_kernel, device, counts):
    """Phase 23: meshed walls with hanging nodes, the four wall kinds, the
    near-contact sweep against the Blake wall and two spheres in near
    contact, at full width; returns the new-shape records per kernel, K5's
    free-space launches (in all and by shape) and `tile_nodes`' launches and
    (row, panel) pairs on these paths."""
    from bemstokes_tpu_torch import matfree
    from bemstokes_tpu_torch.la.direct import LUPreconditioner
    from bemstokes_tpu_torch.ops import assemble

    log(f"walls and near contact: {card_line()}")
    t0 = time.perf_counter()
    small = wn_small(device)
    log(f"walls and near contact: small twins {time.perf_counter() - t0:.1f} s, worst {small:.3e}")
    shapes = {"free_space": [], "no_slip": [], "matvec": []}
    kernels = {"K1-K4": node_kernel, "K6": slot_kernel, "K5": matfree_node}
    k5 = {"total": 0, "by_shape": {}}
    nodes = {"launches": 0, "pairs": {"f32": 0, "f64": 0}}
    near = StageTimer(assemble, "_add_near_corrections")
    near_free = StageTimer(matfree, "_near_coo")
    lu = StageTimer(LUPreconditioner, "set_up")
    try:
        wn_meshed_wall(node_kernel, matfree_node, slot_kernel, device, kernels, k5, nodes)
        shapes["matvec"].append(wn_mixed_walls(node_kernel, matfree_node, device, kernels, k5))
        shapes["no_slip"] += wn_near_contact(node_kernel, device, kernels, counts, near)
        shapes["free_space"].append(
            wn_two_spheres(node_kernel, matfree_node, device, kernels, counts, k5, near, near_free, lu)
        )
    finally:
        near.restore()
        near_free.restore()
        lu.restore()
    return shapes, (k5["total"], k5["by_shape"]), nodes["launches"], nodes["pairs"]


def wn_add_k5(matfree_node, k5):
    k5["total"] += matfree_node.launches["free_space"]
    for shape, count in shapes_of(matfree_node, "free_space").items():
        k5["by_shape"][shape] = k5["by_shape"].get(shape, 0) + count


def wn_meshed_wall(node_kernel, matfree_node, slot_kernel, device, kernels, k5, nodes):
    """(a) create_sphere(4) 2 radii above the meshed no-slip plate, refined
    near the body: along x and toward the wall, fresh and stale frames; the
    unrefined plate; a gather frame; a matrix-free frame; two frames of the
    frame loop toward the wall; and the Blake image wall on the same sphere."""
    from bemstokes_tpu_torch.config import SolverConfig
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.mesh.factories import add_walls_to_mesh

    refinements = REFINEMENTS - 1
    shifts = ((0.0, 0.0, 0.0), WN_BODY_SHIFT)
    lorentz, brenner = lorentz_drag(WN_H), 6.0 * np.pi * brenner_lambda(WN_H)
    drag = {}
    for component in (0, 1):
        cfg = wn_wall_config(WN_REFINEMENT, component)
        mesh = add_walls_to_mesh(create_sphere(refinements=refinements), cfg)
        prob, recs, launches, peak = wn_path(device, mesh, cfg, kernels, shifts)
        tally(node_kernel)
        drag[component] = recs[0]["drag"]
        exact = lorentz if component == 0 else brenner
        wn_log(
            f"(a) refined wall, {'xy'[component]}", prob, recs, launches, peak,
            f"; drag against {('Lorentz', 'Brenner')[component]} {exact:.6f}: {(recs[0]['drag'] - exact) / exact:+.4e}",
        )
        if launches != {"K1-K4:free_space": 2} or [r["refactored"] for r in recs] != [True, False]:
            raise AssertionError(f"walls and near contact (a): launches {launches} or refactor flags")
        if prob.hanging.n == 0:
            raise AssertionError("walls and near contact (a): the refined wall has no hanging node")
        if component == 0:
            node = recs[0]
            refined = prob.n
        del prob
    cfg = wn_wall_config(None, 0)
    prob, recs, launches, peak = wn_path(
        device, add_walls_to_mesh(create_sphere(refinements=refinements), cfg), cfg, kernels
    )
    tally(node_kernel)
    coarse = recs[0]["drag"]
    wn_log("(a) unrefined wall, x", prob, recs, launches, peak)
    del prob
    err_fine, err_coarse = abs(drag[0] - lorentz) / lorentz, abs(coarse - lorentz) / lorentz
    log(
        f"walls and near contact (a): {refined} nodes; x drag refined {drag[0]:.6f}, unrefined {coarse:.6f}, "
        f"Lorentz {lorentz:.6f}: errors {err_fine:.4e}, {err_coarse:.4e}; y drag {drag[1]:.6f}, Brenner "
        f"{brenner:.6f}: {(drag[1] - brenner) / brenner:+.4e}"
    )
    if not (err_fine < 0.5 * err_coarse and err_fine < 2e-2 and drag[0] < lorentz and coarse < lorentz):
        raise AssertionError("walls and near contact (a): the refined wall misses the Lorentz properties")

    # the Blake image wall (K3) on the same sphere, both directions
    for component in (0, 1):
        cfg = wn_blake_config(WN_H, component=component)
        prob, recs, launches, peak = wn_path(device, create_sphere(refinements=refinements), cfg, kernels)
        tally(node_kernel)
        exact = lorentz if component == 0 else brenner
        wn_log(
            f"(a) Blake image wall, {'xy'[component]}", prob, recs, launches, peak,
            f"; drag against {('Lorentz', 'Brenner')[component]}: {(recs[0]['drag'] - exact) / exact:+.4e}, "
            f"meshed refined wall against it: {(drag[component] - recs[0]['drag']) / recs[0]['drag']:+.4e}",
        )
        if launches != {"K1-K4:no_slip": 1}:
            raise AssertionError(f"walls and near contact (a) Blake: launches {launches}")
        del prob

    cfg = wn_wall_config(WN_REFINEMENT, 0, assembly_backend="gather")
    mesh = add_walls_to_mesh(create_sphere(refinements=refinements), cfg)
    prob, recs, launches, peak = wn_path(device, mesh, cfg, kernels)
    nodes["launches"] += slot_kernel.launches["tile_nodes"]
    nodes["pairs"]["f64"] += slot_kernel.pairs["f64"]
    diff = wn_diff(recs[0], node)
    wn_log("(a) gather", prob, recs, launches, peak, f"; against the node frame {diff:.3e} (tol {WN_MODES_TOL:g})")
    if set(launches) != {"K6:tile_nodes"} or diff > WN_MODES_TOL:
        raise AssertionError(f"walls and near contact (a) gather: launches {launches}, diff {diff}")
    del prob

    cfg = wn_wall_config(
        WN_REFINEMENT, 0, matrix_free=True, matfree_block_nodes=1024, solver=SolverConfig(tolerance=1e-11)
    )
    prob, recs, launches, peak = wn_path(device, mesh, cfg, kernels)
    tally(node_kernel)
    wn_add_k5(matfree_node, k5)
    by_shape = shapes_of(matfree_node, "free_space")
    diff = wn_diff(recs[0], node)
    wn_log(
        "(a) matrix-free", prob, recs, launches, peak,
        f", K5 by shape {by_shape}; against the node frame {diff:.3e} (tol {WN_MATFREE_TOL:g})",
    )
    check_one_sided("walls and near contact (a)", "free_space", by_shape, recs[0]["iterations"])
    if diff > WN_MATFREE_TOL:
        raise AssertionError(f"walls and near contact (a) matrix-free: diff {diff}")
    del prob, mesh

    # the frame loop: the sphere under a unit force toward the plate above it
    loop = dataclasses.replace(
        wn_wall_config(WN_REFINEMENT, 1, y=WN_H),
        grid_type="ImposedForce",
        build_sphere_in_code=True,
        internal_sphere_refinements=refinements,
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        time_step=5.0,
    )
    history, records, launches, unknowns = wall_path(node_kernel, device, "walls and near contact (a) frame loop", loop, 2)
    U = [h["rigid_velocities"][1] for h in history]
    log(f"walls and near contact (a) frame loop: {unknowns} unknowns, U_y {U}, refactored {[r['refactored'] for r in records]}")
    # approaching the plate, the sphere's mobility falls frame by frame
    if [r["refactored"] for r in records] != [True, False] or not 0 < U[1] < U[0]:
        raise AssertionError(f"walls and near contact (a) frame loop: U_y {U} or refactor flags {records}")


def wn_mixed_walls(node_kernel, matfree_node, device, kernels, k5):
    """(b) create_sphere(4) with a dirichlet, a neumann, a do-nothing and a
    free-surface plate, each refined uniformly: a materialized frame and a
    matrix-free frame (K5 two-sided); returns K5's (1, 1) record."""
    from bemstokes_tpu_torch.config import SolverConfig
    from bemstokes_tpu_torch.mesh.surface_mesh import MATERIAL_BODY

    refinements = REFINEMENTS - 1
    mesh = wn_mixed_mesh(refinements, WN_MIXED_REFINEMENTS)
    prob, recs, launches, peak = wn_path(device, mesh, wn_mixed_config(), kernels)
    tally(node_kernel)
    rec = recs[0]
    sel = rec["sel_V"]
    mats = np.tile(prob.node_material, 3)
    kinds = {int(m): (int((sel & (mats == m)).sum()), int((~sel & (mats == m)).sum())) for m in np.unique(mats)}
    wn_log(
        "(b) four wall kinds", prob, recs, launches, peak,
        f"; drag / 6 pi {rec['drag'] / (6 * np.pi):.6f}; (V, -K) columns per material {kinds}",
    )
    if launches != {"K1-K4:free_space": 1} or not 6 * np.pi < rec["drag"] < 2 * 6 * np.pi:
        raise AssertionError(f"walls and near contact (b): launches {launches} or drag {rec['drag']}")
    if not (np.all(rec["stokes_forces"][~sel] == 0) and np.all(rec["wall_velocities"][sel] == 0)):
        raise AssertionError("walls and near contact (b): the unknowns do not follow the column mask")
    if len([m for m, (v, k) in kinds.items() if m != MATERIAL_BODY and v and k]) != 2:
        raise AssertionError(f"walls and near contact (b): the split walls do not split: {kinds}")

    cfg = wn_mixed_config(matrix_free=True, matfree_block_nodes=1024, solver=SolverConfig(tolerance=1e-11))
    del prob
    prob, recs, launches, peak = wn_path(device, mesh, cfg, kernels)
    tally(node_kernel)
    wn_add_k5(matfree_node, k5)
    by_shape = shapes_of(matfree_node, "free_space")
    diff = wn_diff(recs[0], rec)
    wn_log(
        "(b) matrix-free", prob, recs, launches, peak,
        f", K5 by shape {by_shape}; against the materialized frame {diff:.3e} (tol {WN_MATFREE_TOL:g})",
    )
    if not (by_shape["1x1"] >= recs[0]["iterations"] and by_shape["1x0"] == 0 and by_shape["wide"] >= 1):
        raise AssertionError(f"walls and near contact (b): K5 launch shapes {by_shape}")
    if diff > WN_MATFREE_TOL:
        raise AssertionError(f"walls and near contact (b) matrix-free: diff {diff}")
    out = wn_matvec_check(matfree_node, "four wall kinds (b)", prob)
    out["launches_in_phase"] = by_shape["1x1"]
    return out


def wn_near_contact(node_kernel, device, kernels, counts, near):
    """(c) create_sphere(5) moving toward the Blake wall at five gaps under
    three quadratures; returns K3's records at m = 16 and 256."""
    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.mesh.proximity import wall_image_gap

    mesh = create_sphere(refinements=REFINEMENTS)
    lam, records = {}, []
    for H in WN_GAPS:
        gap, diam = wall_image_gap(mesh, 1, -H)
        for quad, q in WN_QUADRATURES.items():
            near.reset()
            prob, recs, launches, peak = wn_path(device, mesh, wn_blake_config(H, q), kernels)
            tally(node_kernel)
            r = recs[0]
            lam[H, quad] = r["drag"] / (6 * np.pi)
            truth = brenner_lambda(H)
            err = (lam[H, quad] - truth) / truth
            wn_log(
                f"(c) H = {H}, {quad}", prob, recs, launches, peak,
                f"; image gap {gap:.4f}, local panel diameter {diam:.4f}, lambda {lam[H, quad]:.8f}, Brenner "
                f"{truth:.8f}, error {err:+.4e}; near delta {near.ms:.1f} ms in {near.calls} calls",
            )
            records.append(dict(H=H, quad=quad, promoted=prob.quadrature_promoted, lam=lam[H, quad], err=err, ms=r["ms"], near_ms=near.ms))
            if launches != {"K1-K4:no_slip": 1} or prob.quadrature_promoted != (quad == "far2+auto" and gap < diam):
                raise AssertionError(f"walls and near contact (c): launches {launches} or promotion")
            if H >= 1.1 and abs(err) > WN_BRENNER_TOL:
                raise AssertionError(f"walls and near contact (c): lambda {lam[H, quad]} at H = {H} off Brenner")
            if H == WN_GAPS[0] and quad != "far2+auto":
                args = sweep_args(prob)
            if H == WN_GAPS[-1] and quad == "far2+auto":
                lu_trsv_check(f"contact sphere at H = {H}, {prob.n} nodes (23 (c))", prob.preconditioner)
            del prob
            if H == WN_GAPS[0] and quad != "far2+auto":
                label = f"m = {args[1].shape[1]}, {quad}, H = {H} (c)"
                records.append(ho_sweep_check(node_kernel, counts, label, args, "no_slip"))
                del args
    log("walls and near contact (c) sweep: " + json.dumps([r for r in records if "H" in r]))
    for H in WN_GAPS:
        promoted = [r for r in records if r.get("H") == H and r["quad"] == "far2+auto"][0]["promoted"]
        if not promoted:
            continue
        auto, full, plain = lam[H, "far2+auto"], lam[H, "uniform8"], lam[H, "far2"]
        log(
            f"walls and near contact (c) H = {H} promoted: |auto - order 8| / order 8 = {abs(auto - full) / full:.3e} "
            f"(tol {WN_RECOVERY:g}), |plain - order 8| / order 8 = {abs(plain - full) / full:.3e}"
        )
        if not (abs(auto - full) <= WN_RECOVERY * full and abs(plain - full) > 3 * abs(auto - full)):
            raise AssertionError(f"walls and near contact (c): no recovery at H = {H}")
    return [r for r in records if "shape" in r]


def wn_two_spheres(node_kernel, matfree_node, device, kernels, counts, k5, near, near_free, lu):
    """(d) two create_sphere(5) bodies along x at two distances, the
    materialized frame against Stimson and Jeffery, a matrix-free frame at
    the closer distance; returns K1's record at 12,292 nodes."""
    from bemstokes_tpu_torch.config import SolverConfig
    from bemstokes_tpu_torch.mesh.factories import create_body_in_code
    from bemstokes_tpu_torch.mesh.proximity import min_intercomponent_gap

    for d in WN_DISTANCES:
        cfg = wn_spheres_config(d, REFINEMENTS)
        mesh = create_body_in_code(cfg)
        gap, diam = min_intercomponent_gap(mesh)
        near.reset()
        lu.reset()
        prob, recs, launches, peak = wn_path(device, mesh, cfg, kernels)
        tally(node_kernel)
        lam = recs[0]["drag"] / (2 * 6 * np.pi)
        truth = stimson_jeffery_lambda(d / 2.0)
        wn_log(
            f"(d) two spheres at {d}", prob, recs, launches, peak,
            f"; gap {gap:.4f}, local panel diameter {diam:.4f}; lambda {lam:.8f}, Stimson-Jeffery {truth:.8f}, "
            f"error {(lam - truth) / truth:+.4e}; near delta {near.ms:.1f} ms in {near.calls} calls, LU "
            f"{lu.ms:.1f} ms",
        )
        if launches != {"K1-K4:free_space": 1} or prob.quadrature_promoted != (gap < diam):
            raise AssertionError(f"walls and near contact (d): launches {launches} or promotion")
        if abs(lam - truth) > WN_SJ_TOL * truth:
            raise AssertionError(f"walls and near contact (d): lambda {lam} off Stimson-Jeffery")
        if d == WN_DISTANCES[-1]:
            rec = recs[0]
            args = sweep_args(prob)
        del prob
    sweep = ho_sweep_check(node_kernel, counts, f"two spheres, {args[0].shape[0]} nodes (d)", args)
    del args
    near_free.reset()
    cfg = wn_spheres_config(
        WN_DISTANCES[-1], REFINEMENTS, matrix_free=True, matfree_block_nodes=1024, solver=SolverConfig(tolerance=1e-11)
    )
    prob, recs, launches, peak = wn_path(device, mesh, cfg, kernels)
    tally(node_kernel)
    wn_add_k5(matfree_node, k5)
    by_shape = shapes_of(matfree_node, "free_space")
    diff = wn_diff(recs[0], rec)
    wn_log(
        f"(d) matrix-free at {WN_DISTANCES[-1]}", prob, recs, launches, peak,
        f", K5 by shape {by_shape}; near COO {near_free.ms:.1f} ms in {near_free.calls} calls; against the "
        f"materialized frame {diff:.3e} (tol {WN_MATFREE_TOL:g})",
    )
    check_one_sided("walls and near contact (d)", "free_space", by_shape, recs[0]["iterations"])
    if diff > WN_MATFREE_TOL or near_free.calls < 1:
        raise AssertionError(f"walls and near contact (d) matrix-free: diff {diff}, near COO calls {near_free.calls}")
    del prob
    return sweep


#: phase 24: the swimmer gaits.  (a) the bacterium: its head sphere before
#: the remap of `spherical_head` (onto the ellipsoid (1.6, 0.8, 0.8) about
#: (-1.6, 0, 0)), right of which (x > -0.1) every node is flagellum; the
#: head's refinements and the tube's panels along and around at full width
#: (1,538 + 6,160 nodes, 23,101 unknowns with the torque unknown) and in the
#: small twin (26 + 102 nodes)
GAIT_HEAD = ((-1.0, 0.0, 0.0), 0.8)
GAIT_BACTERIUM = (REFINEMENTS - 1, (384, 16))
GAIT_BACTERIUM_SMALL = (1, (16, 6))
GAIT_FRAMES = 3  # frames of each loop
#: the bacterium's gait: frames a turn of the flagellum (11.25 degrees a
#: frame), and the gmsh files written, those the loops read (a Heun
#: predictor reads one past the last frame).  On frame 0's LU at full width a
#: turn of 11.25 / 22.5 / 45 / 90 degrees takes 56 / 115 / 300 / 1,058
#: GMRES(100) iterations (scripts/torch_frame_stages.py --bacterium
#: --turn-frames 32 / 16 / 8 / 4): four frames a turn leave frame 1
#: unconverged at max_steps 1000
GAIT_TURN = 32
GAIT_FILES = GAIT_FRAMES + 1
GAIT_WALL_Y = -3.0  # the no-slip wall of (a) and (c)
GAIT_FREE_SURFACE_Y = -4.0  # (b): the image plane of the JAX package's bench, bench.py:867-889
GAIT_SMALL_REFINEMENTS = 2  # (b) and (c)'s small twins: create_sphere(2)
GAIT_SMALL_BLOCK = 64  # the small matrix-free twin's blocks (2 of 128 nodes)
GAIT_JITTER = 1e-6  # the small bacterium's vertex jitter: its near-pair selections meet no exact tie
GAIT_CPU_TOL = 1e-10  # each small twin: the card against the CPU
GAIT_TORQUE_TOL = 1e-8  # the motor torque against -2, relative
GAIT_F32_TOL = 1e-8  # the f32-LU frame against the f64 one (GMRES to 1e-12)
GAIT_MODES_TOL = 1e-8  # the gather frame against the node frame
GAIT_MATFREE_TOL = 1e-7  # the matrix-free loop against the materialized one
GAIT_DIST_TOL = 1e-10  # the distributed loop against the single-card one
GAIT_HEUN_DIFF = 1e-3  # Heun against Forward, at least
SQUIRMER_B1 = (1.0, -0.5, 1.0)  # (c): B1 of each frame's slip B1 ((r.e) r - e), e = e_x
SQUIRMER_TOL = 1e-3  # U.e against Blake's (2/3) B1, relative
SQUIRMER_SIDE_TOL = 1e-6  # the other rigid velocities, absolute
SQUIRMER_FROZEN_TOL = 1e-9  # a frozen frame against a re-assembled one


def write_bacterium_gait(folder, head_refinements, tube, jitter=0.0, files=GAIT_FILES, turn=GAIT_TURN):
    """The bacterium's gait as `files` gmsh files `bacterium_<k>.msh` in
    folder: the head sphere GAIT_HEAD merged with the flagellum tube deformed
    to the reference spiral (`flagella.reference_spiral_euler`) and turned
    about x by 2 pi k / turn (`flagella.euler_at_theta`), every vertex moved
    by the same seeded `jitter` in each file; returns the frame-0 mesh."""
    import os

    from bemstokes_tpu_torch import flagella
    from bemstokes_tpu_torch.mesh import SurfaceMesh, create_sphere

    centre, radius = GAIT_HEAD
    head = create_sphere(center=centre, radius=radius, refinements=head_refinements)
    fc = flagella.FlagellumConfig()
    tube_mesh = flagella.create_initial_flagellum_mesh(fc, *tube)
    mask = torch.ones(tube_mesh.n_vertices, dtype=torch.float64)
    spiral = flagella.reference_spiral_euler(torch.as_tensor(tube_mesh.vertices), fc, mask)
    meshes = []
    for k in range(files):
        turned = flagella.euler_at_theta(spiral, 2.0 * np.pi * k / turn, mask).numpy()
        meshes.append(head.merged_with(SurfaceMesh(turned, tube_mesh.cells, tube_mesh.material_id)))
    offsets = jitter * np.random.default_rng(24).standard_normal(meshes[0].vertices.shape)
    for k, mesh in enumerate(meshes):
        write_msh(os.path.join(folder, f"bacterium_{k}.msh"), mesh.vertices + offsets, mesh.cells)
    return meshes[0]


def bacterium_config(grids, kernel="free_space", turn=GAIT_TURN, **kw):
    """The bacterium's loop (the JAX package's bench, bench.py:830-849) over
    a gait of `turn` frames a turn: the flagellum's rate solved from the
    motor-torque balance each frame,
    the head remapped onto the ellipsoid, rigid displacements on every axis,
    quadrature auto-promotion on; in free space or beside the no-slip wall."""
    from bemstokes_tpu_torch.config import ProblemConfig, WallConfig

    return ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        n_frames=turn,
        time_step=0.05,
        input_grid_path=grids,
        input_grid_base_name="bacterium_",
        input_grid_format="msh",
        solve_with_torque=True,
        spherical_head=True,
        consider_rigid_displacements=True,
        rigid_displacement_axes=(True, True, True),
        no_slip_kernel=kernel == "no_slip",
        walls=(WallConfig(enabled=False, position=(0.0, GAIT_WALL_Y, 0.0), span=(10.0, 0.0, 10.0)),),
        **kw,
    )


def heun_config(grids, **kw):
    """(b): the translation gait under the free-surface image kernel (the
    JAX package's bench, bench.py:867-889), Heun."""
    from bemstokes_tpu_torch.config import WallConfig

    return translation_config(
        grids,
        force_pole="Origin",
        reflect_kernel=True,
        walls=(WallConfig(enabled=False, position=(0.0, GAIT_FREE_SURFACE_Y, 0.0), span=(10.0, 0.0, 10.0)),),
        time_integration="Heun",
        **kw,
    )


def write_squirmer_gait(folder, refinements):
    """(c): create_sphere(refinements) as the one frame mesh `squirmer_0.msh`
    and each frame's slip B1 ((r.e) r - e) as a gait velocity file in folder:
    frame 1 in deal.II block_write binary, the others .npy."""
    import os

    from bemstokes_tpu_torch.mesh import create_sphere
    from bemstokes_tpu_torch.utils.dealii_io import block_write

    mesh = create_sphere(refinements=refinements)
    write_msh(os.path.join(folder, "squirmer_0.msh"), mesh.vertices, mesh.cells)
    rhat = mesh.vertices / np.linalg.norm(mesh.vertices, axis=1, keepdims=True)
    e = np.array([1.0, 0.0, 0.0])
    for k, b1 in enumerate(SQUIRMER_B1):
        slip = (b1 * ((rhat @ e)[:, None] * rhat - e)).T.reshape(-1)
        stem = os.path.join(folder, f"squirming_velocity_3d_frame_{k}")
        if k == 1:
            block_write(stem + ".bin", slip)
        else:
            np.save(stem + ".npy", slip)


def squirmer_config(folder, kernel="free_space", **kw):
    """(c): Blake's squirmer on frozen geometry: frame 0 assembles and
    factors, later frames rebuild only the rhs from the gait files."""
    from bemstokes_tpu_torch.config import ProblemConfig, WallConfig

    return ProblemConfig(
        grid_type="Real",
        force_pole="Origin",
        n_frames=1,
        input_grid_path=folder,
        input_grid_base_name="squirmer_",
        input_grid_format="msh",
        input_velocity_path=folder,
        velocity_type="Squirmer",
        squirmer_change_geometry=False,
        consider_rigid_displacements=False,
        consider_rigid_rotations=False,
        no_slip_kernel=kernel == "no_slip",
        walls=(WallConfig(enabled=False, position=(0.0, GAIT_WALL_Y, 0.0), span=(10.0, 0.0, 10.0)),),
        **kw,
    )


def launch_counts(kernels):
    return {f"{name}:{k}": v for name, mod in kernels.items() for k, v in mod.launches.items()}


def gait_run(cfg, device, frames, kernels, out):
    """SwimmerSimulation(cfg, out).run(0, frames) on `device`, the launch
    counters set to 0 just before it; every solve (a full one, a Heun
    predictor, a frozen one) recorded with its ms (the card synchronised),
    iterations, refactor flag, convergence, residual and launches.  Returns
    (simulation, record) with the history, the solves, each frame's saved
    forces, the motor torque and centre-of-mass series, the whole run's s,
    the launches that were not 0 and the peak GiB."""
    import os

    from bemstokes_tpu_torch.swimmer import SwimmerSimulation

    cuda = torch.device(device).type == "cuda"
    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_counts(*kernels.values())
    sim = SwimmerSimulation(cfg, out, device=device)
    solves = []

    def recorded(fn, kind):
        def solve(*args, **kwargs):
            if cuda:
                torch.cuda.synchronize()
            before, t0 = launch_counts(kernels), time.perf_counter()
            res = fn(*args, **kwargs)
            if cuda:
                torch.cuda.synchronize()
            after = launch_counts(kernels)
            solves.append(
                dict(
                    kind=kind,
                    ms=(time.perf_counter() - t0) * 1e3,
                    iterations=int(res["iterations"]),
                    refactored=bool(res.get("refactored", False)),
                    converged=bool(res.get("converged", True)),
                    residual=float(res["residual"]),
                    launches={k: after[k] - before[k] for k in after if after[k] != before[k]},
                )
            )
            return res

        return solve

    sim._solve = recorded(sim._solve, "full")
    sim._solve_frozen_distributed = recorded(sim._solve_frozen_distributed, "frozen")
    sim.problem.solve_frame_frozen = recorded(sim.problem.solve_frame_frozen, "frozen")
    t0 = time.perf_counter()
    history = sim.run(0, frames)
    seconds = time.perf_counter() - t0
    forces = [np.load(os.path.join(out, f"result_{k}.npz"))["stokes_forces"] for k in range(frames)]
    series = {
        name: np.loadtxt(os.path.join(out, f"{name}.txt"), ndmin=1)
        for name in ("motor_torque", "center_of_mass_position")
        if os.path.exists(os.path.join(out, f"{name}.txt"))
    }
    rec = dict(
        history=history,
        solves=solves,
        forces=forces,
        series=series,
        seconds=seconds,
        launches={k: v for k, v in launch_counts(kernels).items() if v},
        peak=torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0,
        unknowns=3 * sim.problem.n + sim.problem.num_rigid + int(cfg.solve_with_torque),
    )
    return sim, rec


def gait_diff(a, b):
    """Largest relative difference of two runs over the frames of the
    shorter: the rigid velocities, the flagellum rate and the forces, each
    relative to its largest entry."""
    worst = 0.0
    for ha, hb, fa, fb in zip(a["history"], b["history"], a["forces"], b["forces"]):
        pairs = [(ha["rigid_velocities"], hb["rigid_velocities"]), (fa, fb)]
        if "flagellum_omega" in hb:
            pairs.append(([ha["flagellum_omega"]], [hb["flagellum_omega"]]))
        for x, y in pairs:
            x, y = np.asarray(x), np.asarray(y)
            worst = max(worst, float(np.abs(x - y).max() / np.abs(y).max()))
    return worst


def gait_log(name, sim, rec, extra=""):
    """One line per path; fails the phase on a frame that did not converge
    or is not finite."""
    solves = "; ".join(
        f"{s['kind']} {s['ms']:.1f} ms, {s['iterations']} it, refactored {s['refactored']}, residual "
        f"{s['residual']:.3e}, launches {s['launches']}"
        for s in rec["solves"]
    )
    U = [[float(f"{u:.10g}") for u in h["rigid_velocities"]] for h in rec["history"]]
    omega = [h["flagellum_omega"] for h in rec["history"] if "flagellum_omega" in h]
    log(
        f"swimmer gaits {name}: {sim.problem.n} nodes, {rec['unknowns']} unknowns, promoted "
        f"{sim.problem.quadrature_promoted}; solves: {solves}; U {U}"
        + (f", flagellum rates {omega}" if omega else "")
        + f"; {rec['seconds']:.3f} s for the run, peak {rec['peak']:.3f} GiB; launches {rec['launches']}{extra}"
    )
    ok = all(s["converged"] for s in rec["solves"]) and all(np.isfinite(f).all() for f in rec["forces"])
    if not ok or not all(np.isfinite(h["rigid_velocities"]).all() for h in rec["history"]):
        raise AssertionError(f"swimmer gaits {name}: a solve did not converge or is not finite")


def solve_launches(rec, kind="full"):
    return [s["launches"] for s in rec["solves"] if s["kind"] == kind]


def check_torque(name, rec):
    """(a)'s gates: the motor torque -2 every frame (history and file), the
    body counter-rotating against the solved flagellum rate, swimming head
    first (along -x), and the centre-of-mass series written."""
    torque = rec["series"]["motor_torque"]
    com = rec["series"]["center_of_mass_position"]
    frames = len(rec["history"])
    worst = max(abs(h["motor_torque"] + 2.0) / 2.0 for h in rec["history"])
    log(
        f"swimmer gaits {name}: motor torque off -2 by {worst:.3e} (tol {GAIT_TORQUE_TOL:g}), "
        f"motor_torque.txt {torque.tolist()}, centre of mass {com.reshape(frames, -1)[:, 1:].tolist()}"
    )
    if worst > GAIT_TORQUE_TOL or torque.shape != (frames,) or np.abs(torque + 2.0).max() > GAIT_TORQUE_TOL * 2:
        raise AssertionError(f"swimmer gaits {name}: the motor torque is not -2")
    if com.reshape(frames, -1).shape != (frames, 4):
        raise AssertionError(f"swimmer gaits {name}: center_of_mass_position.txt has not a row per frame")
    for h in rec["history"]:
        U, omega = np.asarray(h["rigid_velocities"]), h["flagellum_omega"]
        if not (np.sign(U[3]) == -np.sign(omega) and abs(U[3]) < abs(omega) and U[0] < 0):
            raise AssertionError(f"swimmer gaits {name}: U {U.tolist()} against the flagellum rate {omega}")


def gait_small(device, folder, kernels):
    """Each path's small twin, the card against the port on the CPU: the
    bacterium of 128 nodes (promoted: the head-tube gap is below the head's
    panel), the translation gait and the no-slip sphere on create_sphere(2)
    under Heun, the squirmer on create_sphere(2); GAIT_CPU_TOL, equal
    iterations (the f32 LU rounds otherwise on the card: one iteration more
    or fewer to the same 1e-12, as phase 22's drag gate)."""
    import os

    from bemstokes_tpu_torch.config import SolverConfig

    bac, trans, sq = (os.path.join(folder, k, "") for k in ("bacterium_small", "translation_small", "squirmer_small"))
    for d in (bac, trans, sq):
        os.makedirs(d)
    head, tube = GAIT_BACTERIUM_SMALL
    write_bacterium_gait(bac, head, tube, GAIT_JITTER)
    write_translation_gait(trans, GAIT_SMALL_REFINEMENTS)
    write_squirmer_gait(sq, GAIT_SMALL_REFINEMENTS)
    cases = [
        ("(a) bacterium", bacterium_config(bac), GAIT_FRAMES, 0),
        ("(a) bacterium, no-slip wall", bacterium_config(bac, "no_slip"), GAIT_FRAMES, 0),
        (
            "(a) bacterium, f32 LU",
            bacterium_config(bac, solver=SolverConfig(preconditioner_dtype="float32", tolerance=1e-12)),
            1,
            1,
        ),
        ("(a) bacterium, gather", bacterium_config(bac, assembly_backend="gather"), 1, 0),
        (
            "(a) bacterium, matrix-free",
            bacterium_config(
                bac, matrix_free=True, matfree_block_nodes=GAIT_SMALL_BLOCK, solver=SolverConfig(tolerance=1e-11)
            ),
            1,
            0,
        ),
        ("(b) translation gait, free surface, Heun", heun_config(trans), 2, 0),
        ("(b) no-slip sphere, Heun", wall_config("no_slip", GAIT_SMALL_REFINEMENTS, time_integration="Heun"), 2, 0),
        ("(c) squirmer", squirmer_config(sq), GAIT_FRAMES, 0),
        ("(c) squirmer, no-slip wall", squirmer_config(sq, "no_slip"), GAIT_FRAMES, 0),
    ]
    worst_all = 0.0
    for name, cfg, frames, slack in cases:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out:
            sim_c, card = gait_run(cfg, device, frames, kernels, out)
        t1 = time.perf_counter()
        with tempfile.TemporaryDirectory() as out:
            sim_h, host = gait_run(cfg, "cpu", frames, kernels, out)
        t2 = time.perf_counter()
        worst = gait_diff(card, host)
        iters = [(a["iterations"], b["iterations"]) for a, b in zip(card["solves"], host["solves"])]
        log(
            f"swimmer gaits, small twin {name}: {sim_c.problem.n} nodes, promoted {sim_c.problem.quadrature_promoted}; "
            f"card vs CPU {worst:.3e} (tol {GAIT_CPU_TOL:g}), iterations {iters}; card {t1 - t0:.1f} s, CPU "
            f"{t2 - t1:.1f} s"
        )
        if (
            worst > GAIT_CPU_TOL
            or len(card["solves"]) != len(host["solves"])
            or any(abs(a - b) > slack for a, b in iters)
            or sim_c.problem.quadrature_promoted != sim_h.problem.quadrature_promoted
        ):
            raise AssertionError(f"swimmer gaits {name}: the card disagrees with the CPU")
        worst_all = max(worst_all, worst)
        del sim_c, sim_h
    return worst_all


def lu_trsv_check(label, pre):
    """The stale LU's kernel on a main path's own factor (the
    LUPreconditioner `pre` on the card, its plan made with the factor), f64
    and cast to f32, against `la.direct.lu_apply` (cuBLAS trsv): relative
    error, the apply's ms beside both triangles' bytes bound and the
    library's ms, the SM clock under load.  Appended to LU_TRSV_RUNS."""
    from bemstokes_tpu_torch.la.direct import lu_apply
    from bemstokes_tpu_torch.ops import lu_trsv

    lu, perm, plan = pre._factors[0], pre._perm, pre._plan
    n = lu.shape[0]
    if plan is None or lu.dtype != torch.float64:
        raise AssertionError(f"lu_trsv {label}: expected an f64 factor with a kernel plan, got {lu.dtype}, {plan}")
    g = torch.Generator(device=lu.device).manual_seed(n)
    b = torch.randn(n, generator=g, dtype=torch.float64, device=lu.device)
    x, ref = plan.solve(perm, b), lu_apply(lu, perm, b)
    err = rel(x, ref)
    lu32 = lu.mT.to(torch.float32).mT
    plan32 = lu_trsv.plan(lu32)
    b32 = b.float()
    err32 = {"kernel": rel(plan32.solve(perm, b32).double(), x), "library": rel(lu_apply(lu32, perm, b32).double(), x)}
    rec = dict(label=label, n=n, error=err, error_f32_from_f64=err32)
    for key, (f, plan_f, b_f) in {"": (lu, plan, b), "_f32": (lu32, plan32, b32)}.items():
        rec["ms" + key] = cuda_ms(lambda: plan_f.solve(perm, b_f), 20)
        rec["library_ms" + key] = cuda_ms(lambda: lu_apply(f, perm, b_f), 20)
        rec["bound_ms" + key] = n * n * f.element_size() / PEAK_BYTES * 1e3
    rec["clock"] = clock_under_load(lambda: [plan.solve(perm, b) for _ in range(50)])
    del plan32, lu32
    log(
        f"lu_trsv {label}: {n} unknowns; f64 against cuBLAS {err:.3e} (tol {TOL_LU_TRSV:g}); f32 from the f64 "
        f"solution: kernel {err32['kernel']:.3e}, cuBLAS {err32['library']:.3e} (ratio at most {LU_TRSV_F32_RATIO:g}); "
        f"apply {rec['ms']:.3f} ms (f32 {rec['ms_f32']:.3f}) against cuBLAS {rec['library_ms']:.3f} "
        f"({rec['library_ms_f32']:.3f}), bound {rec['bound_ms']:.3f} ({rec['bound_ms_f32']:.3f}) ms; clock {rec['clock']}"
    )
    if not err <= TOL_LU_TRSV or not err32["kernel"] <= LU_TRSV_F32_RATIO * err32["library"]:
        raise AssertionError(f"lu_trsv {label}: the kernel disagrees with cuBLAS")
    LU_TRSV_RUNS["records"].append(rec)


@contextlib.contextmanager
def slab_applies(label):
    """While open, the distributed step's slab LU (`parallel/solve.py`'s
    `slab_lu_factor` and `slab_lu_solve`, wrapped): its applies of one
    right-hand side (one "Slab LU apply" span each), the `slab triangles
    native` they counted (read around each apply, as the frames reset the
    timers), and the last factorization.  `lu_trsv.launches` is set to 0 on
    entry and read on exit.  Yields the record that `slab_apply_check`
    takes."""
    from bemstokes_tpu_torch.ops import lu_trsv
    from bemstokes_tpu_torch.parallel import solve
    from bemstokes_tpu_torch.utils import timers

    seen = dict(label=label, applies=0, native=0, launches=None, factors=None)
    factor, apply = solve.slab_lu_factor, solve.slab_lu_solve

    def factored(*args):
        seen["factors"] = factor(*args)
        return seen["factors"]

    def applied(LU, perm, b, mesh, plan):
        before = timers.counts.get("slab triangles native", 0)
        x = apply(LU, perm, b, mesh, plan)
        seen["applies"] += int(b.ndim == 1 or b.shape[1] == 1)
        seen["native"] += timers.counts.get("slab triangles native", 0) - before
        return x

    solve.slab_lu_factor, solve.slab_lu_solve = factored, applied
    lu_trsv.launches = 0
    try:
        yield seen
        seen["launches"] = lu_trsv.launches
    finally:
        solve.slab_lu_factor, solve.slab_lu_solve = factor, apply


def slab_apply_check(seen):
    """A distributed block's slab applies (`slab_applies`): every apply of
    one right-hand side solves both its triangles through the kernel (`slab
    triangles native` = 2 x the applies = the kernel's launches over the
    block, none elsewhere); then the row-major kernel on the block's last
    slab factor (`slab_trsv_check`)."""
    label = seen["label"]
    counts = {k: seen[k] for k in ("applies", "native", "launches")}
    log(f"slab LU {label}: {counts['applies']} applies of one right-hand side, slab triangles native "
        f"{counts['native']}, lu_trsv launches {counts['launches']}")
    if not 0 < 2 * counts["applies"] == counts["native"] == counts["launches"]:
        raise AssertionError(f"slab LU {label}: a slab triangle left the kernel, or another launch ran: {counts}")
    LU_TRSV_RUNS["slab"]["blocks"].append(dict(label=label, **counts))
    slab_trsv_check(label, *seen["factors"])
    seen["factors"] = None


def slab_trsv_check(label, LU, perm, plan):
    """The row-major kernel on a distributed path's own slab factor (LU
    [m, W m] from `slab_lu_factor`, `plan` its diagonal block read in
    place): each triangle of one right-hand side against
    `torch.linalg.solve_triangular` on the same block in f64 (relative to
    max|x|, at most TOL_LU_TRSV), and with the slab cast to f32 the
    kernel's distance from the f64 solution at most LU_TRSV_F32_RATIO times
    the library's; both triangles' ms beside their bytes bound (n^2 values
    at 3.35 TB/s) and the library's ms on the same block.  Appended to
    LU_TRSV_RUNS["slab"]["records"]."""
    from bemstokes_tpu_torch.ops import lu_trsv

    block = plan.lu if plan is not None else None
    if block is None or not plan.row_major or block.dtype != torch.float64 or plan.ld != LU.shape[1]:
        raise AssertionError(f"slab lu_trsv {label}: expected an f64 row-major plan of the slab's block, got {plan}")
    m = plan.n
    c0 = block.storage_offset() - LU.storage_offset()
    LU32 = LU.to(torch.float32)
    block32 = LU32[:, c0 : c0 + m]
    plan32 = lu_trsv.plan(block32)
    g = torch.Generator(device=LU.device).manual_seed(m)
    b = torch.randn(m, 1, generator=g, dtype=torch.float64, device=LU.device)
    b32 = b.float()

    def library(f, rhs, upper):
        return torch.linalg.solve_triangular(f, rhs, upper=upper, unitriangular=not upper)

    rec = dict(label=label, n=m, ld=plan.ld, error={}, error_f32_from_f64={})
    for upper, name in ((False, "L"), (True, "U")):
        x = plan.solve_triangle(upper, b)
        rec["error"][name] = rel(x, library(block, b, upper))
        rec["error_f32_from_f64"][name] = {
            "kernel": rel(plan32.solve_triangle(upper, b32).double(), x),
            "library": rel(library(block32, b32, upper).double(), x),
        }
    for key, p, f, rhs in (("", plan, block, b), ("_f32", plan32, block32, b32)):
        rec["ms" + key] = sum(cuda_ms(lambda u=u: p.solve_triangle(u, rhs), 20) for u in (False, True))
        rec["library_ms" + key] = sum(cuda_ms(lambda u=u: library(f, rhs, u), 20) for u in (False, True))
        rec["bound_ms" + key] = m * m * f.element_size() / PEAK_BYTES * 1e3
    del plan32, block32, LU32
    err = max(rec["error"].values())
    e32 = rec["error_f32_from_f64"]
    log(
        f"slab lu_trsv {label}: block {m} of a slab of ld {plan.ld}, row-major; f64 against solve_triangular "
        f"{rec['error']} (tol {TOL_LU_TRSV:g}); f32 from the f64 solution: {e32} (ratio at most {LU_TRSV_F32_RATIO:g}); "
        f"both triangles {rec['ms']:.3f} ms (f32 {rec['ms_f32']:.3f}) against solve_triangular {rec['library_ms']:.3f} "
        f"({rec['library_ms_f32']:.3f}), bound {rec['bound_ms']:.3f} ({rec['bound_ms_f32']:.3f}) ms"
    )
    if not err <= TOL_LU_TRSV or any(not v["kernel"] <= LU_TRSV_F32_RATIO * v["library"] for v in e32.values()):
        raise AssertionError(f"slab lu_trsv {label}: the row-major kernel disagrees with solve_triangular")
    LU_TRSV_RUNS["slab"]["records"].append(rec)


def lu_entry():
    """The kernels-line entry of `lu_trsv`: its launches over phase 24's
    bacterium loop (two an apply, every apply of the loop), the bacterium's
    record (23,101 unknowns) as its error and times, and each record; under
    `row_major`, the row-major instantiation's launches over the distributed
    blocks of phases 21 and 24 (two a slab apply), the largest slab block's
    record as its error and times, and each record."""
    records = LU_TRSV_RUNS["records"]
    main = max(records, key=lambda r: r["n"])
    slab = LU_TRSV_RUNS["slab"]
    slab_main = max(slab["records"], key=lambda r: r["n"])
    return dict(
        route="cuda",
        launches=LU_TRSV_RUNS["loop"]["launches"],
        loop=LU_TRSV_RUNS["loop"],
        **LU_KERNEL,
        **{k: v for k, v in main.items() if k not in ("label", "clock")},
        error_max=max(r["error"] for r in records),
        records=records,
        row_major=dict(
            launches=sum(b["launches"] for b in slab["blocks"]),
            blocks=slab["blocks"],
            **{k: v for k, v in slab_main.items() if k != "label"},
            error_max=max(max(r["error"].values()) for r in slab["records"]),
            records=slab["records"],
        ),
    )


def phase_swimmer_gaits(node_kernel, matfree_node, slot_kernel, device, counts):
    """Phase 24: the bacterium under the motor-torque balance, Heun time
    stepping and the frozen-geometry squirmer through SwimmerSimulation.run
    at full width; returns the new-shape records per kernel, K5's free-space
    launches (in all and by shape) and `tile_nodes`' launches and (row,
    panel) pairs on these paths."""
    import torch.distributed as dist

    from bemstokes_tpu_torch.la.direct import LUPreconditioner
    from bemstokes_tpu_torch.ops import assemble

    log(f"swimmer gaits: {card_line()}")
    kernels = {"K1-K4": node_kernel, "K6": slot_kernel, "K5": matfree_node}
    shapes = {"free_space": [], "no_slip": [], "tile_nodes": []}
    k5 = {"total": 0, "by_shape": {}}
    nodes = {"launches": 0, "pairs": {"f32": 0, "f64": 0}}
    near = StageTimer(assemble, "_add_near_corrections")
    lu = StageTimer(LUPreconditioner, "set_up")
    try:
        with tempfile.TemporaryDirectory() as folder:
            t0 = time.perf_counter()
            small = gait_small(device, folder, kernels)
            log(f"swimmer gaits: small twins {time.perf_counter() - t0:.1f} s, worst {small:.3e}")
            near.reset()
            lu.reset()
            gait_bacterium(node_kernel, matfree_node, slot_kernel, device, counts, folder, kernels, shapes, k5, nodes, near, lu)
            gait_heun(node_kernel, device, folder, kernels)
            gait_squirmer(node_kernel, device, folder, kernels)
    finally:
        near.restore()
        lu.restore()
        if dist.is_initialized():
            dist.destroy_process_group()
    return shapes, (k5["total"], k5["by_shape"]), nodes["launches"], nodes["pairs"]


def gait_bacterium(node_kernel, matfree_node, slot_kernel, device, counts, folder, kernels, shapes, k5, nodes, near, lu):
    """(a) the bacterium at 23,101 unknowns: the loop in free space (K1) and
    beside the no-slip wall (K3), frame 0 on an f32 LU, a gather frame
    (`tile_nodes`), the matrix-free loop (K5 V alone, the torque unknown in
    the Schur tail) and the distributed loop at world size 1."""
    import os

    from bemstokes_tpu_torch.config import SolverConfig
    from bemstokes_tpu_torch.mesh.proximity import min_intercomponent_gap
    from bemstokes_tpu_torch.ops import lu_trsv
    from bemstokes_tpu_torch.utils import timers

    grids = os.path.join(folder, "bacterium", "")
    os.makedirs(grids)
    head, tube = GAIT_BACTERIUM
    mesh = write_bacterium_gait(grids, head, tube)
    gap, diam = min_intercomponent_gap(mesh)
    runs = {}

    def path(name, cfg, frames, expect):
        near.reset()
        lu.reset()
        with tempfile.TemporaryDirectory() as out:
            sim, rec = gait_run(cfg, device, frames, kernels, out)
        tally(node_kernel)
        gait_log(
            f"(a) {name}", sim, rec,
            f"; head-tube gap {gap:.4f} against the local panel diameter {diam:.4f}; near delta {near.ms:.1f} ms in "
            f"{near.calls} calls; LU {lu.ms:.1f} ms in {lu.calls} factors",
        )
        if sim.problem.quadrature_promoted != (gap < diam) or not expect(rec):
            raise AssertionError(f"swimmer gaits (a) {name}: promotion or launches {rec['launches']}")
        runs[name] = rec
        return sim, rec

    for kernel in ("free_space", "no_slip"):
        name = f"bacterium, {kernel}"
        lu_trsv.launches = 0
        applies = {key: timers.counts.get(key, 0) for key in ("lu applies", "lu applies native")}
        sim, rec = path(
            name, bacterium_config(grids, kernel), GAIT_FRAMES,
            lambda r, k=kernel: r["launches"] == {f"K1-K4:{k}": GAIT_FRAMES},
        )
        applies = {key: timers.counts.get(key, 0) - v for key, v in applies.items()}
        log(f"swimmer gaits (a) {name}: lu_trsv launches {lu_trsv.launches}, {applies}")
        if not 0 < applies["lu applies"] == applies["lu applies native"] == lu_trsv.launches // 2:
            raise AssertionError(f"swimmer gaits (a) {name}: an LU apply left the kernel: {applies}, {lu_trsv.launches}")
        if kernel == "free_space":
            LU_TRSV_RUNS["loop"] = dict(launches=lu_trsv.launches, **applies)
            lu_trsv_check(f"bacterium, {sim.problem.n} nodes (24 (a))", sim.problem.preconditioner)
        check_torque(name, rec)
        if rec["solves"][0]["refactored"] is not True:
            raise AssertionError(f"swimmer gaits (a) {name}: frame 0 did not factor")
        shapes[kernel].append(
            ho_sweep_check(node_kernel, counts, f"bacterium, {sim.problem.n} nodes (24 (a))", sweep_args(sim.problem), kernel, "swimmer gaits")
        )
        del sim

    # frame 0 on an f32 LU: the JAX package's bench warns that the
    # monolithic motor-torque system overflows f32 under a plain f32 LU
    # (bench.py:779-782); the small twin above holds it against the CPU
    sim, rec = path(
        "bacterium, f32 LU", bacterium_config(grids, solver=SolverConfig(preconditioner_dtype="float32", tolerance=1e-12)), 1,
        lambda r: r["launches"] == {"K1-K4:free_space": 1},
    )
    diff = gait_diff(rec, runs["bacterium, free_space"])
    log(f"swimmer gaits (a) f32 LU: frame 0 against the f64 LU's {diff:.3e} (tol {GAIT_F32_TOL:g}), {rec['solves'][0]['iterations']} iterations")
    if diff > GAIT_F32_TOL:
        raise AssertionError(f"swimmer gaits (a) f32 LU: {diff} from the f64 LU's frame")
    del sim

    sim, rec = path(
        "bacterium, gather", bacterium_config(grids, assembly_backend="gather"), 1,
        lambda r: set(r["launches"]) == {"K6:tile_nodes"},
    )
    nodes["launches"] += slot_kernel.launches["tile_nodes"]
    nodes["pairs"]["f64"] += slot_kernel.pairs["f64"]
    diff = gait_diff(rec, runs["bacterium, free_space"])
    log(f"swimmer gaits (a) gather: frame 0 against the node frame {diff:.3e} (tol {GAIT_MODES_TOL:g})")
    if diff > GAIT_MODES_TOL:
        raise AssertionError(f"swimmer gaits (a) gather: {diff} from the node frame")
    shapes["tile_nodes"].append(
        ho_nodes_check(slot_kernel, counts, f"bacterium, head and tube, {sim.problem.n} nodes (24 (a))", sim.problem, "swimmer gaits")
    )
    del sim

    cfg = bacterium_config(grids, matrix_free=True, matfree_block_nodes=1024, solver=SolverConfig(tolerance=1e-11))
    sim, rec = path("bacterium, matrix-free", cfg, GAIT_FRAMES, lambda r: "K5:free_space" in r["launches"])
    by_shape = shapes_of(matfree_node, "free_space")
    k5["total"] += matfree_node.launches["free_space"]
    for shape, count in by_shape.items():
        k5["by_shape"][shape] = k5["by_shape"].get(shape, 0) + count
    diff = gait_diff(rec, runs["bacterium, free_space"])
    log(f"swimmer gaits (a) matrix-free: K5 by shape {by_shape}; against the materialized loop {diff:.3e} (tol {GAIT_MATFREE_TOL:g})")
    check_torque("bacterium, matrix-free", rec)
    check_one_sided("swimmer gaits (a)", "free_space", by_shape, sum(s["iterations"] for s in rec["solves"]))
    if diff > GAIT_MATFREE_TOL:
        raise AssertionError(f"swimmer gaits (a) matrix-free: {diff} from the materialized loop")
    del sim

    with slab_applies("bacterium, distributed (24 (a))") as slab:
        sim, rec = path(
            "bacterium, distributed", bacterium_config(grids, distributed=True), GAIT_FRAMES,
            lambda r: r["launches"] == {"K1-K4:free_space": GAIT_FRAMES},
        )
    slab_apply_check(slab)
    single = runs["bacterium, free_space"]
    diff = gait_diff(rec, single)
    iters = [(a["iterations"], b["iterations"]) for a, b in zip(rec["solves"], single["solves"])]
    log(f"swimmer gaits (a) distributed, world size 1: against the single-card loop {diff:.3e} (tol {GAIT_DIST_TOL:g}), iterations {iters}")
    check_torque("bacterium, distributed", rec)
    if diff > GAIT_DIST_TOL or any(a != b for a, b in iters):
        raise AssertionError(f"swimmer gaits (a) distributed: {diff} from the single-card loop")
    del sim


def gait_heun(node_kernel, device, folder, kernels):
    """(b) Heun: the translation gait of create_sphere(5) under the
    free-surface image kernel (K2) and phase 5's sphere beside the no-slip
    wall (K3), each against its Forward loop."""
    import os

    grids = os.path.join(folder, "translation", "")
    os.makedirs(grids)
    write_translation_gait(grids, REFINEMENTS)
    cases = (
        ("translation gait, free surface", heun_config(grids), "K1-K4:free_surface"),
        ("no-slip sphere", wall_config("no_slip", REFINEMENTS, time_integration="Heun"), "K1-K4:no_slip"),
    )
    for name, cfg, key in cases:
        with tempfile.TemporaryDirectory() as out:
            sim, rec = gait_run(cfg, device, GAIT_FRAMES, kernels, out)
        tally(node_kernel)
        gait_log(f"(b) {name}, Heun", sim, rec)
        del sim
        per_frame = [solve_launches(rec)[2 * k : 2 * k + 2] for k in range(GAIT_FRAMES)]
        if any(frame != [{key: 1}, {key: 1}] for frame in per_frame):
            raise AssertionError(f"swimmer gaits (b) {name}: launches a frame {per_frame}")
        with tempfile.TemporaryDirectory() as out:
            sim, fwd = gait_run(dataclasses.replace(cfg, time_integration="Forward"), device, GAIT_FRAMES, kernels, out)
        tally(node_kernel)
        gait_log(f"(b) {name}, Forward", sim, fwd)
        del sim
        diff = gait_diff(rec, fwd)
        U = [h["rigid_velocities"] for h in rec["history"]]
        log(f"swimmer gaits (b) {name}: Heun against Forward {diff:.3e} (at least {GAIT_HEUN_DIFF:g})")
        if diff < GAIT_HEUN_DIFF:
            raise AssertionError(f"swimmer gaits (b) {name}: Heun equals Forward")
        if key.endswith("no_slip") and not 0 < U[0][1] < U[1][1] < U[2][1]:
            raise AssertionError(f"swimmer gaits (b) {name}: the sphere does not sediment away from the wall: {U}")


def gait_squirmer(node_kernel, device, folder, kernels):
    """(c) the frozen squirmer on create_sphere(5): in free space against
    Blake's (2/3) B1 with no bulk launch after frame 0, a frozen frame
    against a re-assembled one, beside the no-slip wall, and distributed at
    world size 1."""
    import os

    grids = os.path.join(folder, "squirmer", "")
    os.makedirs(grids)
    write_squirmer_gait(grids, REFINEMENTS)
    runs = {}
    for kernel in ("free_space", "no_slip"):
        with tempfile.TemporaryDirectory() as out:
            sim, rec = gait_run(squirmer_config(grids, kernel), device, GAIT_FRAMES, kernels, out)
            extra = ""
            if kernel == "free_space":
                # frame 1's frozen solve against the whole pipeline at the same
                # geometry and gait velocity
                sdot = sim.shape_velocities(1, None)
                full = sim.problem.solve_frame(sim.euler_for_frame(1), sdot)
                frozen = rec["history"][1]["rigid_velocities"]
                forces = np.asarray(rec["forces"][1]).T.reshape(-1)
                U_err = np.abs(np.asarray(full["rigid_velocities"]) - frozen).max() / np.abs(frozen).max()
                f = full["stokes_forces"].cpu().numpy()
                f_err = float(np.abs(f - forces).max() / np.abs(f).max())
                extra = f"; frozen frame 1 against a re-assembled one: U {U_err:.3e}, forces {f_err:.3e} (tol {SQUIRMER_FROZEN_TOL:g})"
                del full
        # the loop's launches and the re-assembled frame's
        tally(node_kernel)
        gait_log(f"(c) squirmer, {kernel}", sim, rec, extra)
        del sim
        runs[kernel] = rec
        key = f"K1-K4:{kernel}"
        kinds = [s["kind"] for s in rec["solves"]]
        if kinds != ["full", "frozen", "frozen"] or [s["refactored"] for s in rec["solves"]] != [True, False, False]:
            raise AssertionError(f"swimmer gaits (c) {kernel}: solves {kinds}, refactor flags")
        if solve_launches(rec) != [{key: 1}] or solve_launches(rec, "frozen") != [{}, {}]:
            raise AssertionError(f"swimmer gaits (c) {kernel}: a frozen frame launched a bulk kernel")
        if kernel == "free_space":
            if max(U_err, f_err) > SQUIRMER_FROZEN_TOL:
                raise AssertionError("swimmer gaits (c): the frozen frame differs from the re-assembled one")
            for h, b1 in zip(rec["history"], SQUIRMER_B1):
                U = np.asarray(h["rigid_velocities"])
                err = abs(U[0] - 2.0 / 3.0 * b1) / abs(2.0 / 3.0 * b1)
                log(f"swimmer gaits (c) frame {h['frame']}: U.e / ((2/3) B1) - 1 = {err:.3e} (tol {SQUIRMER_TOL:g}), other components {np.abs(U[1:]).max():.3e} (tol {SQUIRMER_SIDE_TOL:g})")
                if err > SQUIRMER_TOL or np.abs(U[1:]).max() > SQUIRMER_SIDE_TOL:
                    raise AssertionError(f"swimmer gaits (c): U {U.tolist()} against Blake's (2/3) B1 = {2 / 3 * b1}")
    with tempfile.TemporaryDirectory() as out, slab_applies("squirmer, distributed (24 (c))") as slab:
        sim, rec = gait_run(squirmer_config(grids, distributed=True), device, GAIT_FRAMES, kernels, out)
    tally(node_kernel)
    slab_apply_check(slab)
    frozen_step = getattr(sim._dist_step, "frozen", None) is not None
    gait_log("(c) squirmer, distributed", sim, rec)
    del sim
    diff = gait_diff(rec, runs["free_space"])
    log(f"swimmer gaits (c) distributed, world size 1: frozen step {frozen_step}; against the single-card loop {diff:.3e} (tol {GAIT_DIST_TOL:g})")
    if not frozen_step or [s["kind"] for s in rec["solves"]] != ["full", "frozen", "frozen"] or diff > GAIT_DIST_TOL:
        raise AssertionError("swimmer gaits (c) distributed: no frozen step or a different loop")
    if solve_launches(rec, "frozen") != [{}, {}]:
        raise AssertionError("swimmer gaits (c) distributed: a frozen frame launched a bulk kernel")


def node_sweep_entry(key, kernel, record):
    """The kernels-line entry of a node sweep: its launches over the main
    paths, what they were worth in sweeps of the timed shape (create_sphere(5)
    whole) per type, and those sweeps times each type's gap between its time
    and its bound (ms): the time the launches lost to the bound."""
    sweeps = {s: PATH_INTERACTIONS[key, s] / record["interactions"] for s in ("f64", "f32")}
    lost = sweeps["f64"] * (record["ms"] - record["bound_ms"]) + sweeps["f32"] * (
        record["ms_f32"] - record["bound_ms_f32"]
    )
    return dict(
        route="cuda",
        launches=PATH_LAUNCHES[key],
        sweep_equivalent_launches=sweeps,
        ms_lost_to_bound=lost,
        **kernel,
        **record,
    )


def nodes_entry(launches, pairs, record):
    """The kernels-line entry of `tile_nodes`: its launches on the gather
    frames, what they were worth in whole create_sphere(5) bulks per type,
    and those bulks times each type's gap between its time and its bound
    (ms): the time the launches lost to the bound."""
    bulks = {s: pairs[s] / record["pairs"] for s in ("f64", "f32")}
    lost = bulks["f64"] * (record["ms"] - record["bound_ms"]) + bulks["f32"] * (
        record["ms_f32"] - record["bound_ms_f32"]
    )
    return dict(
        route="cuda",
        launches=launches,
        bulk_equivalent_launches=bulks,
        ms_lost_to_bound=lost,
        **NODES_KERNEL,
        **record,
    )


def main():
    if sys.argv[1:2] == ["--cpu-convergence"]:
        return cpu_convergence(sys.argv[2])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as folder:
        cpu_study = start_cpu_convergence(folder)
        try:
            return smoke(folder, cpu_study)
        finally:
            if cpu_study.poll() is None:
                cpu_study.kill()
                cpu_study.communicate()


def smoke(folder, cpu_study):
    from bemstokes_tpu_torch.ops import cuda_build, matfree_node, node_kernel, slot_kernel

    t_start = time.perf_counter()
    device = torch.device("cuda", 0)

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"{fn.__name__}: {time.perf_counter() - t0:.1f} s")
        return out

    phase(phase_versions, cuda_build)
    counts = phase(phase_build, cuda_build)
    records = phase(phase_kernel_vs_plain, node_kernel, device, counts)
    phase(phase_small_reference, device)
    direct = phase(phase_free_space_path, node_kernel, device)
    node_forces = [r["stokes_forces"] for r in direct]
    phase(phase_wall_paths, node_kernel, device)
    phase(phase_float32, node_kernel, device)
    matvec_records = phase(phase_matvec_vs_plain, matfree_node, node_kernel, device)
    phase(phase_matfree_small, matfree_node, device)
    matvec_launches = phase(phase_matfree_vs_materialized, matfree_node, node_kernel, device)
    # K5's free-space count is the capacity frame's: its main path
    matvec_launches["free_space"] = phase(phase_capacity, matfree_node, node_kernel, device)
    planes_record = phase(phase_planes_vs_plain, node_kernel, device, counts)
    slots_record = phase(phase_slots_vs_plain, slot_kernel, device)
    nodes_record = phase(phase_nodes_vs_plain, slot_kernel, node_kernel, device, counts)
    phase(phase_gather_small, device)
    slots_launches, nodes_launches, nodes_pairs = phase(
        phase_gather_path, node_kernel, slot_kernel, device, node_forces
    )
    phase(phase_command_line)
    phase(phase_preconditioners, node_kernel, device, direct)
    phase(phase_resistance, node_kernel, device, direct)
    phase(phase_postprocess, node_kernel, device, direct)
    phase(phase_convergence, node_kernel, device, folder, cpu_study)
    phase(phase_2d, node_kernel, matfree_node, slot_kernel, device)
    phase(phase_distributed, node_kernel, device)
    ho_shapes, ho_matvec, ho_nodes, ho_pairs = phase(
        phase_higher_order, node_kernel, matfree_node, slot_kernel, device, counts
    )
    # phase 22's launches join the main paths' counts; its new shapes stand
    # beside each kernel's main-path record
    total, by_shape = matvec_launches["free_space"]
    matvec_launches["free_space"] = (
        total + ho_matvec[0],
        {k: by_shape.get(k, 0) + ho_matvec[1].get(k, 0) for k in {*by_shape, *ho_matvec[1]}},
    )
    nodes_launches += ho_nodes
    nodes_pairs = {k: nodes_pairs[k] + ho_pairs[k] for k in nodes_pairs}
    wn_shapes, wn_matvec, wn_nodes, wn_pairs = phase(
        phase_walls_near_contact, node_kernel, matfree_node, slot_kernel, device, counts
    )
    # phase 23's likewise (K1-K4's through tally)
    total, by_shape = matvec_launches["free_space"]
    matvec_launches["free_space"] = (
        total + wn_matvec[0],
        {k: by_shape.get(k, 0) + wn_matvec[1].get(k, 0) for k in {*by_shape, *wn_matvec[1]}},
    )
    nodes_launches += wn_nodes
    nodes_pairs = {k: nodes_pairs[k] + wn_pairs[k] for k in nodes_pairs}
    sg_shapes, sg_matvec, sg_nodes, sg_pairs = phase(
        phase_swimmer_gaits, node_kernel, matfree_node, slot_kernel, device, counts
    )
    # phase 24's likewise
    total, by_shape = matvec_launches["free_space"]
    matvec_launches["free_space"] = (
        total + sg_matvec[0],
        {k: by_shape.get(k, 0) + sg_matvec[1].get(k, 0) for k in {*by_shape, *sg_matvec[1]}},
    )
    nodes_launches += sg_nodes
    nodes_pairs = {k: nodes_pairs[k] + sg_pairs[k] for k in nodes_pairs}
    new_shapes = {
        "free_space": ho_shapes["free_space"],
        "no_slip": ho_shapes["no_slip"],
        "sweep_matvec_free_space": ho_shapes["matvec"],
        "tile_nodes": ho_shapes["tile_nodes"],
    }
    wall_shapes = {
        "free_space": wn_shapes["free_space"],
        "no_slip": wn_shapes["no_slip"],
        "sweep_matvec_free_space": wn_shapes["matvec"],
    }
    kernels = [
        node_sweep_entry(kernel, KERNELS[kernel], records[kernel]) for kernel in KERNELS
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
        node_sweep_entry("planes", PLANES_KERNEL, planes_record),
        dict(route="cuda", launches=slots_launches, **SLOT_KERNEL, **slots_record),
        nodes_entry(nodes_launches, nodes_pairs, nodes_record),
        lu_entry(),
    ]
    for entry in kernels:
        key = {"node_sweep": "free_space", "node_sweep_no_slip": "no_slip"}.get(entry["name"], entry["name"])
        if key in new_shapes:
            entry["higher_order_shapes"] = new_shapes[key]
        if key in wall_shapes:
            entry["walls_near_contact_shapes"] = wall_shapes[key]
        if sg_shapes.get(key):
            entry["swimmer_gaits_shapes"] = sg_shapes[key]
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
