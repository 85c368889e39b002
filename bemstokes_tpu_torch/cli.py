"""Command-line entry point (port of `bemstokes_tpu/cli.py`) — the analog of the
reference executables `bem_stokes_2d/3d [start_frame [end_frame [compose]]]`
(`source/main.cc:5-74`).

Usage:
    python -m bemstokes_tpu_torch run   [-p params.{json,prm}] [start [end]] [-o DIR] [--device cuda|cpu] [--profile DIR]
    python -m bemstokes_tpu_torch compose [-p params] start end [-o DIR]   # offline re-aggregation
    python -m bemstokes_tpu_torch params [-p out.json] [--dim 2|3]         # write a template
    python -m bemstokes_tpu_torch convergence [-p params] [--cycles N] [--source x y z]
                                                        # (reference main.cc:34-37
                                                        # auto-generates a prm)

Like the reference, `run` executes the frame loop start..end and writes
per-frame VTU + checkpoint state to the output directory; `compose` re-reads
those dumps and aggregates composed motion (reference `composer`,
`source/bem_stokes.cc:5951-6046`); `convergence` refines the frame-0 mesh
`--cycles` times and prints the fundamental-solution recovery error per
cycle (`convergence.py`).

The frame solves and the convergence study run on the CUDA card; `--device
cpu` asks for the plain torch versions on the CPU, and without a card and
without that option the command fails.  The JAX command line's `--platform`
is this `--device`; its persistent compilation cache has no counterpart
here (torch runs eagerly).  `run --profile DIR` traces the frame loop with
`torch.profiler` (the JAX command line's `jax.profiler` trace) into a Chrome
trace in DIR, with the program's spans (`utils/timers.py`) as annotations in
it; the per-phase timers still print at the end of a run.

Several processes, one per device, run the distributed frame loop
(`"distributed": true` in the parameters):

    torchrun --nproc_per_node=W -m bemstokes_tpu_torch run -p params.json [--device cpu] ...

Each process joins the group at start-up (`parallel.multihost`), takes the
card cuda:LOCAL_RANK (or the CPU, gloo, with `--device cpu`), and rank 0
alone writes files.
"""

from __future__ import annotations

import argparse
import os
import sys


def _build_parser():
    p = argparse.ArgumentParser(prog="bemstokes_tpu_torch", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-p", "--params", default=None, help="params .json or .prm")
        sp.add_argument("--dim", type=int, default=3, choices=(2, 3))
        sp.add_argument("-o", "--output-dir", default=".")
        sp.add_argument(
            "--device",
            default="cuda",
            choices=("cuda", "cpu"),
            help="where the frame solves run: the CUDA card (default; an error "
            "without one) or the CPU (plain torch versions of every kernel, "
            "for a host-only validation run)",
        )

    run = sub.add_parser("run", help="run the frame-loop simulation")
    common(run)
    run.add_argument("start_frame", nargs="?", type=int, default=0)
    run.add_argument("end_frame", nargs="?", type=int, default=None)
    run.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="trace the frame loop with torch.profiler (host activity, and the "
        "card's kernels and copies when the run is on the card) and write it "
        "as a Chrome trace, DIR/trace.json (DIR/trace_rank<r>.json for each "
        "process of a distributed run; open it in Perfetto or chrome://tracing), "
        "the program's spans annotated in it; the per-phase timers still print "
        "at the end of the run",
    )

    comp = sub.add_parser("compose", help="offline composition of saved frames")
    common(comp)
    comp.add_argument("start_frame", type=int)
    comp.add_argument("end_frame", type=int)

    par = sub.add_parser("params", help="write a template parameter file")
    par.add_argument("-p", "--params", default="parameters_3d.json")
    par.add_argument("--dim", type=int, default=3, choices=(2, 3))

    conv = sub.add_parser(
        "convergence",
        help="fundamental-solution convergence study over n_cycles "
        "refinements (reference V_test_with_Green family)",
    )
    common(conv)
    conv.add_argument("--cycles", type=int, default=None, help="override n_cycles")
    conv.add_argument("--source", type=float, nargs="+", default=None)
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)

    from .config import ProblemConfig
    from .config_io import load_config, save_config

    if args.command == "params":
        cfg = ProblemConfig(dim=args.dim)
        save_config(cfg, args.params)
        print(f"wrote template parameters to {args.params}")
        return 0

    # "cuda" is the entry points' default device (None): it raises without a
    # card and never carries on on the CPU by itself
    device = "cpu" if args.device == "cpu" else None

    # several processes under torchrun: join the process group, one rank per
    # device; a single process goes on alone (reference: every rank enters
    # main() identically, `source/main.cc:22`)
    import torch.distributed as dist

    from .parallel.multihost import initialize_multihost, is_coordinator

    multi = initialize_multihost(device=device)
    if multi:
        print(f"multi-process: rank {dist.get_rank()}/{dist.get_world_size()}", file=sys.stderr)

    if args.params:
        cfg = load_config(args.params, dim=args.dim)
        cfg.dim = args.dim
    else:
        # reference behavior: missing parameter file -> write the template
        # and proceed with defaults (source/main.cc:34-37)
        cfg = ProblemConfig(dim=args.dim)
        path = os.path.join(args.output_dir, f"parameters_{args.dim}d.json")
        os.makedirs(args.output_dir, exist_ok=True)
        if is_coordinator():
            save_config(cfg, path)
        print(f"no parameter file given; wrote defaults to {path}", file=sys.stderr)

    if args.command == "convergence":
        from .convergence import convergence_study, format_table
        from .mesh import read_mesh
        from .problem import _resolve_manifold, frame_mesh_path

        mesh = read_mesh(frame_mesh_path(cfg, 0), dim=cfg.dim, force_material=0)
        source = tuple(args.source) if args.source else (
            (0.3, 0.3, 0.3) if cfg.dim == 3 else (0.1, 0.2)
        )
        rows = convergence_study(
            mesh,
            cfg.dim,
            source,
            n_cycles=args.cycles or cfg.n_cycles,
            manifold=_resolve_manifold(cfg),
            fe_degree=cfg.fe_degree,
            map_degree=cfg.map_degree,
            quad_order=cfg.quadrature.order,
            sing_order=cfg.quadrature.singular_order,
            device=device,
        )
        print(format_table(rows))
        return 0

    from .swimmer import SwimmerSimulation

    sim = SwimmerSimulation(cfg, output_dir=args.output_dir, device=device)
    if args.command == "run":
        end = args.end_frame if args.end_frame is not None else cfg.n_frames
        if args.profile:
            # no fallback: a profiler that cannot start fails the run
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if sim.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            with profile(activities=activities) as prof:
                sim.run(args.start_frame, end)
            os.makedirs(args.profile, exist_ok=True)
            name = f"trace_rank{dist.get_rank()}.json" if multi else "trace.json"
            prof.export_chrome_trace(os.path.join(args.profile, name))
        else:
            sim.run(args.start_frame, end)
    elif is_coordinator():
        sim.compose(args.start_frame, args.end_frame)
    if is_coordinator():
        # echo the fully-expanded parameters (used_parameters_*.prm analog)
        save_config(cfg, os.path.join(args.output_dir, f"used_parameters_{args.dim}d.json"))
    if multi:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
