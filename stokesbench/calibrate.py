"""The readings that the limits of a cell's compared numbers are set from:
the program's gaps to the reference over many seeds (the lower readings)
and the control's (the upper readings), in one process on the card.

    python3 stokesbench/calibrate.py --workload <name> --seeds 11,12,13 \
        --control-seeds 3 --seconds 8 [--out FILE]

For each seed the cell runs as the benchmark runs it (`harness.run_cell`,
untraced, a short window at the cell's own load), and the frames the run
checks are judged: the program's outputs, and for the first
`--control-seeds` seeds the control's, against the float64 reference from
the same carried state.  The control is
the reference in the precision below the one the configuration states
(float32 for float64).  The benchmark's own runs never run this."""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def readings(name, seed, seconds, control, device="cuda", problem_overrides=None, geometry_overrides=None):
    """{"program": {number: gap}, "control": {number: gap} or None, ...} of
    one seed: one run of the cell (`harness.run_cell`, untraced) with its
    control judged beside it."""
    from stokesbench import harness

    out = harness.run_cell(name, seed, seconds, 0, device=device, problem_overrides=problem_overrides,
                           geometry_overrides=geometry_overrides, control=control)
    return dict(seed=seed, frames=out["attempted"], checked=out["checked_frames"],
                program={n: c["value"] for n, c in out["checks"].items()}, control=out.get("control"),
                reference_s=out["timings"]["reference_s"], frame_quartiles=out["timings"]["frame_quartiles"])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 1
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        row = readings(args.workload, seed, args.seconds, i < args.control_seeds)
        rows.append(row)
        print(json.dumps(row), flush=True)
    out = dict(workload=args.workload, card=torch.cuda.get_device_name(0), rows=rows)
    for side in ("program", "control"):
        got = [r[side] for r in rows if r[side]]
        if got:
            out[side + "_max" if side == "program" else side + "_min"] = {
                n: (max if side == "program" else min)(g[n] for g in got) for n in got[0]
            }
    print(json.dumps({k: v for k, v in out.items() if k != "rows"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
