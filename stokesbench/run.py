"""Run one cell of the benchmark once and print its result line.

    python3 stokesbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or `python3 -m stokesbench.run ...`) from the root of a checkout, on a
machine with as many CUDA cards as the cell's `chips` (one process a card,
this one rank 0: `ranks.py`).  The last line of standard output is the result
(JSON); the numbers compared with the reference, each beside its limit,
are the last lines of standard error.  Without a card, or with a module of
JAX or of the JAX package loaded once the window has closed, it prints no
result and exits with 1."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".stokesbench_cache"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths (the
    # port builds its kernels into bemstokes_tpu_torch/_build/ itself)
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    # one host thread for the program's numpy and torch CPU work: with a
    # pool of eight, a host-bound loop's frames spread three times wider
    # from run to run
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    torch.set_num_threads(1)
    from stokesbench import harness

    chips = harness.Cell.find(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"stokesbench: {args.workload} runs on {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1

    result = harness.run_cell(args.workload, args.seed, args.seconds, args.trace, device="cuda", t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"stokesbench: modules of JAX or the JAX package were loaded: {found}", file=sys.stderr)
        return 1
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
