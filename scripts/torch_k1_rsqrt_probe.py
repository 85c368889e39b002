#!/usr/bin/env python3
"""One exploratory timing for the redesign of the node sweeps K1-K3: K1
(`csrc/node_sweep.cu`) built once more with K5's `rsqrt_pos` in place of
`rsqrt_t`, beside the kernel as it is.

    python3 scripts/torch_k1_rsqrt_probe.py

Needs a CUDA card and nvcc.  The patched source lives in a temporary
directory only; the package's K1 does not change.  Prints, for
create_sphere(5) whole (6,146 x 6,146 x 64 interactions) in f64: the time of
each build (CUDA events, mean of 10, in the order present, patched, patched,
present), the patched kernel's largest difference from the plain version and
from the present kernel (relative to the largest entry), and what each
build's sample loop issues per interaction (`torch_sass_count.py`'s count).
"""

import ctypes
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bemstokes_tpu_torch.ops import cuda_build, node_kernel  # noqa: E402


def load_sass_count():
    spec = importlib.util.spec_from_file_location("torch_sass_count", ROOT / "scripts/torch_sass_count.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    sass_count = load_sass_count()
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    device = torch.device("cuda", 0)
    print(chip_smoke.card_line())
    source = node_kernel.SOURCES[node_kernel.KERNEL_FREE_SPACE]
    present = node_kernel._library(source)  # builds and declares the package's K1
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        text = source.read_text()
        if text.count("rsqrt_t(") != 1:
            raise RuntimeError("expected one rsqrt_t call in node_sweep.cu")
        patched_source = tmp / source.name
        patched_source.write_text(text.replace("rsqrt_t(", "rsqrt_pos("))
        (tmp / cuda_build.HEADER.name).write_text(cuda_build.HEADER.read_text())
        lib_path = tmp / "libnode_sweep_patched.so"
        subprocess.run(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-o", str(lib_path), str(patched_source)],
            check=True, capture_output=True, text=True,
        )
        patched = ctypes.CDLL(str(lib_path))
        for name in ("node_sweep_f32", "node_sweep_f64", "node_sweep_planes_f32", "node_sweep_planes_f64"):
            getattr(patched, name).argtypes = getattr(present, name).argtypes
            getattr(patched, name).restype = ctypes.c_int
        counts = {}
        for label, src in (("present", source), ("patched", patched_source)):
            cubin = tmp / f"{label}.cubin"
            sass_count.build_cubin(src, [], cubin)
            _, sass = sass_count.disassemble(cubin)
            counts[label] = [
                dict(function=r["function"][:80], per_sample=r["per_sample"])
                for r in sass_count.count_loops(sass, 1)
                if r["dtype"] == "float64"
            ]

        xi, Yj, Nj, Wj = chip_smoke.kernel_inputs(chip_smoke.REFINEMENTS, torch.float64, device)

        def use(lib):
            cuda_build._libs[source] = lib

        def sweep():
            return node_kernel.node_sweep(xi, Yj, Nj, Wj)

        times = []
        for label, lib in (("present", present), ("patched", patched), ("patched", patched), ("present", present)):
            use(lib)
            times.append((label, chip_smoke.cuda_ms(sweep, reps=10)))
        use(present)
        V0, K0 = sweep()
        use(patched)
        V1, K1 = sweep()
        use(present)
        Vr, Kr = node_kernel.node_sweep_reference(xi, Yj, Nj, Wj, row_tile=64, col_chunk=1024)
        print(json.dumps(dict(
            shape=f"rows={xi.shape[0]} cols={Yj.shape[0]} m={Yj.shape[1]} float64",
            ms=times,
            patched_vs_plain=max(chip_smoke.rel(V1, Vr), chip_smoke.rel(K1, Kr)),
            present_vs_plain=max(chip_smoke.rel(V0, Vr), chip_smoke.rel(K0, Kr)),
            patched_vs_present=max(chip_smoke.rel(V1, V0), chip_smoke.rel(K1, K0)),
            sample_loop=counts,
        )))
    return 0


if __name__ == "__main__":
    sys.exit(main())
