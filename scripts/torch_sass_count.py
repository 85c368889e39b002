#!/usr/bin/env python3
"""What a kernel's hot loop issues, counted from its machine code, and the
least time that instruction stream allows ("pipe floor") beside the time
measured.

    python3 scripts/torch_sass_count.py [--source bemstokes_tpu_torch/csrc/sweep_matvec.cu]
                                        [--define NAME=VALUE ...] [--label text]
                                        [--time] [--refinements 5 6] [--kinds ...]
                                        [--dtypes float64 float32]

Needs a CUDA card's host with the CUDA toolkit (nvcc, cuobjdump or nvdisasm).

1. Builds the source to a cubin for sm_90a (`nvcc -cubin`, the flags of
   `ops/cuda_build.py` plus the `--define`s) and prints what ptxas reports
   per kernel (registers, spills, shared memory).
2. Disassembles it (`cuobjdump -sass`, else `nvdisasm`) and, in every kernel
   that has one, finds the sample loop: the smallest region closed by a
   backward branch that holds a reciprocal square root (`MUFU.RSQ*`).  Its
   instructions are counted by pipe: FP64 (DFMA, DMUL, DADD, DSETP, ...),
   FP32 (FFMA, FMUL, FADD, FSETP, ...), conversions from and to 64-bit types
   (F2F and the like, a quarter of the FP64 rate), the special-function unit
   (MUFU), shared and global loads, integer and logic, branches.  Where the
   loop has arms, one trip is followed (conditional forward branches not
   taken, unconditional ones taken).  A loop
   unrolled over several samples is divided by the samples it holds (its
   MUFU.RSQ count over `--rsqrt-per-sample`, which for K5's image kinds is 2
   and is inferred from the kernel's name when not given).
3. With `--time` (the fused sweep-matvec K5 only; any source with its C
   interface, so an older copy of the file can be timed beside the present
   one): builds the same source with the same defines to a shared library,
   times `sweep_matvec` with CUDA events at create_sphere(5) and
   create_sphere(6) (6,146 and 24,578 nodes, m = 64) for each Green's
   function, type and launch shape (BV, BK) = (1, 1), (1, 0), (0, 1),
   (1, 10), samples `nvidia-smi`'s SM clock while each runs, and prints

       pipe floor = instructions per interaction x interactions
                    / (SMs x lanes x clock)

   with 64 FP64 lanes (128 FP32 lanes) a clock in each SM, for the kernel
   instantiation that serves the launch, beside the measured time; and the
   issue floor, the same with every instruction of the loop and the 128
   lanes a clock that an SM's four schedulers issue.  (A wide instantiation
   tests at run time which of its columns are real, so its count is that of
   a full chunk.)

4. With `--probe`: what the FP64 pipe itself sustains on this card, from a
   probe kernel of independent DFMA chains (and a DFMA, DMUL, DADD mix, and
   the mix with one integer instruction beside each), 32 warps an SM, 8
   chains a thread: FP64 lanes a clock in each SM as measured, which is the
   yardstick for the pipe floor's 64; and the latency in clocks of one
   dependent DFMA (one warp an SM, one chain).

Every line of the result is also written to <out>/<label>.json (`--out`,
by default sass_counts/ at the root of the repository; the disassembly goes
beside it with `--keep-sass`).
Other kernels' sources (node_sweep.cu, node_sweep_image.cu, tile_slots.cu)
take steps 1 and 2 as they are.
"""

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

FP64 = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX")
FP32 = ("FFMA", "FMUL", "FADD", "FSETP", "FMNMX", "FCHK")
CONVERT = ("F2F", "F2I", "I2F", "F2FP")
BRANCH = ("BRA", "BSSY", "BSYNC", "CALL", "RET", "EXIT", "BRX", "JMP", "WARPSYNC", "BAR")
WALL_Y = -2.0
KINDS = ("free_space", "free_surface", "no_slip")


def toolkit(name):
    from bemstokes_tpu_torch.ops import cuda_build

    found = shutil.which(name)
    return found or str(Path(cuda_build.nvcc_path()).parent / name)


def compile_flags(defines):
    from bemstokes_tpu_torch.ops import cuda_build

    keep = [f for f in cuda_build.NVCC_FLAGS if f not in ("-shared",)]
    return keep + [f"-D{d}" for d in defines]


def build_cubin(source, defines, out):
    flags = [f for f in compile_flags(defines) if f not in ("-Xcompiler", "-fPIC")]
    done = subprocess.run(
        [toolkit("nvcc"), "-cubin", *flags, "-o", str(out), str(source)],
        capture_output=True, text=True,
    )
    if done.returncode != 0:
        raise RuntimeError(f"nvcc -cubin failed:\n{done.stdout}\n{done.stderr}")
    return done.stdout + done.stderr


def disassemble(cubin):
    for tool, args in (("cuobjdump", ["-sass"]), ("nvdisasm", ["-c"])):
        path = toolkit(tool)
        if Path(path).exists():
            done = subprocess.run([path, *args, str(cubin)], capture_output=True, text=True)
            if done.returncode == 0 and done.stdout:
                return tool, done.stdout
    raise RuntimeError("neither cuobjdump nor nvdisasm is in the CUDA toolkit")


def demangle(names):
    path = toolkit("cu++filt")
    if not Path(path).exists():
        return {n: n for n in names}
    done = subprocess.run([path, *names], capture_output=True, text=True)
    lines = done.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else {n: n for n in names}


_FUNCTION = re.compile(r"^\s*(?:Function\s*:\s*(\S+)|\.text\.(\S+):|//-+ \.text\.(\S+) -+)")
_INSTRUCTION = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def functions_of(sass):
    """{mangled name: [(address, opcode, operands)]} of a disassembly; a
    predicated instruction's opcode starts with "@"."""
    out, name = {}, None
    for line in sass.splitlines():
        m = _FUNCTION.match(line)
        if m:
            name = next(g for g in m.groups() if g)
            out[name] = []
            continue
        m = _INSTRUCTION.search(line)
        if m and name is not None:
            out[name].append(
                (int(m.group(1), 16), ("@" if m.group(2) else "") + m.group(3), m.group(4))
            )
    return {k: v for k, v in out.items() if v}


def pipe_of(opcode):
    opcode = opcode.lstrip("@")
    base = opcode.split(".")[0]
    if base == "MUFU":
        return "mufu"
    if base in FP64:
        return "fp64"
    if base in FP32:
        return "fp32"
    if base in CONVERT:
        return "convert64" if "64" in opcode else "convert"
    if base in ("LDS", "LDSM"):
        return "lds"
    if base in ("LDG", "LD", "LDC", "ULDC"):
        return "ldg"
    if base in ("STS", "STG", "ST"):
        return "store"
    if base in BRANCH:
        return "branch"
    return "integer_logic"


def sample_loop(instructions):
    """The smallest region closed by a backward branch that holds a MUFU.RSQ;
    None when the function has none."""
    index = {addr: k for k, (addr, _, _) in enumerate(instructions)}
    best = None
    for k, (addr, opcode, operands) in enumerate(instructions):
        if not opcode.lstrip("@").startswith("BRA"):
            continue
        target = re.search(r"0x([0-9a-f]+)", operands)
        if not target:
            continue
        t = int(target.group(1), 16)
        if t > addr or t not in index:
            continue
        region = instructions[index[t] : k + 1]
        if any(op.lstrip("@").startswith("MUFU.RSQ") for _, op, _ in region):
            if best is None or len(region) < len(best):
                best = region
    return best


def one_trip(region):
    """The instructions one trip of the loop executes where it has arms: from
    the top, a conditional forward branch is not taken and an unconditional
    one is, up to the backward branch.  (K5 keeps the dummy offset of an
    exact r^2 = 0 pair in a second arm of equal arithmetic; the library
    rsqrt calls its special cases out of line.)"""
    index = {addr: k for k, (addr, _, _) in enumerate(region)}
    k, trip = 0, []
    while k < len(region):
        addr, opcode, operands = region[k]
        trip.append(region[k])
        if opcode == "BRA":
            target = re.search(r"0x([0-9a-f]+)", operands)
            t = int(target.group(1), 16) if target else None
            if t in index and t > addr:
                k = index[t]
                continue
        k += 1
    return trip


def template_ints(name):
    """The integer template arguments of a mangled kernel name, and its
    element type (d or f)."""
    m = re.search(r"I([df])((?:L[ib]\d+E)+)E", name)
    if not m:
        return None, []
    return m.group(1), [int(v) for v in re.findall(r"L[ib](\d+)E", m.group(2))]


def count_loops(sass, rsqrt_per_sample):
    functions = functions_of(sass)
    pretty = demangle(list(functions))
    rows = []
    for name, instructions in functions.items():
        region = sample_loop(instructions)
        if region is None:
            continue
        region = one_trip(region)
        counts = {}
        for _, opcode, _ in region:
            pipe = pipe_of(opcode)
            counts[pipe] = counts.get(pipe, 0) + 1
        rsq = sum(1 for _, op, _ in region if op.lstrip("@").startswith("MUFU.RSQ"))
        dtype, ints = template_ints(name)
        per = rsqrt_per_sample
        if per is None:
            # K5: template arguments start with the Green's function; the
            # image kinds take one rsqrt for the point and one for its mirror
            per = 2 if ("sweep_matvec" in name and ints and ints[0] != 0) else 1
        samples = max(1, rsq // per)
        rows.append(
            dict(
                function=pretty[name],
                mangled=name,
                dtype={"d": "float64", "f": "float32"}.get(dtype),
                template_ints=ints,
                loop_instructions=len(region),
                samples_in_loop=samples,
                per_sample={k: v / samples for k, v in sorted(counts.items())},
                opcodes={
                    op: n / samples
                    for op, n in sorted(
                        {o: sum(1 for _, q, _ in region if q.lstrip("@").split(".")[0] == o)
                         for o in {q.lstrip("@").split(".")[0] for _, q, _ in region}}.items()
                    )
                },
            )
        )
    return rows


PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>
template <int MODE, int CHAINS>
__global__ void probe_kernel(double* out, int iters, double b, double c) {
  double a[CHAINS];
  int k = threadIdx.x;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) a[j] = threadIdx.x + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) {
      if (MODE == 0) a[j] = fma(a[j], b, c);
      if (MODE >= 1) a[j] = j % 3 == 0 ? fma(a[j], b, c) : j % 3 == 1 ? a[j] * b : a[j] + c;
      if (MODE == 2) k = (k ^ i) + j;
    }
  }
  double sum = k;
#pragma unroll
  for (int j = 0; j < CHAINS; ++j) sum += a[j];
  out[static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x] = sum;
}
extern "C" int probe(int mode, int chains, double* out, int iters, int blocks, int threads,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (chains == 1) probe_kernel<0, 1><<<blocks, threads, 0, st>>>(out, iters, 0.999, 1e-3);
  else if (mode == 0) probe_kernel<0, 8><<<blocks, threads, 0, st>>>(out, iters, 0.999, 1e-3);
  else if (mode == 1) probe_kernel<1, 9><<<blocks, threads, 0, st>>>(out, iters, 0.999, 1e-3);
  else probe_kernel<2, 9><<<blocks, threads, 0, st>>>(out, iters, 0.999, 1e-3);
  return static_cast<int>(cudaGetLastError());
}
"""


def probe_pipe(emit):
    """The FP64 pipe's sustained rate and a dependent DFMA's latency."""
    import torch

    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "probe.cu", Path(tmp) / "libprobe.so"
        src.write_text(PROBE_SOURCE)
        done = subprocess.run(
            [toolkit("nvcc"), *compile_flags([]), "-shared", "-o", str(lib_path), str(src)],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe:\n{done.stdout}\n{done.stderr}")
        lib = ctypes.CDLL(str(lib_path))
        lib.probe.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        out = torch.empty(sms * 4 * 256, dtype=torch.float64, device=device)
        sampler = ClockSampler()
        stream = torch.cuda.current_stream().cuda_stream
        try:
            cases = (
                ("DFMA, 8 chains a thread, 32 warps an SM", 0, 8, sms * 4, 256, 1 << 21),
                ("DFMA, DMUL, DADD in turn, 9 chains", 1, 9, sms * 4, 256, 1 << 21),
                ("the same with an integer add and xor per FP64 instruction", 2, 9, sms * 4, 256, 1 << 21),
                ("one dependent DFMA chain, one warp an SM", 0, 1, sms, 32, 1 << 22),
            )
            for name, mode, chains, blocks, threads, iters in cases:
                def call():
                    if lib.probe(mode, chains, out.data_ptr(), iters, blocks, threads, stream) != 0:
                        raise RuntimeError("the probe kernel did not launch")
                call()
                torch.cuda.synchronize()
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                t0 = time.perf_counter()
                start.record()
                for _ in range(3):
                    call()
                end.record()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                ms = start.elapsed_time(end) / 3
                clock = sampler.between(t0, t1)
                cycles = ms * 1e-3 * clock["sm_clock_mhz"] * 1e6
                record = dict(probe=name, ms=ms, clock=clock)
                if chains == 1:
                    record["clocks_per_dependent_dfma"] = cycles / iters
                else:
                    record["fp64_lanes_per_clock_per_sm"] = blocks * threads * chains * iters / cycles / sms
                emit(record)
        finally:
            sampler.stop()


class ClockSampler:
    """`nvidia-smi` polled in the background: (time, SM clock MHz, max SM clock
    MHz, power W)."""

    def __init__(self, period_ms=50):
        self.samples = []
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", str(period_ms)],
            stdout=subprocess.PIPE, text=True,
        )
        self._thread = threading.Thread(target=self._read, daemon=True)
        self._thread.start()

    def _read(self):
        for line in self._proc.stdout:
            try:
                sm, top, power = (float(v) for v in line.split(","))
            except ValueError:
                continue
            self.samples.append((time.perf_counter(), sm, top, power))

    def between(self, t0, t1):
        for _ in range(100):  # nvidia-smi takes a moment to give its first line
            if self.samples:
                break
            time.sleep(0.05)
        inside = [s for s in self.samples if t0 <= s[0] <= t1]
        if not inside and self.samples:
            inside = [min(self.samples, key=lambda s: abs(s[0] - t1))]
        if not inside:
            return None
        clocks = sorted(s[1] for s in inside)
        return dict(
            sm_clock_mhz=clocks[len(clocks) // 2], max_sm_clock_mhz=inside[0][2],
            power_w=sum(s[3] for s in inside) / len(inside), samples=len(inside),
        )

    def stop(self):
        self._proc.terminate()
        self._proc.wait()


def sweep_case(refinements, dtype, device, kernel):
    """(SweepStatic, arrays) as the matrix-free setup builds them on
    create_sphere(refinements), wall at y = WALL_Y."""
    import torch

    from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
    from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
    from bemstokes_tpu_torch.ops import matfree_node
    from bemstokes_tpu_torch.ops.assemble import AssemblyConfig, build_assembly_tables
    from bemstokes_tpu_torch.physics.rigid import build_mass_operator

    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(
        space, space, AssemblyConfig(dtype=dtype, kernel=kernel, wall_axis=1, wall_position=WALL_Y)
    )
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=dtype, device=device)
    _, (xq, normals, jxw) = build_mass_operator(euler, tables)
    return matfree_node.build_sweep(tables, support_points(euler, space, space), xq, normals, jxw)


def serving_row(rows, dtype, kind, BV, BK):
    """The counted instantiation that serves a (BV, BK) launch: narrow shapes
    have their own where the source instantiates them, everything else goes
    through the widest."""
    mine = [
        r for r in rows
        if "sweep_matvec_kernel" in r["mangled"] and r["dtype"] == dtype
        and r["template_ints"] and r["template_ints"][0] == KINDS.index(kind)
    ]
    # with a wall-axis template argument (older sources): the y axis, which
    # the timed shapes use
    if mine and len(mine[0]["template_ints"]) == 4:
        mine = [r for r in mine if r["template_ints"][1] == (0 if kind == "free_space" else 1)]
    by_shape = {tuple(r["template_ints"][-2:]): r for r in mine}
    if (BV, BK) in by_shape:
        return by_shape[BV, BK]
    wide = max(max(s) for s in by_shape)
    for shape in ((0, wide) if BV == 0 else None, (wide, 0) if BK == 0 else None, (wide, wide)):
        if shape in by_shape:
            return by_shape[shape]
    return None


def time_sweeps(source, defines, rows, args, emit):
    import numpy as np
    import torch

    from bemstokes_tpu_torch.ops import cuda_build, matfree_node

    if not torch.cuda.is_available():
        raise SystemExit("--time needs a CUDA card")
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        lib_path = Path(tmp) / "libsweep.so"
        done = subprocess.run(
            [toolkit("nvcc"), *compile_flags(defines), "-shared", "-o", str(lib_path), str(source)],
            capture_output=True, text=True,
        )
        if done.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{done.stdout}\n{done.stderr}")
        lib = ctypes.CDLL(str(lib_path))
        matfree_node.declare(lib)
        # `sweep_matvec` launches through this library from here on
        cuda_build._libs[matfree_node.SOURCE] = lib
        sampler = ClockSampler()
        rng = np.random.default_rng(0)
        try:
            for kind in args.kinds:
                for dtype_name in args.dtypes:
                    dtype = getattr(torch, dtype_name)
                    for refinements in args.refinements:
                        st, arrs = sweep_case(refinements, dtype, device, kind)
                        X = torch.as_tensor(
                            rng.standard_normal((3 * st.n, 10)), dtype=dtype, device=device
                        )
                        for BV, BK in ((1, 1), (1, 0), (0, 1), (1, 10)):
                            XV, XK = X[:, :BV].contiguous(), X[:, :BK].contiguous()
                            call = lambda: matfree_node.sweep_matvec(st, arrs, XV, XK)  # noqa: E731
                            call()
                            torch.cuda.synchronize()
                            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                            start.record(); call(); end.record()
                            torch.cuda.synchronize()
                            reps = max(3, math.ceil(1e3 * args.min_seconds / start.elapsed_time(end)))
                            t0 = time.perf_counter()
                            start.record()
                            for _ in range(reps):
                                call()
                            end.record()
                            torch.cuda.synchronize()
                            t1 = time.perf_counter()
                            ms = start.elapsed_time(end) / reps
                            clock = sampler.between(t0, t1)
                            inter = st.nr * st.n * st.vmax * st.nq
                            row = serving_row(rows, dtype_name, kind, BV, BK)
                            record = dict(
                                timed=f"{kind} {dtype_name} nodes={st.n} (BV,BK)=({BV},{BK})",
                                ms=ms, reps=reps, interactions=inter, clock=clock,
                            )
                            if row is not None and clock is not None:
                                pipe = "fp64" if dtype_name == "float64" else "fp32"
                                lanes = 64 if pipe == "fp64" else 128
                                issued = row["per_sample"].get(pipe, 0.0)
                                # conversions from and to 64-bit types run at a
                                # quarter of the FP64 rate
                                issued64 = issued + 4 * row["per_sample"].get("convert64", 0.0)
                                record.update(
                                    instantiation=row["template_ints"],
                                    pipe=pipe,
                                    pipe_instructions_per_sample=issued,
                                    all_instructions_per_sample=row["loop_instructions"]
                                    / row["samples_in_loop"],
                                    pipe_floor_ms=1e3 * (issued64 if pipe == "fp64" else issued) * inter
                                    / (sms * lanes * clock["sm_clock_mhz"] * 1e6),
                                    # every instruction of the loop through the SM's
                                    # four schedulers, one warp instruction a clock each
                                    issue_floor_ms=1e3 * row["loop_instructions"] / row["samples_in_loop"]
                                    * inter / (sms * 128 * clock["sm_clock_mhz"] * 1e6),
                                )
                            emit(record)
                        del arrs
                        torch.cuda.empty_cache()
        finally:
            sampler.stop()


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--source", default=str(ROOT / "bemstokes_tpu_torch/csrc/sweep_matvec.cu"))
    ap.add_argument("--define", action="append", default=[], help="NAME=VALUE, passed as -D")
    ap.add_argument("--label", default=None)
    ap.add_argument("--rsqrt-per-sample", type=int, default=None)
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--refinements", type=int, nargs="+", default=[5, 6])
    ap.add_argument("--kinds", nargs="+", default=list(KINDS), choices=KINDS)
    ap.add_argument("--dtypes", nargs="+", default=["float64", "float32"])
    ap.add_argument("--min-seconds", type=float, default=0.6, help="least timed span per shape")
    ap.add_argument("--opcodes", action="store_true", help="print the per-opcode counts too")
    ap.add_argument("--probe", action="store_true", help="measure the FP64 pipe itself")
    ap.add_argument("--keep-sass", action="store_true", help="keep the disassembly")
    ap.add_argument("--out", default=str(ROOT / "sass_counts"), help="directory of the result files")
    args = ap.parse_args()

    source = Path(args.source).resolve()
    label = args.label or (source.stem + ("_" + "_".join(args.define) if args.define else ""))
    out_dir = Path(args.out).resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    lines = []

    def emit(record):
        lines.append(record)
        print(json.dumps(record), flush=True)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True,
    ).stdout.strip()
    emit(dict(label=label, source=str(source.relative_to(ROOT)) if ROOT in source.parents else str(source),
              defines=args.define, card=card))
    with tempfile.TemporaryDirectory() as tmp:
        cubin = Path(tmp) / "kernel.cubin"
        ptxas = build_cubin(source, args.define, cubin)
        entry = None
        for line in ptxas.splitlines():
            if "Compiling entry function" in line:
                entry = re.search(r"'(\S+)'", line).group(1)
            elif "Used " in line and entry:
                emit(dict(ptxas=entry, used=line.split("Used", 1)[1].strip()))
            elif "spill" in line and entry and "0 bytes spill stores, 0 bytes spill loads" not in line:
                emit(dict(ptxas=entry, spills=line.strip()))
        tool, sass = disassemble(cubin)
        if args.keep_sass:
            (out_dir / f"{label}.sass").write_text(sass)
    rows = count_loops(sass, args.rsqrt_per_sample)
    for row in rows:
        shown = dict(row)
        if not args.opcodes:
            shown.pop("opcodes")
        shown.pop("mangled")
        emit(dict(disassembler=tool, **shown))
    if args.probe:
        probe_pipe(emit)
    if args.time:
        time_sweeps(source, args.define, rows, args, emit)
    (out_dir / f"{label}.json").write_text("\n".join(json.dumps(r) for r in lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
