"""The arithmetic of the node-sweep kernels K1, K2, K3 and K4
(`bemstokes_tpu_torch/csrc/node_sweep.cu`, `csrc/node_sweep_image.cu`) on the
CPU, without a card.

The CUDA sources are compiled with g++ against a stub `cuda_runtime.h`
written by the test: `__global__` and the other qualifiers are empty,
`__shared__` is a static local, the round-to-nearest intrinsics
(`__dmul_rn` and its family) are plain operations compiled with
`-ffp-contract=off`, `rsqrt` is 1 / sqrt, and the special-function unit's
f64 seed that `rsqrt_pos` starts from (`MUFU.RSQ64H`, upper word of x in,
upper word of 1/sqrt(x) out) is `node_sweep_host_rsqrt_seed`, built with
`-DNODE_SWEEP_HOST_EMULATION`.  Each `kernel<<<grid, block, ...>>>(args);` is
rewritten into a loop over the grid's blocks, and the tiles are cut to one
thread a block (`-DNODE_SWEEP_TJ=1 -DNODE_SWEEP_TI=1`), so that
`__syncthreads()` is a no-op.  The libraries are loaded with ctypes through
their C interface, the one the wrappers in `ops/node_kernel.py` call.

Held against `node_sweep_reference` in f64, relative to max|V| and max|K|
(1e-13): K1 and K4 on create_sphere(1) and (2) with a row on a sample (the
dummy offset of an exact r^2 = 0 pair), a ragged row count and a ragged
sample count; K2 and K3 likewise for the wall normal along x, y and z.  K4
must give K1's bits (`planes_to_dense`).  Each source is built twice: with
its defaults (the f64 loops' samples a trip) and with the f32 loops' counts,
so both forms of each loop are held.  Skips where no g++ is found.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import pytest
import torch

from bemstokes_tpu_torch.fem.geometry import euler_from_mesh, support_points
from bemstokes_tpu_torch.mesh import build_scalar_space, create_sphere
from bemstokes_tpu_torch.ops import node_kernel
from bemstokes_tpu_torch.ops.assemble import AssemblyConfig, build_assembly_tables, node_sweep_inputs

CSRC = Path(node_kernel.__file__).resolve().parent.parent / "csrc"
WALL = -2.0
TOL = 1e-13

STUB = r"""
#pragma once
#include <cmath>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline dim3 threadIdx(0, 0, 0), blockIdx(0, 0, 0), blockDim, gridDim;
inline void __syncthreads() {}
template <typename T> inline T __ldg(const T* p) { return *p; }
using std::fma;
using std::sqrt;
inline float rsqrtf(float x) { return 1.0f / std::sqrt(x); }
inline double rsqrt(double x) { return 1.0 / std::sqrt(x); }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline double __dmul_rn(double a, double b) { return a * b; }
inline double __dadd_rn(double a, double b) { return a + b; }
inline int __double2hiint(double x) { int64_t b; std::memcpy(&b, &x, 8); return int(b >> 32); }
inline int __double2loint(double x) { int64_t b; std::memcpy(&b, &x, 8); return int(b & 0xffffffff); }
// MUFU.RSQ64H: the upper word of 1/sqrt(x), the lower word zero
inline double node_sweep_host_rsqrt_seed(double x) {
  double y = 1.0 / std::sqrt(x);
  int64_t b;
  std::memcpy(&b, &y, 8);
  b &= ~int64_t(0xffffffff);
  std::memcpy(&y, &b, 8);
  return y;
}
// one thread a block: a launch is a loop over the grid's blocks
template <typename F>
inline void emulate_launch(dim3 grid, dim3 block, F body) {
  gridDim = grid;
  blockDim = block;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        body();
      }
}
"""

_LAUNCH = re.compile(r"(\w+(?:<[^<>;]*>)?)\s*<<<(.*?)>>>\s*\((.*?)\);", re.S)


def _host_source(text):
    """The .cu source with each launch rewritten into `emulate_launch`."""

    def launch(m):
        grid, block = (part.strip() for part in m.group(2).split(",")[:2])
        return f"emulate_launch({grid}, {block}, [&]() {{ {m.group(1)}({m.group(3)}); }});"

    out, count = _LAUNCH.subn(launch, text)
    assert count >= 1, "no kernel launch found to rewrite"
    return out


#: the defines of each build: the sources' defaults, and the f64 loops with
#: the samples a trip that the f32 loops take (node_sweep_common.cuh `unroll`)
BUILDS = {"f64_unroll": [], "f32_unroll": ["-DNODE_SWEEP_UNROLL_AS_F32=1"]}


@pytest.fixture(scope="module", params=list(BUILDS))
def libs(request, tmp_path_factory):
    """{source stem: ctypes library} of the two node-sweep sources built with
    g++ (both compiles started together)."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    tmp = tmp_path_factory.mktemp("node_sweep_host")
    (tmp / "cuda_runtime.h").write_text(STUB)
    procs = {}
    for stem in ("node_sweep", "node_sweep_image"):
        src = tmp / f"{stem}.cpp"
        src.write_text(_host_source((CSRC / f"{stem}.cu").read_text()))
        cmd = [
            gxx, "-std=c++17", "-O2", "-fPIC", "-shared", "-ffp-contract=off",
            "-DNODE_SWEEP_HOST_EMULATION", "-DNODE_SWEEP_TJ=1", "-DNODE_SWEEP_TI=1", *BUILDS[request.param],
            f"-I{tmp}", f"-I{CSRC}", "-o", str(tmp / f"lib{stem}.so"), str(src),
        ]
        procs[stem] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    out = {}
    for stem, proc in procs.items():
        _, err = proc.communicate()
        assert proc.returncode == 0, f"g++ failed on {stem}.cu:\n{err}"
        lib = ctypes.CDLL(str(tmp / f"lib{stem}.so"))
        node_kernel.declare(lib)
        out[stem] = lib
    return out


def _sphere_inputs(refinements, rows, samples, wall_axis):
    """(xi, Yj, Nj, Wj) of create_sphere(refinements), f64, cut to `rows`
    rows and `samples` samples per column node, with row 1 moved onto a
    sample of a column node (an exact r^2 = 0 pair)."""
    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, 1)
    tables = build_assembly_tables(space, space, AssemblyConfig(dtype=torch.float64))
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, space), dtype=torch.float64)
    xi, Yj, Nj, Wj = node_sweep_inputs(euler, support_points(euler, space, space), tables)
    xi = xi[:rows].clone()
    Yj, Nj, Wj = (t[:, :samples].contiguous() for t in (Yj, Nj, Wj))
    xi[1] = Yj[3, 2]
    assert Wj[3, 2] > 0
    # rows and samples on the sphere, above the wall x[wall_axis] = WALL
    assert xi[:, wall_axis].min() > WALL and Yj[..., wall_axis].min() > WALL
    return xi, Yj, Nj, Wj


def _call(fn, xi, Yj, Nj, Wj, planes, *extra):
    nr, n, m = xi.shape[0], Yj.shape[0], Yj.shape[1]
    shape = (9, n, nr) if planes else (3 * nr, 3 * n)
    V = torch.full(shape, float("nan"), dtype=torch.float64)
    K = torch.full(shape, float("nan"), dtype=torch.float64)
    rc = fn(xi.data_ptr(), Yj.data_ptr(), Nj.data_ptr(), Wj.data_ptr(), V.data_ptr(), K.data_ptr(),
            nr, n, m, *extra, None)
    assert rc == 0
    return V, K


def _rel(A, B):
    return ((A - B).abs().max() / B.abs().max()).item()


CASES = [(1, 26, 64), (1, 25, 37), (2, 98, 64), (2, 61, 44)]


@pytest.mark.parametrize("refinements,rows,samples", CASES)
def test_k1_and_k4_match_plain_version(libs, refinements, rows, samples):
    args = _sphere_inputs(refinements, rows, samples, 1)
    V, K = _call(libs["node_sweep"].node_sweep_f64, *args, False)
    Vr, Kr = node_kernel.node_sweep_reference(*args)
    assert _rel(V, Vr) <= TOL and _rel(K, Kr) <= TOL
    # K4 runs K1's sample loop: the same bits, stored component-major
    Vp, Kp = _call(libs["node_sweep"].node_sweep_planes_f64, *args, True)
    assert torch.equal(node_kernel.planes_to_dense(Vp), V)
    assert torch.equal(node_kernel.planes_to_dense(Kp), K)


@pytest.mark.parametrize("wall_axis", [0, 1, 2])
@pytest.mark.parametrize("kernel", ["free_surface", "no_slip"])
@pytest.mark.parametrize("refinements,rows,samples", [CASES[1], CASES[3]])
def test_image_sweeps_match_plain_version(libs, kernel, wall_axis, refinements, rows, samples):
    args = _sphere_inputs(refinements, rows, samples, wall_axis)
    kind = {"free_surface": 1, "no_slip": 2}[kernel]
    V, K = _call(libs["node_sweep_image"].node_sweep_image_f64, *args, False, kind, wall_axis, WALL)
    Vr, Kr = node_kernel.node_sweep_reference(*args, kernel=kernel, wall_axis=wall_axis, wall_position=WALL)
    assert _rel(V, Vr) <= TOL and _rel(K, Kr) <= TOL


def test_image_sweep_rejects_unknown_kind_and_axis(libs):
    args = _sphere_inputs(1, 4, 16, 1)
    fn = libs["node_sweep_image"].node_sweep_image_f64
    nr, n, m = args[0].shape[0], args[1].shape[0], args[1].shape[1]
    V = torch.empty((3 * nr, 3 * n), dtype=torch.float64)
    ptrs = [a.data_ptr() for a in args] + [V.data_ptr(), V.data_ptr()]
    assert fn(*ptrs, nr, n, m, 3, 1, WALL, None) != 0
    assert fn(*ptrs, nr, n, m, 2, 3, WALL, None) != 0

