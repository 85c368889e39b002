"""The arithmetic of the node-sweep kernels K1, K2, K3 and K4
(`bemstokes_tpu_torch/csrc/node_sweep.cu`, `csrc/node_sweep_image.cu`) and of
the slot kernel's node-column entry point `tile_nodes` (K6,
`csrc/tile_slots.cu`) on the CPU, without a card.

The CUDA sources are compiled with g++ against a stub `cuda_runtime.h`
written by the test: `__global__` and the other qualifiers are empty,
`__shared__` is a static local, the round-to-nearest intrinsics
(`__dmul_rn` and its family) are plain operations compiled with
`-ffp-contract=off`, `rsqrt` is 1 / sqrt, and the special-function unit's
f64 seed that `rsqrt_pos` starts from (`MUFU.RSQ64H`, upper word of x in,
upper word of 1/sqrt(x) out) is `node_sweep_host_rsqrt_seed`, built with
`-DNODE_SWEEP_HOST_EMULATION`.  Each `kernel<<<grid, block, ...>>>(args);` is
rewritten into a loop over the grid's blocks.  The node sweeps' tiles are
cut to one thread a block (`-DNODE_SWEEP_TJ=1 -DNODE_SWEEP_TI=1`), so that
`__syncthreads()` is a no-op.  `tile_nodes` keeps its warps
(`NODE_WARPS`, the panels of a round) with one row a warp
(`-DTILE_NODES_ROWS=1`): its block of 1 x S lanes runs as S host threads,
`__syncthreads()` a barrier between them, its dynamic shared memory a
static buffer (`node_sweep_host_shared`), so the rounds of the group
schedule are held as the card runs them.  The libraries are loaded with
ctypes through their C interface, the one the wrappers in
`ops/node_kernel.py` and `ops/slot_kernel.py` call.

Held in f64, relative to max|V| and max|K| (1e-13): K1 and K4 against
`node_sweep_reference` on create_sphere(1) and (2) with a row on a sample
(the dummy offset of an exact r^2 = 0 pair), a ragged row count and a
ragged sample count; K2 and K3 likewise for the wall normal along x, y and
z.  K4 must give K1's bits (`planes_to_dense`).  Each node-sweep source is
built twice: with its defaults (the f64 loops' samples a trip) and with the
f32 loops' counts, so both forms of each loop are held.  `tile_nodes`
against `tile_nodes_reference` (the gather-reduce of `tile_slots_reference`)
on create_sphere(1) and (2), Q1 and Q2 panels (4 and 9 local nodes, passes
of 4 and 3 that divide them) and Q4 on create_sphere(1) (25 local nodes: a
last pass that is cut short), a ragged row count, rows on their own panels
(masked) and rows out of order; two calls give the same bits.  And the
shapes of the higher-order element configurations: K1 at 144, 100, 16 and
64 samples per column node (a Q4 map at quadrature 6, a Q3 map at 5, Q0 and
Q2 unknowns; 100 leaves a last pass of 4 samples of the 16 staged), K3 at
144, and `tile_nodes` with Q0 panels (one local node: `LB = 4, EXACT =
false`) and with 36 panel points under Q1 and Q2 panels.  Skips where no g++
is found.
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
from bemstokes_tpu_torch.ops import node_kernel, slot_kernel
from bemstokes_tpu_torch.ops.assemble import AssemblyConfig, build_assembly_tables, node_sweep_inputs, slot_inputs
import torch_threads  # noqa: F401  (one torch thread a test process)

CSRC = Path(node_kernel.__file__).resolve().parent.parent / "csrc"
WALL = -2.0
TOL = 1e-13

STUB = r"""
#pragma once
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8, cudaFuncAttributePreferredSharedMemoryCarveout = 9 };
enum cudaSharedCarveout { cudaSharedmemCarveoutMaxShared = 100 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename F> inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) { return cudaSuccess; }
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx(0, 0, 0);
inline dim3 blockIdx(0, 0, 0), blockDim, gridDim;
// the threads of one emulated block meet at __syncthreads()
struct HostBarrier {
  std::mutex m;
  std::condition_variable cv;
  unsigned n = 1, count = 0, phase = 0;
  void wait() {
    std::unique_lock<std::mutex> lk(m);
    const unsigned ph = phase;
    if (++count == n) {
      count = 0;
      ++phase;
      cv.notify_all();
    } else {
      cv.wait(lk, [&] { return phase != ph; });
    }
  }
};
inline HostBarrier block_barrier;
inline void __syncthreads() { if (block_barrier.n > 1) block_barrier.wait(); }
inline void __syncwarp() {}
// a block's dynamic shared memory (blocks run one after another)
inline void* node_sweep_host_shared() {
  static std::vector<double> buffer(1 << 20);
  return buffer.data();
}
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
// a launch is a loop over the grid's blocks; a block of several threads
// runs them as host threads
template <typename F>
inline void emulate_launch(dim3 grid, dim3 block, F body) {
  gridDim = grid;
  blockDim = block;
  const unsigned threads = block.x * block.y * block.z;
  block_barrier.n = threads;
  for (unsigned z = 0; z < grid.z; ++z)
    for (unsigned y = 0; y < grid.y; ++y)
      for (unsigned x = 0; x < grid.x; ++x) {
        blockIdx = dim3(x, y, z);
        if (threads == 1) {
          body();
          continue;
        }
        std::vector<std::thread> pool;
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx)
              pool.emplace_back([&body, tx, ty, tz] {
                threadIdx = dim3(tx, ty, tz);
                body();
              });
        for (auto& th : pool) th.join();
      }
  block_barrier.n = 1;
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


def _build(tmp, stem, defines):
    """Start g++ on csrc/<stem>.cu with the launches rewritten; returns
    (library path, process)."""
    src = tmp / f"{stem}.cpp"
    src.write_text(_host_source((CSRC / f"{stem}.cu").read_text()))
    cmd = [
        shutil.which("g++"), "-std=c++17", "-O2", "-fPIC", "-shared", "-pthread", "-ffp-contract=off",
        "-DNODE_SWEEP_HOST_EMULATION", *defines,
        f"-I{tmp}", f"-I{CSRC}", "-o", str(tmp / f"lib{stem}.so"), str(src),
    ]
    return tmp / f"lib{stem}.so", subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _load(stem, path, proc, declare):
    _, err = proc.communicate()
    assert proc.returncode == 0, f"g++ failed on {stem}.cu:\n{err}"
    lib = ctypes.CDLL(str(path))
    declare(lib)
    return lib


def _stub_dir(tmp_path_factory, name):
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel sources for the host")
    tmp = tmp_path_factory.mktemp(name)
    (tmp / "cuda_runtime.h").write_text(STUB)
    return tmp


@pytest.fixture(scope="module", params=list(BUILDS))
def libs(request, tmp_path_factory):
    """{source stem: ctypes library} of the two node-sweep sources built with
    g++ (both compiles started together)."""
    tmp = _stub_dir(tmp_path_factory, "node_sweep_host")
    defines = ["-DNODE_SWEEP_TJ=1", "-DNODE_SWEEP_TI=1", *BUILDS[request.param]]
    started = {stem: _build(tmp, stem, defines) for stem in ("node_sweep", "node_sweep_image")}
    return {stem: _load(stem, path, proc, node_kernel.declare) for stem, (path, proc) in started.items()}


@pytest.fixture(scope="module")
def slots_lib(tmp_path_factory):
    """csrc/tile_slots.cu built with g++, one row a warp."""
    tmp = _stub_dir(tmp_path_factory, "tile_slots_host")
    return _load("tile_slots", *_build(tmp, "tile_slots", ["-DTILE_NODES_ROWS=1"]), slot_kernel._declare)


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


def _mapped_inputs(refinements, rows, map_degree, order, fe_degree=1):
    """(xi, Yj, Nj, Wj) of create_sphere(refinements) with a Q`map_degree`
    map snapped to the sphere and Q`fe_degree` unknowns at quadrature
    `order`, f64, cut to `rows` rows: the shapes of the higher-order element
    configurations (m = vmax x nq samples per column node)."""
    from bemstokes_tpu_torch.mesh.refine import SphericalManifold

    mesh = create_sphere(refinements=refinements)
    fe, mp = build_scalar_space(mesh, fe_degree), build_scalar_space(mesh, map_degree)
    tables = build_assembly_tables(fe, mp, AssemblyConfig(dtype=torch.float64, quad_order=order))
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, mp, manifold=SphericalManifold()), dtype=torch.float64)
    xi, Yj, Nj, Wj = node_sweep_inputs(euler, support_points(euler, mp, fe), tables)
    return xi[:rows].contiguous(), Yj, Nj, Wj


#: (refinements, rows, map degree, quadrature order, unknowns' degree, m):
#: K1 at the higher-order configurations' samples per column node: Q4 map at
#: order 6 (144 = 9 passes of 16), Q3 map at order 5 (100: a last pass of 4),
#: Q0 unknowns (16: one panel a node), Q2 unknowns (64, 44 % zero weights)
HIGH_ORDER = [(2, 13, 4, 6, 1, 144), (2, 17, 3, 5, 1, 100), (2, 29, 1, 4, 0, 16), (1, 45, 2, 4, 2, 64)]


@pytest.mark.parametrize("refinements,rows,map_degree,order,fe_degree,m", HIGH_ORDER)
def test_k1_matches_plain_version_at_higher_order_shapes(libs, refinements, rows, map_degree, order, fe_degree, m):
    args = _mapped_inputs(refinements, rows, map_degree, order, fe_degree)
    assert args[1].shape[1] == m
    V, K = _call(libs["node_sweep"].node_sweep_f64, *args, False)
    Vr, Kr = node_kernel.node_sweep_reference(*args)
    assert _rel(V, Vr) <= TOL and _rel(K, Kr) <= TOL
    if map_degree == 4:
        kind, wall = 2, -2.0  # K3 at m = 144 too, the no-slip wall at y = -2
        V, K = _call(libs["node_sweep_image"].node_sweep_image_f64, *args, False, kind, 1, wall)
        Vr, Kr = node_kernel.node_sweep_reference(*args, kernel="no_slip", wall_axis=1, wall_position=wall)
        assert _rel(V, Vr) <= TOL and _rel(K, Kr) <= TOL


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



def _node_inputs(refinements, degree, rows, size=slot_kernel.NODE_GROUP_SIZE, order=4):
    """(xi, xq, nrm, wphi, row_ids, groups) of the gather assembly on
    create_sphere(refinements) with Q`degree` panels, f64, nodes in groups
    of `size`: `rows` rows, each the support point of its node (so every
    row lies on its own panels), taken in a shuffled order.  The map is the
    panels' space, Q1 under Q0 panels."""
    mesh = create_sphere(refinements=refinements)
    space = build_scalar_space(mesh, degree)
    mp = space if degree else build_scalar_space(mesh, 1)
    tables = build_assembly_tables(
        space, mp, AssemblyConfig(dtype=torch.float64, column_mode="gather", quad_order=order)
    )
    euler = torch.as_tensor(euler_from_mesh(mesh.vertices, mp), dtype=torch.float64)
    sp = support_points(euler, mp, space)
    ids = torch.randperm(tables.n_nodes, generator=torch.Generator().manual_seed(rows))[:rows]
    groups = slot_kernel.build_node_groups(
        tables.cells_nodes_fe, tables.n_nodes, tables.inc_slot, tables.inc_mask, size
    )
    return (sp[ids].contiguous(), *slot_inputs(euler, tables), ids, groups)


def _call_nodes(fn, xi, xq, nrm, wphi, ids, groups):
    nt, (nc, nq, nl) = xi.shape[0], wphi.shape
    V = torch.full((groups.n_nodes, 9, nt), float("nan"), dtype=torch.float64)
    K = torch.full_like(V, float("nan"))
    ids32 = ids.to(torch.int32)
    tables = [torch.as_tensor(a, dtype=torch.int32).contiguous() for a in (
        groups.cells_fe, groups.node_ptr, groups.nodes, groups.round_ptr, groups.round_panel, groups.round_place)]
    rc = fn(xi.data_ptr(), xq.data_ptr(), nrm.data_ptr(), wphi.data_ptr(), ids32.data_ptr(),
            *(t.data_ptr() for t in tables), V.data_ptr(), K.data_ptr(), nt, nc, nq, nl,
            groups.n_groups, groups.group_max, groups.round_max, None)
    assert rc == 0
    return V, K


@pytest.mark.parametrize(
    "refinements,degree,rows,size", [(1, 1, 26, 8), (1, 2, 61, 16), (2, 1, 37, 32), (2, 2, 101, 32), (1, 4, 53, 32)]
)
def test_tile_nodes_matches_plain_version(slots_lib, refinements, degree, rows, size):
    args = _node_inputs(refinements, degree, rows, size)
    V, K = _call_nodes(slots_lib.tile_nodes_f64, *args)
    Vr, Kr = slot_kernel.tile_nodes_reference(*args)
    assert args[-1].round_panel.shape[1] > 1 and args[-1].n_groups > 1
    assert _rel(V, Vr) <= TOL and _rel(K, Kr) <= TOL
    V2, K2 = _call_nodes(slots_lib.tile_nodes_f64, *args)
    assert torch.equal(V, V2) and torch.equal(K, K2)


@pytest.mark.parametrize("degree,order,nl,nq", [(0, 4, 1, 16), (1, 6, 4, 36), (2, 6, 9, 36)])
def test_tile_nodes_matches_plain_version_at_higher_order_shapes(slots_lib, degree, order, nl, nq):
    """Q0 panels (nl = 1: `LB = 4, EXACT = false`, a pass of one local node),
    and 36 panel points (quadrature order 6) with Q1 and Q2 panels, whose
    shared memory a block grows with nq and nl (`node_smem`)."""
    args = _node_inputs(2, degree, 17, order=order)
    assert args[3].shape[1:] == (nq, nl)
    V, K = _call_nodes(slots_lib.tile_nodes_f64, *args)
    Vr, Kr = slot_kernel.tile_nodes_reference(*args)
    assert _rel(V, Vr) <= TOL and _rel(K, Kr) <= TOL


def test_tile_nodes_round_width_is_the_source_warps():
    """A round of the host's schedule holds as many panels as the kernel's
    block has warps (csrc/tile_slots.cu NODE_WARPS)."""
    text = (CSRC / "tile_slots.cu").read_text()
    warps = int(re.search(r"constexpr int NODE_WARPS = (\d+);", text).group(1))
    groups = _node_inputs(1, 1, 5)[-1]
    assert warps == slot_kernel.NODE_GROUP_WARPS == groups.round_panel.shape[1]
    assert groups.round_place.shape[1:] == (warps, 4)
