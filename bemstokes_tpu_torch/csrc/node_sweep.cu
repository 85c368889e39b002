// K1 and K4: the free-space node sweep of the dense single-layer (V) and
// double-layer (K) collocation operators, for Hopper (sm_90a).
//
// K1 replaces the Pallas TPU kernel bemstokes_tpu/ops/pallas_node.py:129
// `_node_kernel_t` with kernel="free_space" (launched through
// `pallas_node_blocks`, ops/assemble.py:725).  K4 replaces its rows-in-lanes
// twin bemstokes_tpu/ops/pallas_node.py:46 `_node_kernel`
// (`pallas_node_blocks(transposed=False)`): the same sums, written
// component-major as [9, n, nr] with the rows contiguous.  Their plain torch
// version is `node_sweep_reference` in
// bemstokes_tpu_torch/ops/node_kernel.py.
//
// What it computes.  For every collocation row i (point xi[i]) and column
// node j, over the m = vmax*nq quadrature samples s of the panels incident
// to j (points Y[j, s], unit normals N[j, s], weights W[j, s] = phi*JxW,
// zero on incidence padding), with R = Y[j, s] - xi[i] and r = |R|:
//
//   V_ab(i, j) =  sum_s W (delta_ab / r + R_a R_b / r^3) / (8 pi)
//   K_ab(i, j) = -sum_s W (-3 / (4 pi)) (R . N) R_a R_b / r^5
//
// An exact r^2 = 0 pair takes the dummy offset R = (1, 1, 1), r^2 = 3, as
// the TPU kernel does (pallas_node.py:213-217): the singular delta of the
// assembly subtracts the same dummy value, so the pair cancels exactly.
// V and K are written straight into the component-blocked dense layout
// [3 nr, 3 n], entry (a*nr + i, b*n + j) — no [9, R, C] intermediate.
// K4 (the `PLANES` instantiation) runs the same sample loop, so its sums
// have K1's bits, and stores plane 3a + b, column j, row i at
// ((3a + b) * n + j) * nr + i.  A thread's rows are not neighbours of its
// warp's (the warp walks columns), so a block passes three planes at a time
// through the shared memory of its sample tile and writes them with its
// threads walking rows: ROWS_PER_BLOCK consecutive rows a column.  Of the
// TPU kernel's layout nothing else is kept: no ones-matrix q-sum, no
// multiples of 128.
//
// What bounds it.  At the 6,146-node sphere (m = 64) one assembly is
// 6146^2 * 64 = 2.42e9 interactions against 2 * 9 * 6146^2 * 8 B = 5.4 GB of
// f64 stores (2.7 GB in f32), ~1.6 ms at the card's memory rate.  The
// arithmetic takes longer, and within it the FP64 pipe's issue rate: an SM
// issues 64 FP64 lanes a clock whether the instruction is a DFMA, a DMUL or
// a DADD (scripts/torch_sass_count.py --probe), so what the sweep costs is
// the number of FP64 instructions per interaction, not the operations they
// stand for.  Counted from the machine code by the same script (PERF.md):
// 57 before the redesign below, for 65 counted operations.
//
// What the design does about it.
// - The stores are written once and coalesced and the inputs are staged per
//   block in shared memory (the tiling of node_sweep_common.cuh, shared with
//   the image sweeps); each thread keeps its RT rows' 13 sums (6 of V, 6 of
//   K and the 1/r diagonal of V, both 3x3 blocks being symmetric) in
//   registers for the whole sample loop and reuses each staged sample for
//   its RT rows.
// - Few FP64 instructions per interaction (39 in the machine code, 38 FP32
//   in f32): r^2 is two FMAs and a product; the inverse powers come from one
//   `rsqrt_pos` (five FP64 instructions, no branch, no call); the weight
//   enters once, in w / r and w / r^3, and K's factor w (R.N) / r^5 is
//   (R.N / r^2) (w / r^3), so that each of the 12 sums of a row costs one FMA
//   on the dyad R_a R_b; the constants 1/8pi and 3/4pi (K's sign included)
//   are applied once per output, at the store.  R.N keeps its
//   round-to-nearest form (`dot3_rn`): it cancels on a column's own panels.
//   (Staging the normal times its weight, as K5 does, would cost one
//   instruction more here: K's factor would need r^-5 apart from w / r^3.)
// - The r^2 = 0 test is made once per group of samples on the integer pipe,
//   and the dummy offset lives in a second copy of the group's body behind a
//   branch that real meshes (Gauss points never sit on a node) never take.
//   The f32 loop takes two samples a trip (no remainder: samples past a
//   node's m are staged with weight zero); the f64 loop one, because two
//   take 152 registers a thread and the SM then holds one block of 256
//   threads instead of two, which costs more than the unrolling buys
//   (PERF.md).
// No tensor cores, TMA or wgmma: the body is pairwise transcendental
// arithmetic with no matrix product in it.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous and of
// one type T (float or double):
//   xi [nr, 3], Y [n, m, 3], N [n, m, 3], W [n, m]; V, K [3 nr, 3 n] (out;
//   `node_sweep_planes_*`: [9, n, nr]).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().

#include "node_sweep_common.cuh"

namespace {

using namespace node_sweep;

// The sums of one row: the upper triangles of V's dyad part and of K, and
// V's diagonal 1/r part.
template <typename T>
struct RowSums {
  T v[6], k[6], vd;
};

// One (row, sample) interaction added into the row's sums: R = y - xi, its
// squared length r2, the sample's unit normal n and weight w.  Without the
// constants: V's sums are those of w (delta_ab / r + R_a R_b / r^3), K's of
// w (R.N) R_a R_b / r^5.
template <typename T>
__device__ __forceinline__ void add_free_space(RowSums<T>& acc, const T (&R)[3], T r2,
                                               const T (&n)[3], T w) {
  const T iR = rsqrt_pos(r2), iR2 = iR * iR;
  const T wiR = w * iR;
  const T g = wiR * iR2;  // w / r^3
  acc.vd += wiR;
  const T t = (dot3_rn(R[0], R[1], R[2], n[0], n[1], n[2]) * iR2) * g;  // w (R.N) / r^5
  const T d[6] = {R[0] * R[0], R[0] * R[1], R[0] * R[2], R[1] * R[1], R[1] * R[2], R[2] * R[2]};
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    acc.v[q] = fma(g, d[q], acc.v[q]);
    acc.k[q] = fma(t, d[q], acc.k[q]);
  }
}

// Entry (a, b) of a row's V, scaled.
template <typename T>
__device__ __forceinline__ T v_entry(const RowSums<T>& acc, int a, int b, T cG) {
  const T vab = acc.v[ut(a, b)];
  return cG * (a == b ? vab + acc.vd : vab);
}

template <typename T, bool PLANES>
__global__ void __launch_bounds__(TJ* TI)
    node_sweep_kernel(const T* __restrict__ xi, const T* __restrict__ Y,
                      const T* __restrict__ N, const T* __restrict__ W,
                      T* __restrict__ V, T* __restrict__ K, int64_t nr,
                      int64_t n, int64_t m) {
  // samples a trip: one in f64 (two cost the SM its second block), two in f32
  constexpr int UNROLL = unroll<T>(1, 2);
  static_assert(SC % UNROLL == 0, "the sample loop has no remainder");
  __shared__ SampleTile<T> tile;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TJ + tx;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;

  T x[RT][3];
  RowSums<T> acc[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int64_t i = i0 + r * TI + ty;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[r][c] = i < nr ? xi[i * 3 + c] : T(0);
#pragma unroll
    for (int q = 0; q < 6; ++q) acc[r].v[q] = acc[r].k[q] = T(0);
    acc[r].vd = T(0);
  }

  for (int64_t s0 = 0; s0 < m; s0 += SC) {
    __syncthreads();
    stage(tile, Y, N, W, j0, s0, n, m, tid);
    __syncthreads();

    const int sn = static_cast<int>(m - s0 < SC ? m - s0 : SC);
    const int sn_whole = (sn + UNROLL - 1) / UNROLL * UNROLL;
#pragma unroll 1
    for (int s = 0; s < sn_whole; s += UNROLL) {
      // the group's pairs first: one test, and a branch that is next to
      // never taken, keeps the dummy offset's selects out of the loop
      T R[UNROLL][RT][3], r2[UNROLL][RT], nrm[UNROLL][3], w[UNROLL];
      bool any = false;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int c = 0; c < 3; ++c) nrm[u][c] = tile.N[c][s + u][tx];
        w[u] = tile.W[s + u][tx];
#pragma unroll
        for (int r = 0; r < RT; ++r) {
#pragma unroll
          for (int c = 0; c < 3; ++c) R[u][r][c] = tile.Y[c][s + u][tx] - x[r][c];
          const T(&q)[3] = R[u][r];
          r2[u][r] = fma(q[2], q[2], fma(q[1], q[1], q[0] * q[0]));
          any = any || is_zero(r2[u][r]);
        }
      }
      if (any) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            // an exact r^2 = 0 pair: the dummy offset R = (1, 1, 1)
            if (is_zero(r2[u][r])) {
              R[u][r][0] = R[u][r][1] = R[u][r][2] = T(1);
              r2[u][r] = T(3);
            }
            add_free_space(acc[r], R[u][r], r2[u][r], nrm[u], w[u]);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int r = 0; r < RT; ++r) add_free_space(acc[r], R[u][r], r2[u][r], nrm[u], w[u]);
        }
      }
    }
  }

  // the constants, once per output: 1/8pi for V, 3/4pi for K (the
  // stresslet's -3/4pi negated for the exterior problem, reference
  // `:2941-2947`)
  const T cG = static_cast<T>(1.0 / (8.0 * 3.14159265358979323846));
  const T cK = static_cast<T>(3.0 / (4.0 * 3.14159265358979323846));
  if constexpr (PLANES) {
    // K4: three planes (one row a of the 3x3 block) at a time, transposed
    // through the sample tile's shared memory
    static_assert(sizeof(SampleTile<T>) >=
                      3 * ROWS_PER_BLOCK * (TJ + 1) * sizeof(T),
                  "the sample tile must hold three staged planes");
    T(*out)[ROWS_PER_BLOCK][TJ + 1] =
        reinterpret_cast<T(*)[ROWS_PER_BLOCK][TJ + 1]>(&tile);
#pragma unroll
    for (int pass = 0; pass < 6; ++pass) {
      const int a = pass % 3;
      const bool is_k = pass >= 3;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < RT; ++r) {
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          out[b][r * TI + ty][tx] = is_k ? cK * acc[r].k[ut(a, b)] : v_entry(acc[r], a, b, cG);
        }
      }
      __syncthreads();
      T* __restrict__ dst = is_k ? K : V;
      for (int e = tid; e < 3 * TJ * ROWS_PER_BLOCK; e += TJ * TI) {
        const int lr = e % ROWS_PER_BLOCK;
        const int c = (e / ROWS_PER_BLOCK) % TJ;
        const int b = e / (ROWS_PER_BLOCK * TJ);
        const int64_t i = i0 + lr;
        const int64_t jc = j0 + c;
        if (i < nr && jc < n) dst[((3 * a + b) * n + jc) * nr + i] = out[b][lr][c];
      }
    }
    return;
  }

  const int64_t j = j0 + tx;
  if (j >= n) return;
  const int64_t ld = 3 * n;
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int64_t i = i0 + r * TI + ty;
    if (i >= nr) continue;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const int64_t off = (a * nr + i) * ld + b * n + j;
        V[off] = v_entry(acc[r], a, b, cG);
        K[off] = cK * acc[r].k[ut(a, b)];
      }
    }
  }
}

template <typename T, bool PLANES>
int launch(const T* xi, const T* Y, const T* N, const T* W, T* V, T* K,
           int64_t nr, int64_t n, int64_t m, void* stream) {
  if (nr <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(TJ, TI);
  const dim3 grid(static_cast<unsigned>((n + TJ - 1) / TJ),
                  static_cast<unsigned>((nr + ROWS_PER_BLOCK - 1) /
                                        ROWS_PER_BLOCK));
  node_sweep_kernel<T, PLANES>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      xi, Y, N, W, V, K, nr, n, m);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

#define NODE_SWEEP_ENTRY(name, T, PLANES)                                      \
  int name(const void* xi, const void* Y, const void* N, const void* W,        \
           void* V, void* K, int64_t nr, int64_t n, int64_t m, void* stream) { \
    return launch<T, PLANES>(                                                  \
        static_cast<const T*>(xi), static_cast<const T*>(Y),                   \
        static_cast<const T*>(N), static_cast<const T*>(W),                    \
        static_cast<T*>(V), static_cast<T*>(K), nr, n, m, stream);             \
  }

NODE_SWEEP_ENTRY(node_sweep_f32, float, false)
NODE_SWEEP_ENTRY(node_sweep_f64, double, false)
NODE_SWEEP_ENTRY(node_sweep_planes_f32, float, true)
NODE_SWEEP_ENTRY(node_sweep_planes_f64, double, true)

#undef NODE_SWEEP_ENTRY

}  // extern "C"
