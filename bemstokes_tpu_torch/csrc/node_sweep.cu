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
// multiples of 128, and 1/(8 pi) stays in the sums rather than in the
// weights (which would change K1's bits).
//
// What bounds it.  At the 6,146-node sphere (m = 64) one assembly is
// 6146^2 * 64 = 2.42e9 interactions of ~50 flops plus one rsqrt each,
// i.e. ~1.2e11 FP64 flops, against 2 * 9 * 6146^2 * 8 B = 5.4 GB of f64
// stores (2.7 GB in f32).  At the card's published FP64 and HBM rates the
// arithmetic takes a few ms and the stores ~1.6 ms, so the kernel is bound
// by FP64 arithmetic (and the rsqrt), not by memory.
//
// What the design does about it.  The stores are written once and
// coalesced and the inputs are staged per block in shared memory (the
// tiling of node_sweep_common.cuh, shared with the image sweeps);
// each thread keeps its RT rows' 13 accumulators (6 of V, 6 of K and the
// 1/r diagonal of V, exploiting the symmetry of both 3x3 blocks) in
// registers for the whole sample loop, and reuses each staged sample for
// its RT rows.  No tensor cores, TMA or wgmma: a later change can tile
// further once the card's numbers say where the time goes.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous and of
// one type T (float or double):
//   xi [nr, 3], Y [n, m, 3], N [n, m, 3], W [n, m]; V, K [3 nr, 3 n] (out;
//   `node_sweep_planes_*`: [9, n, nr]).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().

#include "node_sweep_common.cuh"

namespace {

using namespace node_sweep;

template <typename T, bool PLANES>
__global__ void __launch_bounds__(TJ* TI)
    node_sweep_kernel(const T* __restrict__ xi, const T* __restrict__ Y,
                      const T* __restrict__ N, const T* __restrict__ W,
                      T* __restrict__ V, T* __restrict__ K, int64_t nr,
                      int64_t n, int64_t m) {
  __shared__ SampleTile<T> tile;

  const T cG = static_cast<T>(1.0 / (8.0 * 3.14159265358979323846));
  const T cW = static_cast<T>(-3.0 / (4.0 * 3.14159265358979323846));

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TJ + tx;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;

  T x[RT][3];
  T v[RT][6], k[RT][6], vd[RT];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int64_t i = i0 + r * TI + ty;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[r][c] = i < nr ? xi[i * 3 + c] : T(0);
#pragma unroll
    for (int q = 0; q < 6; ++q) v[r][q] = k[r][q] = T(0);
    vd[r] = T(0);
  }

  for (int64_t s0 = 0; s0 < m; s0 += SC) {
    __syncthreads();
    stage(tile, Y, N, W, j0, s0, n, m, tid);
    __syncthreads();

    const int sn = static_cast<int>(m - s0 < SC ? m - s0 : SC);
    for (int s = 0; s < sn; ++s) {
      const T y0 = tile.Y[0][s][tx], y1 = tile.Y[1][s][tx], y2 = tile.Y[2][s][tx];
      const T n0 = tile.N[0][s][tx], n1 = tile.N[1][s][tx], n2 = tile.N[2][s][tx];
      const T w = tile.W[s][tx];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        T R0 = y0 - x[r][0];
        T R1 = y1 - x[r][1];
        T R2 = y2 - x[r][2];
        T r2 = dot3_rn(R0, R1, R2, R0, R1, R2);
        if (r2 == T(0)) {
          R0 = R1 = R2 = T(1);
          r2 = T(3);
        }
        const T invR = rsqrt_t(r2);
        const T invR2 = invR * invR;
        const T wiR = w * invR;
        const T wgs = cG * (wiR * invR2);
        vd[r] += cG * wiR;
        // K's terms follow the plain version's rounding step for step
        // (W.n = (cW R_a R_b) (R.N / r^5), r^-5 = r^-1 (r^-2)^2): on a
        // column's own panels they are large and cancel, so a different
        // association alone would show as a K difference there in f32
        const T t = dot3_rn(R0, R1, R2, n0, n1, n2) * (invR * (invR2 * invR2));
        const T d[6] = {R0 * R0, R0 * R1, R0 * R2, R1 * R1, R1 * R2, R2 * R2};
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          v[r][q] += wgs * d[q];
          k[r][q] += ((cW * d[q]) * t) * w;
        }
      }
    }
  }

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
          const T vab = v[r][ut(a, b)];
          out[b][r * TI + ty][tx] =
              is_k ? -k[r][ut(a, b)] : (a == b ? vab + vd[r] : vab);
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
        const T vab = v[r][ut(a, b)];
        V[off] = a == b ? vab + vd[r] : vab;
        // minus sign: exterior problem (reference `:2941-2947`)
        K[off] = -k[r][ut(a, b)];
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
