// K5: the assembly-fused sweep-matvec, for Hopper (sm_90a): the actions
// (V @ XV, K @ XK) of the smooth-rule single-layer and double-layer
// collocation operators on batches of vectors, computed inside the pairwise
// node sweep so that neither operator is ever formed.
//
// Replaces the Pallas TPU kernel bemstokes_tpu/ops/matfree_node.py:195
// `_matvec_kernel` (`pallas_node_matvec`, `pallas_call` at :437) for all
// three of its `kernel` values.  The plain torch version is
// `sweep_matvec_reference` in bemstokes_tpu_torch/ops/matfree_node.py.
//
// What it computes.  With the rows, samples and Green's functions of K1, K2
// and K3 (node_sweep.cu, node_sweep_image.cu: p = Y[j, s] - xi[i], its
// mirror pI, h0, the dummy offset p = pI = (1, 1, 1), h0 = 0 on an exact
// r^2 = 0 pair) and x_b(j) = X[b n + j, :] the column node's value:
//
//   OV[a nr + i, :] =  sum_j sum_s W sum_b G_ab(p, pI) xv_b(j)
//   OK[a nr + i, :] = -sum_j sum_s W sum_b (W.n)_ab(p, pI) xk_b(j)
//
// Every term of G and W.n is a dyad u_a v_b or a multiple of delta_ab, so the
// sum over b folds into a few dots per sample (p.x, pI.x, N.x):
//   free space:    G x   = g0 (p.x) p + d0 x,   (W.n) x = k0 (p.x) p;
//   free surface:  adds s_a times the same in pI (s_a = -1 on the wall-normal
//                  row a = w);
//   no slip:       G0(p) x - G0(pI) x + t_a (beta D x + 2 h0 SD x),
//                  D x = -3 (pI.x) pI / rI^5 + x / rI^3,
//                  (SD x)_a = (delta_aw (pI.x) - pI_a x_w) / rI^3,
//                  (W.n) x as in node_sweep_image.cu with
//                  (Tn x)_a = 5 (pI.N)(pI.x) pI_a / rI^7
//                             - (N_a (pI.x) + pI_a^2 N_a x_a) / rI^5,
//                  (Un x)_a = (pI_a pI_w (N.x) - delta_aw (pI.N)(pI.x)) / rI^5.
//
// What bounds it.  Arithmetic alone.  It reads 7 n m + 3 nr + 3 n (BV + BK)
// values and writes 3 nr (BV + BK): a few MB at 24,578 nodes, against
// nr n m = 3.9e10 interactions of 52 (free space), 102 (free surface) or
// 175 (no slip) operations each for one column of V and one of K (a
// multiply-add counted as two, an rsqrt as one).
//
// What the design does about it.
// - One thread owns one row and keeps its 3 (BV + BK) sums in registers for
//   the whole sweep.  Rows alone are too few threads for 132 SMs (24,578 at
//   the largest shape the callers use, 6,146 at the usual one), so the column
//   nodes are split over gridDim.y and every block writes a partial sum.
// - The partial sums are added by a second kernel in the fixed order of the
//   splits, and the number of splits depends on the shapes and the card's SM
//   count only: the result is the same bits from run to run (an atomicAdd in
//   arrival order is not, and GMRES iteration counts would wander with it).
// - A block stages CT column nodes x SS samples (8 values each, 16-byte
//   aligned, so a thread reads a sample with vector loads that all its warp
//   shares) and the nodes' x values in shared memory; a thread reads a node's
//   x once per node, not once per sample.
// - The batch width of a launch is a template parameter: (1, 1), the GMRES
//   matvec, and (BW, BW) for wider batches, which the launcher walks in
//   chunks of BW columns (nv, nk <= BW are the columns a chunk really has),
//   so any BV, BK >= 0 is served and the per-sample scalars are shared by a
//   chunk's columns.  wall_axis is a template parameter, wall_position an
//   argument.  Every inverse power comes from one rsqrt per distance.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous and of
// one type T (float or double):
//   xi [nr, 3], Y [n, m, 3], N [n, m, 3], W [n, m], XV [3 n, BV],
//   XK [3 n, BK]; OV [3 nr, BV], OK [3 nr, BK] (out);
//   part: scratch of sweep_matvec_part_elems(nr, n, BV, BK) values;
//   kind 0 = free space, 1 = free surface, 2 = no slip; wall_axis 0, 1, 2.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown kind or axis).

#include "node_sweep_common.cuh"

namespace {

using namespace node_sweep;

constexpr int FREE_SPACE = 0;
constexpr int FREE_SURFACE = 1;
constexpr int NO_SLIP = 2;
constexpr double PI = 3.14159265358979323846;

constexpr int ROWS = 128;     // threads of a block = rows of a block
constexpr int CT = 4;         // column nodes staged per pass
constexpr int SS = 32;        // samples of each staged per pass
constexpr int BW = 4;         // widest batch chunk of one launch
constexpr int MIN_COLS = 32;  // fewest column nodes worth a split
constexpr int BLOCKS_PER_SM = 32;  // blocks aimed at, per SM

template <typename T>
struct alignas(16) Sample {
  T y[3];
  T n[3];
  T w;
  T pad;
};

// The sums of one row: BV columns of V, BK columns of K, 3 components each.
template <typename T, int BV, int BK>
struct Sums {
  T v[BV][3];
  T k[BK][3];
};

template <typename T>
__device__ __forceinline__ T dot3(const T (&a)[3], const T (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// One sample added into a row's sums.  x is the row's point, xw_img the
// wall-normal coordinate of its mirror image, h0 its height above the wall;
// xv, xk the column node's values (nv, nk of them are real).
template <typename T, int KIND, int WA, int BV, int BK>
__device__ __forceinline__ void add_sample(Sums<T, BV, BK>& acc, const T (&x)[3],
                                           T xw_img, T h0, const Sample<T>& q,
                                           const T (&xv)[BV][3],
                                           const T (&xk)[BK][3], int nv, int nk) {
  const T cG = static_cast<T>(1.0 / (8.0 * PI));
  const T cW = static_cast<T>(-3.0 / (4.0 * PI));
  const T cWn = static_cast<T>(3.0 / (4.0 * PI));
  const T w = q.w;
  const T nrm[3] = {q.n[0], q.n[1], q.n[2]};
  T p[3] = {q.y[0] - x[0], q.y[1] - x[1], q.y[2] - x[2]};
  T r2 = dot3_rn(p[0], p[1], p[2], p[0], p[1], p[2]);
  T pI[3] = {p[0], p[1], p[2]};
  T rI2 = r2;
  T h = h0;
  if constexpr (KIND != FREE_SPACE) {
    pI[WA] = q.y[WA] - xw_img;
    rI2 = dot3_rn(pI[0], pI[1], pI[2], pI[0], pI[1], pI[2]);
  }
  if (r2 == T(0)) {
    p[0] = p[1] = p[2] = T(1);
    pI[0] = pI[1] = pI[2] = T(1);
    r2 = rI2 = T(3);
    h = T(0);
  }
  const T iR = rsqrt_t(r2), iR2 = iR * iR;
  const T pn = dot3_rn(p[0], p[1], p[2], nrm[0], nrm[1], nrm[2]);
  const T wiR = w * iR;
  const T d0 = cG * wiR;                              // x_a of G0(p) x
  const T g0 = d0 * iR2;                              // (p.x) p_a of G0(p) x
  const T k0 = ((cW * pn) * iR2) * (wiR * iR2);       // (p.x) p_a of Wn0(p) x

  if constexpr (KIND == FREE_SPACE) {
#pragma unroll
    for (int b = 0; b < BV; ++b) {
      if (b < nv) {
        const T t = g0 * dot3(p, xv[b]);
#pragma unroll
        for (int a = 0; a < 3; ++a) acc.v[b][a] += t * p[a] + d0 * xv[b][a];
      }
    }
#pragma unroll
    for (int b = 0; b < BK; ++b) {
      if (b < nk) {
        const T t = k0 * dot3(p, xk[b]);
#pragma unroll
        for (int a = 0; a < 3; ++a) acc.k[b][a] += t * p[a];
      }
    }
    return;
  }

  const T iI = rsqrt_t(rI2), iI2 = iI * iI;
  const T pIn = dot3_rn(pI[0], pI[1], pI[2], nrm[0], nrm[1], nrm[2]);
  const T wiI = w * iI;
  const T dI = cG * wiI;
  const T gI = dI * iI2;

  if constexpr (KIND == FREE_SURFACE) {
    const T kI = ((cW * pIn) * iI2) * (wiI * iI2);
#pragma unroll
    for (int b = 0; b < BV; ++b) {
      if (b < nv) {
        const T t = g0 * dot3(p, xv[b]);
        const T tI = gI * dot3(pI, xv[b]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T img = tI * pI[a] + dI * xv[b][a];
          acc.v[b][a] += t * p[a] + d0 * xv[b][a] + (a == WA ? -img : img);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < BK; ++b) {
      if (b < nk) {
        const T t = k0 * dot3(p, xk[b]);
        const T tI = kI * dot3(pI, xk[b]);
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const T img = tI * pI[a];
          acc.k[b][a] += t * p[a] + (a == WA ? -img : img);
        }
      }
    }
    return;
  }

  if constexpr (KIND == NO_SLIP) {
    const T iI3 = iI * iI2, iI5 = iI3 * iI2;
    const T pIw = pI[WA];
    const T twoh = T(2) * h;
    const T beta = twoh * (pIw - h);
    if (nv > 0) {
      const T wg = cG * w;
      const T bD5 = T(-3) * (wg * beta) * iI5;  // beta D: (pI.x) pI_a
      const T bD3 = (wg * beta) * iI3;          // beta D: x_a
      const T cS = (wg * twoh) * iI3;           // 2 h0 SD
#pragma unroll
      for (int b = 0; b < BV; ++b) {
        if (b < nv) {
          const T pxI = dot3(pI, xv[b]);
          const T t = g0 * dot3(p, xv[b]);
          const T tI = gI * pxI;
          const T cb = bD5 * pxI;
          const T sxw = cS * xv[b][WA];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            T corr = (cb - sxw) * pI[a] + bD3 * xv[b][a];
            if (a == WA) corr += cS * pxI;
            const T base = t * p[a] + d0 * xv[b][a] - (tI * pI[a] + dI * xv[b][a]);
            acc.v[b][a] += base + (a == WA ? corr : -corr);
          }
        }
      }
    }
    if (nk > 0) {
      const T c0 = cWn * w;
      const T e5 = c0 * iI5;
      const T kI = e5 * pIn;               // Wn0(pI) x: (pI.x) pI_a
      const T bT = e5 * beta;              // beta / rI^5
      const T bT7 = T(5) * (bT * iI2) * pIn;  // 5 beta (pI.N) / rI^7
      const T bU = e5 * twoh;              // 2 h0 / rI^5
#pragma unroll
      for (int b = 0; b < BK; ++b) {
        if (b < nk) {
          const T pxI = dot3(pI, xk[b]);
          const T nx = dot3(nrm, xk[b]);
          const T t = k0 * dot3(p, xk[b]);
          // the coefficient of pI_a: the image stresslet less s_a times the
          // leading terms of beta Tn and 2 h0 Un
          const T lead = bT7 * pxI + (bU * nx) * pIw;
          const T tn = bT * pxI;
          const T un = (bU * pIn) * pxI;
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            // s_a (beta Tn + 2 h0 Un)_a
            T img = lead * pI[a] - tn * nrm[a] - (bT * pI[a]) * (pI[a] * nrm[a]) * xk[b][a];
            if (a == WA) img -= un;
            acc.k[b][a] += t * p[a] + (kI * pxI) * pI[a] + (a == WA ? img : -img);
          }
        }
      }
    }
  }
}

// part[split][a][i][BV + BK]: the sums of the block's column nodes.
template <typename T, int KIND, int WA, int BV, int BK>
__global__ void __launch_bounds__(ROWS)
    sweep_matvec_kernel(const T* __restrict__ xi, const T* __restrict__ Y,
                        const T* __restrict__ N, const T* __restrict__ W,
                        const T* __restrict__ XV, const T* __restrict__ XK,
                        T* __restrict__ part, int64_t nr, int64_t n, int64_t m,
                        int64_t ldv, int64_t v0, int nv, int64_t ldk, int64_t k0,
                        int nk, int64_t cols_per_split, T wall_position) {
  __shared__ Sample<T> tile[CT][SS];
  __shared__ T sxv[CT][BV][3];
  __shared__ T sxk[CT][BK][3];

  const int tid = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * ROWS + tid;
  const int64_t jlo = static_cast<int64_t>(blockIdx.y) * cols_per_split;
  const int64_t jhi = jlo + cols_per_split < n ? jlo + cols_per_split : n;

  T x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = i < nr ? xi[i * 3 + c] : T(0);
  const T h0 = x[WA] - wall_position;
  // the mirrored row point, rounded as kernels/images.py image_point does
  const T xw_img = x[WA] - T(2) * h0;

  Sums<T, BV, BK> acc;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < BV; ++b) acc.v[b][a] = T(0);
#pragma unroll
    for (int b = 0; b < BK; ++b) acc.k[b][a] = T(0);
  }

  for (int64_t j0 = jlo; j0 < jhi; j0 += CT) {
    const int cn = static_cast<int>(jhi - j0 < CT ? jhi - j0 : CT);
    for (int64_t s0 = 0; s0 < m; s0 += SS) {
      const int sn = static_cast<int>(m - s0 < SS ? m - s0 : SS);
      __syncthreads();
      for (int t = tid; t < CT * SS; t += ROWS) {
        const int c = t / SS;
        const int s = t % SS;
        if (c < cn && s < sn) {
          const int64_t g = (j0 + c) * m + s0 + s;
          Sample<T>& q = tile[c][s];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            q.y[a] = Y[g * 3 + a];
            q.n[a] = N[g * 3 + a];
          }
          q.w = W[g];
        }
      }
      if (s0 == 0) {
        for (int t = tid; t < CT * BV * 3; t += ROWS) {
          const int c = t / (BV * 3), b = (t / 3) % BV, a = t % 3;
          sxv[c][b][a] =
              c < cn && b < nv ? XV[(a * n + j0 + c) * ldv + v0 + b] : T(0);
        }
        for (int t = tid; t < CT * BK * 3; t += ROWS) {
          const int c = t / (BK * 3), b = (t / 3) % BK, a = t % 3;
          sxk[c][b][a] =
              c < cn && b < nk ? XK[(a * n + j0 + c) * ldk + k0 + b] : T(0);
        }
      }
      __syncthreads();

      for (int c = 0; c < cn; ++c) {
        T xv[BV][3], xk[BK][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < BV; ++b) xv[b][a] = sxv[c][b][a];
#pragma unroll
          for (int b = 0; b < BK; ++b) xk[b][a] = sxk[c][b][a];
        }
        for (int s = 0; s < sn; ++s) {
          add_sample<T, KIND, WA, BV, BK>(acc, x, xw_img, h0, tile[c][s], xv, xk,
                                          nv, nk);
        }
      }
    }
  }

  if (i >= nr) return;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T* out = part + ((static_cast<int64_t>(blockIdx.y) * 3 + a) * nr + i) * (BV + BK);
#pragma unroll
    for (int b = 0; b < BV; ++b) out[b] = acc.v[b][a];
#pragma unroll
    for (int b = 0; b < BK; ++b) out[BV + b] = acc.k[b][a];
  }
}

// The splits' partial sums added in the order of the splits; K negated
// (exterior problem, reference `:2941-2947`).  bv, bk are the widths of the
// launch that wrote `part`, nv, nk the columns it really has.
template <typename T>
__global__ void reduce_splits_kernel(const T* __restrict__ part,
                                     T* __restrict__ OV, T* __restrict__ OK,
                                     int64_t rows, int64_t splits, int bv,
                                     int bk, int64_t ldv, int64_t v0, int nv,
                                     int64_t ldk, int64_t k0, int nk) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int width = bv + bk;
  if (idx >= rows * width) return;
  const int64_t row = idx / width;  // a nr + i
  const int b = static_cast<int>(idx % width);
  const bool is_v = b < bv;
  if (is_v ? b >= nv : b - bv >= nk) return;
  T sum = T(0);
  for (int64_t s = 0; s < splits; ++s) sum += part[(s * rows + row) * width + b];
  if (is_v) {
    OV[row * ldv + v0 + b] = sum;
  } else {
    OK[row * ldk + k0 + (b - bv)] = -sum;
  }
}

struct Args {
  const void *xi, *Y, *N, *W, *XV, *XK;
  void *OV, *OK, *part;
  int64_t nr, n, m, BV, BK;
  int64_t splits;  // of the column nodes: splits_for(nr, n)
  double wall_position;
  cudaStream_t stream;
};

template <typename T, int KIND, int WA, int BV, int BK>
int launch_chunk(const Args& g, int64_t v0, int nv, int64_t k0, int nk) {
  const int64_t cols_per_split = (g.n + g.splits - 1) / g.splits;
  const dim3 grid(static_cast<unsigned>((g.nr + ROWS - 1) / ROWS),
                  static_cast<unsigned>(g.splits));
  sweep_matvec_kernel<T, KIND, WA, BV, BK><<<grid, ROWS, 0, g.stream>>>(
      static_cast<const T*>(g.xi), static_cast<const T*>(g.Y),
      static_cast<const T*>(g.N), static_cast<const T*>(g.W),
      static_cast<const T*>(g.XV), static_cast<const T*>(g.XK),
      static_cast<T*>(g.part), g.nr, g.n, g.m, g.BV, v0, nv, g.BK, k0, nk,
      cols_per_split, static_cast<T>(g.wall_position));
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int64_t rows = 3 * g.nr;
  const int64_t total = rows * (BV + BK);
  reduce_splits_kernel<T><<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                            g.stream>>>(
      static_cast<const T*>(g.part), static_cast<T*>(g.OV),
      static_cast<T*>(g.OK), rows, g.splits, BV, BK, g.BV, v0, nv, g.BK, k0, nk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND, int WA>
int launch_batches(const Args& g) {
  if (g.BV == 1 && g.BK == 1) return launch_chunk<T, KIND, WA, 1, 1>(g, 0, 1, 0, 1);
  for (int64_t c0 = 0; c0 < g.BV || c0 < g.BK; c0 += BW) {
    const int64_t lv = g.BV - c0, lk = g.BK - c0;
    const int nv = static_cast<int>(lv < 0 ? 0 : lv < BW ? lv : BW);
    const int nk = static_cast<int>(lk < 0 ? 0 : lk < BW ? lk : BW);
    const int rc = launch_chunk<T, KIND, WA, BW, BW>(g, c0, nv, c0, nk);
    if (rc != 0) return rc;
  }
  return 0;
}

template <typename T, int KIND>
int launch_axis(const Args& g, int wall_axis) {
  switch (wall_axis) {
    case 0:
      return launch_batches<T, KIND, 0>(g);
    case 1:
      return launch_batches<T, KIND, 1>(g);
    case 2:
      return launch_batches<T, KIND, 2>(g);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int64_t splits_for(int64_t nr, int64_t n) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      sms <= 0) {
    sms = 132;
  }
  const int64_t row_blocks = (nr + ROWS - 1) / ROWS;
  int64_t splits = (static_cast<int64_t>(sms) * BLOCKS_PER_SM + row_blocks - 1) /
                   (row_blocks > 0 ? row_blocks : 1);
  const int64_t most = (n + MIN_COLS - 1) / MIN_COLS;
  if (splits > most) splits = most;
  if (splits > 65535) splits = 65535;
  return splits < 1 ? 1 : splits;
}

template <typename T>
int launch(const Args& g, int kind, int wall_axis) {
  if (g.nr <= 0 || g.n <= 0 || (g.BV <= 0 && g.BK <= 0))
    return static_cast<int>(cudaGetLastError());
  // the free-space kernel never reads the wall: one instance serves it
  if (kind == FREE_SPACE) return launch_batches<T, FREE_SPACE, 0>(g);
  if (kind == FREE_SURFACE) return launch_axis<T, FREE_SURFACE>(g, wall_axis);
  if (kind == NO_SLIP) return launch_axis<T, NO_SLIP>(g, wall_axis);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// The values of scratch a sweep needs: its partial sums, one set per split
// of the column nodes (a function of the shapes and the current device's SM
// count alone).
int64_t sweep_matvec_part_elems(int64_t nr, int64_t n, int64_t BV, int64_t BK) {
  const int64_t width = (BV == 1 && BK == 1) ? 2 : 2 * BW;
  return splits_for(nr, n) * 3 * nr * width;
}

int sweep_matvec_f32(const void* xi, const void* Y, const void* N,
                     const void* W, const void* XV, const void* XK, void* OV,
                     void* OK, void* part, int64_t nr, int64_t n, int64_t m,
                     int64_t BV, int64_t BK, int kind, int wall_axis,
                     double wall_position, void* stream) {
  const Args g{xi, Y,  N, W,  XV, XK,  OV, OK, part,
               nr, n,  m, BV, BK, splits_for(nr, n), wall_position,
               static_cast<cudaStream_t>(stream)};
  return launch<float>(g, kind, wall_axis);
}

int sweep_matvec_f64(const void* xi, const void* Y, const void* N,
                     const void* W, const void* XV, const void* XK, void* OV,
                     void* OK, void* part, int64_t nr, int64_t n, int64_t m,
                     int64_t BV, int64_t BK, int kind, int wall_axis,
                     double wall_position, void* stream) {
  const Args g{xi, Y,  N, W,  XV, XK,  OV, OK, part,
               nr, n,  m, BV, BK, splits_for(nr, n), wall_position,
               static_cast<cudaStream_t>(stream)};
  return launch<double>(g, kind, wall_axis);
}

}  // extern "C"
