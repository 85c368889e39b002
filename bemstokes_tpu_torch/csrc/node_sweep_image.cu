// K2 and K3: the node sweep of the dense single-layer (V) and double-layer
// (K) collocation operators with the image system of a plane wall, for
// Hopper (sm_90a).  K2 is the free-surface (perfect slip) image, K3 the
// Blake no-slip image.
//
// Replace the Pallas TPU kernel bemstokes_tpu/ops/pallas_node.py:129
// `_node_kernel_t` with kernel="free_surface" (its `:252-258`, `:344-350`)
// and kernel="no_slip" (`:259-303`, `:351-383`).  The plain torch version is
// `node_sweep_reference(..., kernel=, wall_axis=, wall_position=)` in
// bemstokes_tpu_torch/ops/node_kernel.py, built on kernels/images.py.
//
// What they compute.  The wall is the plane x_w = wall_position, w =
// wall_axis.  For every collocation row i (point xi[i]) and column node j,
// over the m samples s of the panels incident to j (points Y, unit normals
// N, weights W, zero on incidence padding), with p = Y[j, s] - xi[i],
// pI = Y[j, s] - xi_image[i] (xi mirrored across the wall: only component w
// differs) and h0 = xi[i]_w - wall_position, the height of the row above
// the wall:
//
//   V_ab(i, j) =  sum_s W G_ab(p, pI),   K_ab(i, j) = -sum_s W (W.n)_ab(p, pI)
//
// free surface (s_a = -1 on the wall-normal row a = w, +1 elsewhere):
//   G  = G0(p) + s_a G0(pI),  W.n = Wn0(p) + s_a Wn0(pI),
//   G0(p)_ab = (delta_ab / r + p_a p_b / r^3) / (8 pi),
//   Wn0(p)_ab = -3 / (4 pi) (p . N) p_a p_b / r^5;
// no slip (t_a = -s_a, beta = 2 h0 (pI_w - h0), rI = |pI|):
//   8 pi G_ab = G0u(p) - G0u(pI) + t_a (beta D_ab + 2 h0 SD_ab),
//     D_ab = -3 pI_a pI_b / rI^5 + delta_ab / rI^3,
//     SD_ab = (delta_aw pI_b - delta_bw pI_a) / rI^3,
//   (4 pi / 3) (W.n)_ab = -p_a p_b (p.N) / r^5 + pI_a pI_b (pI.N) / rI^5
//                         - s_a (beta Tn_ab + 2 h0 Un_ab),
//     Tn_ab = -(N_a pI_b + delta_ab pI_a^2 N_a) / rI^5
//             + 5 pI_a pI_b (pI.N) / rI^7,
//     Un_ab = (N_b pI_a pI_w - delta_aw pI_b (pI.N)) / rI^5.
// Neither block is symmetric: the row signs and the SD, Tn, Un terms break
// the symmetry of the dyads.
//
// An exact r^2 = 0 pair takes the dummy offset p = pI = (1, 1, 1), as the
// TPU kernel does (pallas_node.py:213-217, :242-246), so h0 reads 0 on such
// a pair; the singular delta of the assembly subtracts the same dummy value
// and the pair cancels exactly.
//
// What bounds them.  Arithmetic, as K1: the stores are the same
// 2 * 9 * nr * n entries, while each interaction costs two rsqrt and about
// 2.3 (K2) or 4 (K3) times K1's multiply-adds.
//
// What the design does about it.  The TPU kernel keeps one sum per term
// (about 66 per entry for the no-slip kernel) because it combines them only
// after its matrix-unit reduction.  Here a thread owns its (row, column)
// entries and h0 is a per-row scalar in a register, so it forms the full
// 3x3 G and W.n of a sample (the symmetric dyads p_a p_b and pI_a pI_b are
// formed once, 6 products each) and adds them into 9 + 9 sums per row: 36
// accumulators for its RT = 2 rows.  wall_axis is a template parameter, so
// the row signs and the delta_aw terms are resolved at compile time.  Tiling,
// staging and stores are those of node_sweep_common.cuh.  No division: every
// inverse power comes from one rsqrt per distance.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous and of
// one type T (float or double):
//   xi [nr, 3], Y [n, m, 3], N [n, m, 3], W [n, m]; V, K [3 nr, 3 n] (out);
//   kind 1 = free surface, 2 = no slip; wall_axis 0, 1 or 2.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown kind or axis).

#include "node_sweep_common.cuh"

namespace {

using namespace node_sweep;

constexpr int FREE_SURFACE = 1;
constexpr int NO_SLIP = 2;
constexpr double PI = 3.14159265358979323846;

// One sample of the free-surface kernel added into a row's 9 + 9 sums.
template <typename T, int WA>
__device__ __forceinline__ void add_free_surface(T (&v)[9], T (&k)[9],
                                                 const T (&p)[3], T r2,
                                                 const T (&pI)[3], T rI2,
                                                 const T (&nrm)[3], T w) {
  const T cG = static_cast<T>(1.0 / (8.0 * PI));
  const T cW = static_cast<T>(-3.0 / (4.0 * PI));
  const T iR = rsqrt_t(r2), iR2 = iR * iR;
  const T iI = rsqrt_t(rI2), iI2 = iI * iI;
  const T wiR = w * iR, wiI = w * iI;
  const T g0 = cG * (wiR * iR2), gI = cG * (wiI * iI2);
  const T d0 = cG * wiR, dI_ = cG * wiI;
  // (p . N) / r^5 rounded as the plain version rounds it (see K1)
  const T t0 = dot3_rn(p[0], p[1], p[2], nrm[0], nrm[1], nrm[2]) * (iR * (iR2 * iR2));
  const T tI = dot3_rn(pI[0], pI[1], pI[2], nrm[0], nrm[1], nrm[2]) * (iI * (iI2 * iI2));
  const T d[6] = {p[0] * p[0], p[0] * p[1], p[0] * p[2],
                  p[1] * p[1], p[1] * p[2], p[2] * p[2]};
  const T dI[6] = {pI[0] * pI[0], pI[0] * pI[1], pI[0] * pI[2],
                   pI[1] * pI[1], pI[1] * pI[2], pI[2] * pI[2]};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T sa = a == WA ? T(-1) : T(1);
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int q = ut(a, b);
      T g = g0 * d[q] + sa * (gI * dI[q]);
      if (a == b) g += d0 + sa * dI_;
      v[3 * a + b] += g;
      k[3 * a + b] += (((cW * d[q]) * t0) + sa * ((cW * dI[q]) * tI)) * w;
    }
  }
}

// One sample of the Blake no-slip kernel added into a row's 9 + 9 sums; h is
// the row's height above the wall (0 on a dummy pair).
template <typename T, int WA>
__device__ __forceinline__ void add_no_slip(T (&v)[9], T (&k)[9],
                                            const T (&p)[3], T r2,
                                            const T (&pI)[3], T rI2,
                                            const T (&nrm)[3], T w, T h) {
  const T cG = static_cast<T>(1.0 / (8.0 * PI));
  const T cWn = static_cast<T>(3.0 / (4.0 * PI));
  const T iR = rsqrt_t(r2), iR2 = iR * iR, iR3 = iR * iR2, iR5 = iR3 * iR2;
  const T iI = rsqrt_t(rI2), iI2 = iI * iI, iI3 = iI * iI2, iI5 = iI3 * iI2;
  const T pn = dot3_rn(p[0], p[1], p[2], nrm[0], nrm[1], nrm[2]);
  const T pIn = dot3_rn(pI[0], pI[1], pI[2], nrm[0], nrm[1], nrm[2]);
  const T pIw = pI[WA];
  const T twoh = T(2) * h;
  const T beta = twoh * (pIw - h);
  const T d[6] = {p[0] * p[0], p[0] * p[1], p[0] * p[2],
                  p[1] * p[1], p[1] * p[2], p[2] * p[2]};
  const T dI[6] = {pI[0] * pI[0], pI[0] * pI[1], pI[0] * pI[2],
                   pI[1] * pI[1], pI[1] * pI[2], pI[2] * pI[2]};

  // ---- V: coefficients of p_a p_b, of pI_a pI_b (wall row / other rows),
  // of delta_ab (wall row / other rows) and of the SD terms
  const T wg = cG * w;
  const T gA = wg * iR3;
  const T gB = wg * iI3;
  const T wgb = wg * beta;
  const T cD5 = T(-3) * wgb * iI5;
  const T cD3 = wgb * iI3;
  const T vI_wall = cD5 - gB, vI_other = -cD5 - gB;
  const T gd = wg * iR - wg * iI;
  const T vd_wall = gd + cD3, vd_other = gd - cD3;
  const T cS = wg * twoh * iI3;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int q = ut(a, b);
      T g = gA * d[q] + (a == WA ? vI_wall : vI_other) * dI[q];
      if (a == b) g += a == WA ? vd_wall : vd_other;
      // t_a 2 h0 SD_ab: + on (w, b) and on (a, w), nothing on (w, w)
      if (a == WA && b != WA) g += cS * pI[b];
      if (b == WA && a != WA) g += cS * pI[a];
      v[3 * a + b] += g;
    }
  }

  // ---- K (the sums of W (W.n); the store negates them)
  const T c0 = cWn * w;
  const T e5 = c0 * iI5;
  const T kA = -(c0 * pn) * iR5;
  const T kI = e5 * pIn;
  const T f = T(5) * beta * iI2;
  const T kI_wall = kI * (T(1) + f), kI_other = kI * (T(1) - f);
  const T bT = e5 * beta;
  const T bU = e5 * twoh;
  const T bUn = bU * pIn;
  T sn[3], up[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    sn[a] = (a == WA ? -bT : bT) * nrm[a];        // s_a beta N_a / rI^5
    up[a] = (a == WA ? bU : -bU) * pIw * pI[a];   // -s_a 2 h0 pI_w pI_a / rI^5
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int q = ut(a, b);
      T g = kA * d[q] + (a == WA ? kI_wall : kI_other) * dI[q];
      g += sn[a] * pI[b] + up[a] * nrm[b];
      if (a == b) g += sn[a] * dI[q];
      if (a == WA) g -= bUn * pI[b];
      k[3 * a + b] += g;
    }
  }
}

template <typename T, int KIND, int WA>
__global__ void __launch_bounds__(TJ* TI)
    image_sweep_kernel(const T* __restrict__ xi, const T* __restrict__ Y,
                       const T* __restrict__ N, const T* __restrict__ W,
                       T* __restrict__ V, T* __restrict__ K, int64_t nr,
                       int64_t n, int64_t m, T wall_position) {
  __shared__ SampleTile<T> tile;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TJ + tx;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;

  T x[RT][3], xw_img[RT], h0[RT];
  T v[RT][9], k[RT][9];
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int64_t i = i0 + r * TI + ty;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[r][c] = i < nr ? xi[i * 3 + c] : T(0);
    h0[r] = x[r][WA] - wall_position;
    // the mirrored row point, rounded as kernels/images.py image_point does
    xw_img[r] = x[r][WA] - T(2) * h0[r];
#pragma unroll
    for (int q = 0; q < 9; ++q) v[r][q] = k[r][q] = T(0);
  }

  for (int64_t s0 = 0; s0 < m; s0 += SC) {
    __syncthreads();
    stage(tile, Y, N, W, j0, s0, n, m, tid);
    __syncthreads();

    const int sn = static_cast<int>(m - s0 < SC ? m - s0 : SC);
    for (int s = 0; s < sn; ++s) {
      const T y[3] = {tile.Y[0][s][tx], tile.Y[1][s][tx], tile.Y[2][s][tx]};
      const T nrm[3] = {tile.N[0][s][tx], tile.N[1][s][tx], tile.N[2][s][tx]};
      const T w = tile.W[s][tx];
#pragma unroll
      for (int r = 0; r < RT; ++r) {
        T p[3] = {y[0] - x[r][0], y[1] - x[r][1], y[2] - x[r][2]};
        T r2 = dot3_rn(p[0], p[1], p[2], p[0], p[1], p[2]);
        T pI[3] = {p[0], p[1], p[2]};
        pI[WA] = y[WA] - xw_img[r];
        T rI2 = dot3_rn(pI[0], pI[1], pI[2], pI[0], pI[1], pI[2]);
        T h = h0[r];
        if (r2 == T(0)) {
          p[0] = p[1] = p[2] = T(1);
          pI[0] = pI[1] = pI[2] = T(1);
          r2 = rI2 = T(3);
          h = T(0);
        }
        if constexpr (KIND == FREE_SURFACE) {
          add_free_surface<T, WA>(v[r], k[r], p, r2, pI, rI2, nrm, w);
        } else {
          add_no_slip<T, WA>(v[r], k[r], p, r2, pI, rI2, nrm, w, h);
        }
      }
    }
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
        V[off] = v[r][3 * a + b];
        // minus sign: exterior problem (reference `:2941-2947`)
        K[off] = -k[r][3 * a + b];
      }
    }
  }
}

template <typename T, int KIND, int WA>
int launch_one(const T* xi, const T* Y, const T* N, const T* W, T* V, T* K,
               int64_t nr, int64_t n, int64_t m, double wall_position,
               void* stream) {
  const dim3 block(TJ, TI);
  const dim3 grid(static_cast<unsigned>((n + TJ - 1) / TJ),
                  static_cast<unsigned>((nr + ROWS_PER_BLOCK - 1) /
                                        ROWS_PER_BLOCK));
  image_sweep_kernel<T, KIND, WA>
      <<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
          xi, Y, N, W, V, K, nr, n, m, static_cast<T>(wall_position));
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KIND>
int launch_axis(const T* xi, const T* Y, const T* N, const T* W, T* V, T* K,
                int64_t nr, int64_t n, int64_t m, int wall_axis,
                double wall_position, void* stream) {
  switch (wall_axis) {
    case 0:
      return launch_one<T, KIND, 0>(xi, Y, N, W, V, K, nr, n, m, wall_position, stream);
    case 1:
      return launch_one<T, KIND, 1>(xi, Y, N, W, V, K, nr, n, m, wall_position, stream);
    case 2:
      return launch_one<T, KIND, 2>(xi, Y, N, W, V, K, nr, n, m, wall_position, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch(const void* xi, const void* Y, const void* N, const void* W,
           void* V, void* K, int64_t nr, int64_t n, int64_t m, int kind,
           int wall_axis, double wall_position, void* stream) {
  if (nr <= 0 || n <= 0) return static_cast<int>(cudaGetLastError());
  const T* xi_ = static_cast<const T*>(xi);
  const T* Y_ = static_cast<const T*>(Y);
  const T* N_ = static_cast<const T*>(N);
  const T* W_ = static_cast<const T*>(W);
  T* V_ = static_cast<T*>(V);
  T* K_ = static_cast<T*>(K);
  if (kind == FREE_SURFACE)
    return launch_axis<T, FREE_SURFACE>(xi_, Y_, N_, W_, V_, K_, nr, n, m,
                                        wall_axis, wall_position, stream);
  if (kind == NO_SLIP)
    return launch_axis<T, NO_SLIP>(xi_, Y_, N_, W_, V_, K_, nr, n, m,
                                   wall_axis, wall_position, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

int node_sweep_image_f32(const void* xi, const void* Y, const void* N,
                         const void* W, void* V, void* K, int64_t nr,
                         int64_t n, int64_t m, int kind, int wall_axis,
                         double wall_position, void* stream) {
  return launch<float>(xi, Y, N, W, V, K, nr, n, m, kind, wall_axis,
                       wall_position, stream);
}

int node_sweep_image_f64(const void* xi, const void* Y, const void* N,
                         const void* W, void* V, void* K, int64_t nr,
                         int64_t n, int64_t m, int kind, int wall_axis,
                         double wall_position, void* stream) {
  return launch<double>(xi, Y, N, W, V, K, nr, n, m, kind, wall_axis,
                        wall_position, stream);
}

}  // extern "C"
