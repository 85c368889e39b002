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
// What bounds them.  Arithmetic, as K1 (node_sweep.cu): the stores are the
// same 2 * 9 * nr * n entries, while each interaction costs two inverse
// square roots and several times K1's multiply-adds; and within the
// arithmetic the FP64 pipe's issue rate, so what a sweep costs is its FP64
// instructions per interaction (counted from the machine code by
// scripts/torch_sass_count.py; PERF.md).
//
// What the design does about it.
// - A thread owns its (row, column) entries and the row's height h0 is a
//   per-row scalar in a register, so the thread forms the sample's
//   contributions and adds them into per-row sums, for its RT rows;
//   wall_axis is a template parameter, so the row signs and the delta_aw
//   terms are resolved at compile time.  Tiling, staging and stores are
//   those of node_sweep_common.cuh.
// - The scaffolding of K1: r^2 and rI^2 share the sum of the two squares
//   off the wall axis (one product, three FMAs for both); the inverse powers
//   come from one `rsqrt_pos` per distance; the dummy offset lives behind a
//   branch that real meshes never take, the r^2 = 0 test made once per group
//   on the integer pipe.  The f64 loops take two samples a trip, the f32
//   loops one (each the faster on the card, PERF.md).
// - The arithmetic is regrouped for few FP64 instructions (K3: 103 an
//   interaction in the machine code, against 170 before; K2 against 109).
//   The mirrored sample differs from p only in its wall component, so V
//   (and K2's K) splits into four blocks: the symmetric off-wall 2x2 block
//   (3 sums, not 4), the wall row (w, b) and the wall column (a, w), each
//   p_b times a coefficient formed once per sample and shared by the row
//   and the column, and the (w, w) entry; the diagonal terms are two scalar
//   sums combined at the store.  pI.N = p.N + 2 h0 N_w (one FMA where a
//   second dot3_rn was).  The weight and the constants 1/8pi, 3/4pi are
//   applied once (the weight in w / r^3, w / rI^3; the constants at the
//   store).  R.N keeps its round-to-nearest form (`dot3_rn`).
//   K2: 18 sums a row (10 of V, 8 of K), A p_a p_b + s_a B pI_a pI_b with
//   (A, B) = (w / r^3, w / rI^3) for V and (w (p.N) / r^5, w (pI.N) / rI^5)
//   for K (`add_mirror_dyads`).  K3: 19 sums; beta = 2 h0 (y_w - wall) from
//   the sample's height above the wall, its doublet terms folded into the
//   coefficients of the same blocks and K's 9 entries.
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

// V's four blocks of a row, with the weight folded in and without the
// constants: the off-wall symmetric block s (a0a0, a0a1, a1a1; a0, a1 the
// axes off the wall normal w in cyclic order), the wall row wb ((w, a0),
// (w, a1)), the wall column bw ((a0, w), (a1, w)) and the (w, w) dyad part
// ww.
template <typename T>
struct WallBlocks {
  T s[3], wb[2], bw[2], ww;
};

// Add A p_a p_b + s_a B pI_a pI_b (s_a = -1 on the wall row; pI = p off
// the wall axis) into the four blocks: p_a p_b (A + B) off the wall,
// p_b (A p_w - B pI_w) on the wall row, p_a (A p_w + B pI_w) on the wall
// column, A p_w^2 - B pI_w^2 at (w, w).  16 FP64 instructions.
template <typename T, int WA>
__device__ __forceinline__ void add_mirror_dyads(WallBlocks<T>& acc, const T (&p)[3], T pIw, T A, T B) {
  constexpr int A0 = (WA + 1) % 3, A1 = (WA + 2) % 3;
  const T u = A + B;
  const T u0 = u * p[A0];
  acc.s[0] = fma(u0, p[A0], acc.s[0]);
  acc.s[1] = fma(u0, p[A1], acc.s[1]);
  acc.s[2] = fma(u * p[A1], p[A1], acc.s[2]);
  const T X = A * p[WA], Y = B * pIw;
  const T Qw = X - Y, Qo = X + Y;
  acc.wb[0] = fma(Qw, p[A0], acc.wb[0]);
  acc.wb[1] = fma(Qw, p[A1], acc.wb[1]);
  acc.bw[0] = fma(Qo, p[A0], acc.bw[0]);
  acc.bw[1] = fma(Qo, p[A1], acc.bw[1]);
  acc.ww = fma(X, p[WA], fma(-Y, pIw, acc.ww));
}

// Entry (a, b) of the four blocks.
template <typename T, int WA>
__device__ __forceinline__ T block_entry(const WallBlocks<T>& acc, int a, int b) {
  constexpr int A0 = (WA + 1) % 3;
  if (a != WA && b != WA) return acc.s[a == A0 ? (b == A0 ? 0 : 1) : (b == A0 ? 1 : 2)];
  if (a == WA && b == WA) return acc.ww;
  if (a == WA) return acc.wb[b == A0 ? 0 : 1];
  return acc.bw[a == A0 ? 0 : 1];
}

// The sums of one row, without the constants and with the weight folded
// in.  Free surface: V's and K's four blocks, and V's diagonal terms, the
// sums of w / r and of w / rI.  No slip: V's off-wall symmetric block
// (a0a0, a0a1, a1a1), its wall row (w, a0), (w, a1), its wall column
// (a0, w), (a1, w), its (w, w) dyad part, the sums of 1/r - 1/rI and of
// beta / rI^3 (the diagonal terms), and K's 9 entries.
template <typename T, int KIND>
struct RowSums {
  WallBlocks<T> v, k;
  T vdr, vdI;
};
template <typename T>
struct RowSums<T, NO_SLIP> {
  T vs[3], vwb[2], vbw[2], vww, vdg, vd3, k[9];
};

// A sample seen from a row: p = y - xi, the wall-normal component of its
// mirror pI (the others are p's), their squared lengths, and 2 h0.
template <typename T>
struct Pair {
  T p[3];
  T pIw, r2, rI2, twoh;
};

// One sample of the free-surface kernel added into a row's sums; w is its
// weight, n its unit normal.  G = G0(p) + s_a G0(pI), W.n = Wn0(p) +
// s_a Wn0(pI): V's dyads with (w / r^3, w / rI^3), K's with
// (w (p.N) / r^5, w (pI.N) / rI^5).  68 FP64 instructions an interaction
// with the scaffolding around it.
template <typename T, int WA>
__device__ __forceinline__ void add_free_surface(RowSums<T, FREE_SURFACE>& acc, const Pair<T>& g,
                                                 const T (&n)[3], T w) {
  const T(&p)[3] = g.p;
  const T iR = rsqrt_pos(g.r2), iR2 = iR * iR;
  const T iI = rsqrt_pos(g.rI2), iI2 = iI * iI;
  const T wiR = w * iR, wiI = w * iI;
  const T gA = wiR * iR2;  // w / r^3
  const T gB = wiI * iI2;  // w / rI^3
  acc.vdr += wiR;
  acc.vdI += wiI;
  add_mirror_dyads<T, WA>(acc.v, p, g.pIw, gA, gB);
  const T pn = dot3_rn(p[0], p[1], p[2], n[0], n[1], n[2]);
  const T pIn = fma(g.twoh, n[WA], pn);  // pI.N
  add_mirror_dyads<T, WA>(acc.k, p, g.pIw, (pn * iR2) * gA, (pIn * iI2) * gB);
}

// One sample of the Blake no-slip kernel added into a row's sums; sw is the
// sample's height above the wall, w its weight, n its unit normal.
template <typename T, int WA>
__device__ __forceinline__ void add_no_slip(RowSums<T, NO_SLIP>& acc, const Pair<T>& g,
                                            const T (&n)[3], T w, T sw) {
  constexpr int A0 = (WA + 1) % 3, A1 = (WA + 2) % 3;
  const T(&p)[3] = g.p;
  const T pw = p[WA], pIw = g.pIw, twoh = g.twoh;
  const T iR = rsqrt_pos(g.r2), iR2 = iR * iR;
  const T iI = rsqrt_pos(g.rI2), iI2 = iI * iI;
  const T beta = twoh * sw;  // 2 h0 (pI_w - h0)

  // ---- V (8 pi G, times w)
  const T wiR = w * iR, wiI = w * iI;
  const T gA = wiR * iR2;        // w / r^3: p_a p_b
  const T gB = wiI * iI2;        // w / rI^3
  const T iI5w = gB * iI2;       // w / rI^5
  const T bT = beta * iI5w;      // beta w / rI^5
  const T cD3 = beta * gB;       // beta w / rI^3: t_a delta_ab
  const T vI_w = fma(T(-3), bT, -gB);  // pI_a pI_b, wall row
  const T vI_o = fma(T(3), bT, -gB);   // pI_a pI_b, other rows
  const T u = gA + vI_o;               // p_a p_b, off-wall block
  const T cS = twoh * gB;              // 2 h0 SD
  acc.vdg += wiR - wiI;
  acc.vd3 += cD3;
  const T up0 = u * p[A0];
  acc.vs[0] = fma(up0, p[A0], acc.vs[0]);
  acc.vs[1] = fma(up0, p[A1], acc.vs[1]);
  acc.vs[2] = fma(u * p[A1], p[A1], acc.vs[2]);
  // (w, b) and (b, w), b off the wall: p_b (gA p_w + vI pI_w + cS)
  const T X = gA * pw, Y = vI_w * pIw;
  const T A = X + cS;
  const T Qw = Y + A, Qo = fma(vI_o, pIw, A);
  acc.vwb[0] = fma(Qw, p[A0], acc.vwb[0]);
  acc.vwb[1] = fma(Qw, p[A1], acc.vwb[1]);
  acc.vbw[0] = fma(Qo, p[A0], acc.vbw[0]);
  acc.vbw[1] = fma(Qo, p[A1], acc.vbw[1]);
  acc.vww = fma(X, pw, fma(Y, pIw, acc.vww));

  // ---- K ((4 pi / 3) W.n, times w)
  const T pn = dot3_rn(p[0], p[1], p[2], n[0], n[1], n[2]);
  const T kA = (pn * iR2) * gA;                // w (p.N) / r^5
  const T pIn = fma(twoh, n[WA], pn);          // pI.N
  const T kI = pIn * iI5w;                     // w (pI.N) / rI^5
  const T kIf = kI * (beta * iI2);
  const T kI_w = fma(T(5), kIf, kI), kI_o = fma(T(-5), kIf, kI);
  const T bU = twoh * iI5w;                    // 2 h0 w / rI^5
  const T bUw = bU * pIw;
  const T kAw = kA * pw;
  // rows a off the wall: p_b ((kI_o - kA) p_a + bT n_a) - bUw p_a n_b
  //   (+ bT p_a^2 n_a on the diagonal), and p_a G + bT n_a pI_w at (a, w)
  const T dk = kI_o - kA;
  const T G = fma(-bUw, n[WA], fma(kI_o, pIw, -kAw));
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int a = e == 0 ? A0 : A1, o = e == 0 ? A1 : A0;
    const T bTn = bT * n[a];
    const T C = fma(dk, p[a], bTn);
    const T E = -(bUw * p[a]);
    acc.k[3 * a + a] = fma(fma(bTn, p[a], C), p[a], fma(E, n[a], acc.k[3 * a + a]));
    acc.k[3 * a + o] = fma(C, p[o], fma(E, n[o], acc.k[3 * a + o]));
    acc.k[3 * a + WA] = fma(G, p[a], fma(bTn, pIw, acc.k[3 * a + WA]));
  }
  // the wall row: p_b (H0 - kA p_w) + n_b bUw pI_w at (w, b), and
  // -kA p_w^2 + pI_w (H0 + n_w (bUw - bT pI_w)) at (w, w)
  const T H0 = fma(-bT, n[WA], fma(kI_w, pIw, -(bU * pIn)));
  const T Hb = H0 - kAw;
  const T J = bUw * pIw;
  acc.k[3 * WA + A0] = fma(Hb, p[A0], fma(J, n[A0], acc.k[3 * WA + A0]));
  acc.k[3 * WA + A1] = fma(Hb, p[A1], fma(J, n[A1], acc.k[3 * WA + A1]));
  acc.k[3 * WA + WA] =
      fma(-kAw, pw, fma(fma(n[WA], fma(-bT, pIw, bUw), H0), pIw, acc.k[3 * WA + WA]));
}

template <typename T, int KIND, int WA>
__device__ __forceinline__ void add_sample(RowSums<T, KIND>& acc, const Pair<T>& q,
                                           const T (&n)[3], T w, T sw) {
  if constexpr (KIND == FREE_SURFACE) {
    add_free_surface<T, WA>(acc, q, n, w);
  } else {
    add_no_slip<T, WA>(acc, q, n, w, sw);
  }
}

// Row a, column b of V and K from a row's sums.
template <typename T, int KIND, int WA>
__device__ __forceinline__ void entries(const RowSums<T, KIND>& acc, int a, int b, T& v, T& k) {
  const T cG = static_cast<T>(1.0 / (8.0 * PI));
  // the stresslet's 3/4pi, negated for the exterior problem (reference
  // `:2941-2947`); the free surface's K sums carry W.n's own minus sign
  const T cK = static_cast<T>(3.0 / (4.0 * PI));
  if constexpr (KIND == FREE_SURFACE) {
    T s = block_entry<T, WA>(acc.v, a, b);
    if (a == b) s += a == WA ? acc.vdr - acc.vdI : acc.vdr + acc.vdI;
    v = cG * s;
    k = cK * block_entry<T, WA>(acc.k, a, b);
  } else {
    constexpr int A0 = (WA + 1) % 3;
    T s;
    if (a != WA && b != WA) {
      s = acc.vs[a == A0 ? (b == A0 ? 0 : 1) : (b == A0 ? 1 : 2)];
      if (a == b) s += acc.vdg - acc.vd3;
    } else if (a == WA && b == WA) {
      s = acc.vww + (acc.vdg + acc.vd3);
    } else if (a == WA) {
      s = acc.vwb[b == A0 ? 0 : 1];
    } else {
      s = acc.vbw[a == A0 ? 0 : 1];
    }
    v = cG * s;
    k = -cK * acc.k[3 * a + b];
  }
}

template <typename T, int KIND, int WA>
__global__ void __launch_bounds__(TJ* TI)
    image_sweep_kernel(const T* __restrict__ xi, const T* __restrict__ Y,
                       const T* __restrict__ N, const T* __restrict__ W,
                       T* __restrict__ V, T* __restrict__ K, int64_t nr,
                       int64_t n, int64_t m, T wall_position) {
  // samples a trip: two in f64, one in f32, for both kinds
  constexpr int UNROLL = unroll<T>(2, 1);
  static_assert(SC % UNROLL == 0, "the sample loop has no remainder");
  __shared__ SampleTile<T> tile;

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TJ + tx;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * TJ;
  const int64_t i0 = static_cast<int64_t>(blockIdx.y) * ROWS_PER_BLOCK;

  T x[RT][3], xw_img[RT], twoh[RT];
  RowSums<T, KIND> acc[RT] = {};
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    const int64_t i = i0 + r * TI + ty;
#pragma unroll
    for (int c = 0; c < 3; ++c) x[r][c] = i < nr ? xi[i * 3 + c] : T(0);
    const T h0 = x[r][WA] - wall_position;
    twoh[r] = T(2) * h0;
    // the mirrored row point, rounded as kernels/images.py image_point does
    xw_img[r] = x[r][WA] - twoh[r];
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
      Pair<T> g[UNROLL][RT];
      T nrm[UNROLL][3], w[UNROLL], sw[UNROLL];
      bool any = false;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        T y[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          y[c] = tile.Y[c][s + u][tx];
          nrm[u][c] = tile.N[c][s + u][tx];
        }
        w[u] = tile.W[s + u][tx];
        sw[u] = y[WA] - wall_position;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          Pair<T>& q = g[u][r];
#pragma unroll
          for (int c = 0; c < 3; ++c) q.p[c] = y[c] - x[r][c];
          q.pIw = y[WA] - xw_img[r];
          q.twoh = twoh[r];
          const T s2 = fma(q.p[(WA + 2) % 3], q.p[(WA + 2) % 3], q.p[(WA + 1) % 3] * q.p[(WA + 1) % 3]);
          q.r2 = fma(q.p[WA], q.p[WA], s2);
          q.rI2 = fma(q.pIw, q.pIw, s2);
          any = any || is_zero(q.r2);
        }
      }
      if (any) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int r = 0; r < RT; ++r) {
            Pair<T>& q = g[u][r];
            // an exact r^2 = 0 pair: the dummy offset p = pI = (1, 1, 1),
            // h0 = 0
            if (is_zero(q.r2)) {
              q.p[0] = q.p[1] = q.p[2] = q.pIw = T(1);
              q.r2 = q.rI2 = T(3);
              q.twoh = T(0);
            }
            add_sample<T, KIND, WA>(acc[r], q, nrm[u], w[u], sw[u]);
          }
        }
      } else {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
          for (int r = 0; r < RT; ++r) add_sample<T, KIND, WA>(acc[r], g[u][r], nrm[u], w[u], sw[u]);
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
        entries<T, KIND, WA>(acc[r], a, b, V[off], K[off]);
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
