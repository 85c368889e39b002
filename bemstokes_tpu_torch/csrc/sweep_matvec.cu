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
// What bounds it.  Arithmetic alone, and within it the FP64 pipe's issue
// rate.  It reads 7 n m + 3 nr + 3 n (BV + BK) values and writes
// 3 nr (BV + BK): a few MB at 24,578 nodes, against nr n m = 3.9e10
// interactions.  An SM issues 64 FP64 lanes a clock whether the instruction
// is a DFMA, a DMUL or a DADD (measured: scripts/torch_sass_count.py
// --probe), so what the sweep costs is the number of FP64 instructions per
// interaction, not the operations they stand for.  Counted from the machine
// code by the same script, free space / free surface / no slip: V alone
// 22 / 39 / 50, K alone 27 / 46 / 74, both 37 / 64 / 101 (before the
// redesign: 47 / 90 / 150 for both), 5 of each per distance in the inverse
// square root; at 24,578 nodes on an H100 at 1.98 GHz the V-only sweeps run
// at 80 to 86 % of the time that count allows (PERF.md).  In float32 the
// FP32 pipe is twice as wide and the total issue rate binds instead.
//
// What the design does about it.
// - One thread owns one row and keeps its 3 (BV + BK) sums in registers for
//   the whole sweep.  Rows alone are too few threads for 132 SMs, so the
//   column nodes are split over gridDim.y and every block writes a partial
//   sum.  A second kernel adds the partial sums in the fixed order of the
//   splits, and the number of splits depends on the shapes and the card's SM
//   count only: the same bits from run to run, no atomics.
// - One-sided launches.  The batch widths are template parameters and a zero
//   width compiles its half away: (1, 0) is the GMRES matvec of a system
//   whose columns are all single-layer (every all-body mesh), (0, 1) its
//   double-layer twin, (1, 1) the mixed case; wider batches go in chunks of
//   BW columns through (BW, BW), (BW, 0) or (0, BW).
// - Few FP64 instructions per interaction.  r^2 is two FMAs and a product.
//   The inverse powers come from one `rsqrt_pos` per distance (five FP64
//   instructions, no branch; node_sweep_common.cuh).  Everything that does
//   not depend on the row is done when a sample is staged: the normal is
//   staged times its weight (W.n is linear in it), and the constants 1/8pi
//   and 3/4pi (with K's sign) are applied once per output by the reduction.
//   Terms whose vector is the node's value x, fixed over a node's samples
//   (d0 x, dI x, beta/rI^3 x, beta pI_a^2 N_a x_a / rI^5), are summed as
//   scalars over the samples and multiplied by x once per node and pass.
//   pI.x is p.x plus (pI_w - p_w) x_w.  R.N keeps its round-to-nearest form
//   (`dot3_rn`): it cancels on a column's own panels.  (Tried and dropped:
//   p.x as a staged (y - c).x less (xi - c).x; it saves two instructions,
//   costs a shared-memory load and digits on near pairs, and bought 2 % in
//   f64 and nothing in f32; PERF.md.)
// - The wall normal is moved to the last coordinate when rows, samples and
//   vectors are loaded and moved back when the sums are stored, so the wall
//   axis costs no instantiation.
// - The sample loop is unrolled (four samples at a time in the narrow
//   kernels, two in the wide ones, whose registers are scarcer) with no remainder:
//   samples past a node's m are staged with weight zero.  The r^2 = 0 test
//   is made once per group on the integer pipe, and the dummy offset lives
//   in a second copy of the group's body behind a branch.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous and of
// one type T (float or double):
//   xi [nr, 3], Y [n, m, 3], N [n, m, 3], W [n, m], XV [3 n, BV],
//   XK [3 n, BK]; OV [3 nr, BV], OK [3 nr, BK] (out);
//   part: scratch of sweep_matvec_part_elems(nr, n, BV, BK) values;
//   kind 0 = free space, 1 = free surface, 2 = no slip; wall_axis 0, 1, 2.
// Launches on `stream`, does not synchronise, and returns cudaGetLastError()
// (cudaErrorInvalidValue for an unknown kind or axis).
//
// The K5_* macros are the steps PERF.md times one by one
// (scripts/torch_sass_count.py --define K5_FAST_RSQRT=0 ...); their defaults
// are the kernel.  K5_ROWS = 1 serves the off-card check of the arithmetic.

#include "node_sweep_common.cuh"

#ifndef K5_R2_FMA
#define K5_R2_FMA 1  // r^2 by two FMAs and a product (0: dot3_rn)
#endif
#ifndef K5_FAST_RSQRT
#define K5_FAST_RSQRT 1  // rsqrt_pos (0: the library's rsqrt)
#endif
#ifndef K5_UNROLL
#define K5_UNROLL 4  // samples per trip of the sample loop, narrow kernels
#endif
#ifndef K5_UNROLL_WIDE
#define K5_UNROLL_WIDE 2  // the same, kernels of BW columns
#endif
#ifndef K5_ROWS
#define K5_ROWS 128  // threads of a block = rows of a block
#endif

namespace {

using namespace node_sweep;

constexpr int FREE_SPACE = 0;
constexpr int FREE_SURFACE = 1;
constexpr int NO_SLIP = 2;
constexpr double PI = 3.14159265358979323846;

constexpr int ROWS = K5_ROWS;
constexpr int CT = 4;         // column nodes staged per pass
constexpr int SS = 32;        // samples of each staged per pass
constexpr int BW = 4;         // widest batch chunk of one launch
constexpr int MIN_COLS = 32;  // fewest column nodes worth a split
// blocks aimed at, per SM: at 24,578 nodes 16 waves of the 4 blocks an SM
// holds, so that the last, part-filled wave costs little
constexpr int BLOCKS_PER_SM = 64;
static_assert(SS % K5_UNROLL == 0 && SS % K5_UNROLL_WIDE == 0,
              "the sample loop has no remainder");

__host__ __device__ constexpr int at_least_one(int b) { return b > 0 ? b : 1; }

// A staged sample: the point, the weight, and the normal times the weight.
template <typename T>
struct alignas(16) Sample {
  T y[3];
  T w;
  T wn[3];
  T pad;
};

// The sums of one row: BV columns of V, BK columns of K, 3 components each
// (in the kernel's coordinates: the wall normal last).
template <typename T, int BV, int BK>
struct Sums {
  T v[at_least_one(BV)][3];
  T k[at_least_one(BK)][3];
};

// Sums over a node's staged samples of the coefficients whose vector is the
// node's own value: V's x_a terms (a, b) and, for the no-slip K, pI_a^2 N_a.
template <typename T>
struct NodeSums {
  T a, b;
  T q[3];
};

template <typename T>
__device__ __forceinline__ T dot3(const T (&a)[3], const T (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

template <typename T>
__device__ __forceinline__ T norm2(T a, T b, T c) {
#if K5_R2_FMA
  return fma(c, c, fma(b, b, a * a));
#else
  return dot3_rn(a, b, c, a, b, c);
#endif
}

template <typename T>
__device__ __forceinline__ T inv_sqrt(T x) {
#if K5_FAST_RSQRT
  return rsqrt_pos(x);
#else
  return rsqrt_t(x);
#endif
}

// r^2 is a sum of squares: it is zero only as +0, which the integer pipe can
// test.
__device__ __forceinline__ bool is_zero(float r2) { return r2 == 0.0f; }
__device__ __forceinline__ bool is_zero(double r2) {
  return (__double2hiint(r2) | __double2loint(r2)) == 0;
}

// A sample seen from a row: p = y - xi, the wall-normal component of its
// mirror pI (the others are p's), their squared lengths, and the row's
// height above the wall.  Coordinates are the kernel's (wall normal =
// component 2).
template <typename T>
struct Pair {
  T p[3];
  T pIw, r2, rI2, h;
};

template <typename T, int KIND>
__device__ __forceinline__ Pair<T> pair_of(const Sample<T>& q, const T (&x)[3], T xw_img,
                                           T h0) {
  Pair<T> g;
#pragma unroll
  for (int a = 0; a < 3; ++a) g.p[a] = q.y[a] - x[a];
  g.r2 = norm2(g.p[0], g.p[1], g.p[2]);
  g.pIw = g.p[2];
  g.rI2 = g.r2;
  g.h = h0;
  if constexpr (KIND != FREE_SPACE) {
    g.pIw = q.y[2] - xw_img;
    g.rI2 = norm2(g.p[0], g.p[1], g.pIw);
  }
  return g;
}

// The dummy offset of an exact r^2 = 0 pair (a row that lies on a sample):
// p = pI = (1, 1, 1), h0 = 0, as the plain version and K1-K3 have it, so
// that the singular delta cancels the pair.
template <typename T>
__device__ __forceinline__ void make_dummy(Pair<T>& g) {
  g.p[0] = g.p[1] = g.p[2] = g.pIw = T(1);
  g.r2 = g.rI2 = T(3);
  g.h = T(0);
}

// One sample added into a row's sums.  xv, xk are the column node's values
// (nv, nk of them are real; a narrow kernel's one column always is).
template <typename T, int KIND, int BV, int BK>
__device__ __forceinline__ void add_sample(
    Sums<T, BV, BK>& acc, NodeSums<T>& ns, const Pair<T>& g, const Sample<T>& q,
    const T (&xv)[at_least_one(BV)][3], const T (&xk)[at_least_one(BK)][3], int nv,
    int nk) {
  const T(&p)[3] = g.p;
  const T pIw = g.pIw, r2 = g.r2, rI2 = g.rI2, h = g.h, twoh = T(2) * g.h;

  const T iR = inv_sqrt(r2), iR2 = iR * iR;
  T wiR = T(0), g0 = T(0), k0 = T(0);
  if constexpr (BV > 0) {
    wiR = q.w * iR;   // x_a of G0(p) x
    g0 = wiR * iR2;   // (p.x) p_a of G0(p) x
  }
  if constexpr (BK > 0) {
    const T pn = dot3_rn(p[0], p[1], p[2], q.wn[0], q.wn[1], q.wn[2]);
    k0 = (pn * iR2) * (iR * iR2);  // (p.x) p_a of -Wn0(p) x
  }

  if constexpr (KIND == FREE_SPACE) {
    if constexpr (BV > 0) {
      ns.a += wiR;
#pragma unroll
      for (int b = 0; b < BV; ++b) {
        if (BV == 1 || b < nv) {
          const T t = g0 * dot3(p, xv[b]);
#pragma unroll
          for (int a = 0; a < 3; ++a) acc.v[b][a] += t * p[a];
        }
      }
    }
    if constexpr (BK > 0) {
#pragma unroll
      for (int b = 0; b < BK; ++b) {
        if (BK == 1 || b < nk) {
          const T t = k0 * dot3(p, xk[b]);
#pragma unroll
          for (int a = 0; a < 3; ++a) acc.k[b][a] += t * p[a];
        }
      }
    }
    return;
  }

  const T iI = inv_sqrt(rI2), iI2 = iI * iI;
  const T dz = pIw - p[2];  // pI.x = p.x + dz x_w
  T wiI = T(0), gI = T(0);
  if constexpr (BV > 0) {
    wiI = q.w * iI;
    gI = wiI * iI2;
  }

  if constexpr (KIND == FREE_SURFACE) {
    if constexpr (BV > 0) {
      ns.a += wiR;
      ns.b += wiI;
#pragma unroll
      for (int b = 0; b < BV; ++b) {
        if (BV == 1 || b < nv) {
          const T px = dot3(p, xv[b]);
          const T t = g0 * px;
          const T tI = gI * fma(dz, xv[b][2], px);
          const T tt = t + tI;  // p_a = pI_a off the wall normal
          acc.v[b][0] += tt * p[0];
          acc.v[b][1] += tt * p[1];
          acc.v[b][2] += t * p[2] - tI * pIw;
        }
      }
    }
    if constexpr (BK > 0) {
      const T pIn = dot3_rn(p[0], p[1], pIw, q.wn[0], q.wn[1], q.wn[2]);
      const T kI = (pIn * iI2) * (iI * iI2);
#pragma unroll
      for (int b = 0; b < BK; ++b) {
        if (BK == 1 || b < nk) {
          const T px = dot3(p, xk[b]);
          const T t = k0 * px;
          const T tI = kI * fma(dz, xk[b][2], px);
          const T tt = t + tI;
          acc.k[b][0] += tt * p[0];
          acc.k[b][1] += tt * p[1];
          acc.k[b][2] += t * p[2] - tI * pIw;
        }
      }
    }
    return;
  }

  if constexpr (KIND == NO_SLIP) {
    const T beta = twoh * (pIw - h);
    if (BV == 1 || (BV > 0 && nv > 0)) {
      const T bD3 = beta * gI;               // beta D: x_a
      const T bD5 = (T(-3) * bD3) * iI2;     // beta D: (pI.x) pI_a
      const T cS = twoh * gI;                // 2 h0 SD
      const T u1 = gI + bD5, u2 = bD5 - gI;
      ns.a += wiR - wiI;
      ns.b += bD3;
#pragma unroll
      for (int b = 0; b < BV; ++b) {
        if (BV == 1 || b < nv) {
          const T px = dot3(p, xv[b]);
          const T pxI = fma(dz, xv[b][2], px);
          const T t = g0 * px;
          const T sxw = cS * xv[b][2];
          const T q1 = fma(-u1, pxI, t) + sxw;  // coefficient of p_a, a != w
          const T qw = fma(u2, pxI, -sxw);      // coefficient of pI_w
          acc.v[b][0] += q1 * p[0];
          acc.v[b][1] += q1 * p[1];
          acc.v[b][2] += t * p[2] + qw * pIw + cS * pxI;
        }
      }
    }
    if (BK == 1 || (BK > 0 && nk > 0)) {
      // pI.N with its products kept: pI_a N_a is also the hoisted term's
      const T m0 = mul_rn(p[0], q.wn[0]), m1 = mul_rn(p[1], q.wn[1]);
      const T m2 = mul_rn(pIw, q.wn[2]);
      const T pIn = add_rn(add_rn(m0, m1), m2);
      const T iI5 = (iI * iI2) * iI2;
      const T kI = iI5 * pIn;                      // -Wn0(pI) x: (pI.x) pI_a
      const T bT = iI5 * beta;                     // beta / rI^5
      const T bT7 = (bT * iI2) * (T(5) * pIn);     // 5 beta (pI.N) / rI^7
      const T bU = iI5 * twoh;                     // 2 h0 / rI^5
      const T bUp = bU * pIn, bUw = bU * pIw;
      const T ka = bT7 - kI, kb = bT7 + kI;
      ns.q[0] = fma(bT, m0 * p[0], ns.q[0]);
      ns.q[1] = fma(bT, m1 * p[1], ns.q[1]);
      ns.q[2] = fma(bT, m2 * pIw, ns.q[2]);
#pragma unroll
      for (int b = 0; b < BK; ++b) {
        if (BK == 1 || b < nk) {
          const T px = dot3(p, xk[b]);
          const T pxI = fma(dz, xk[b][2], px);
          const T nx = dot3(q.wn, xk[b]);
          const T t = k0 * px;
          const T g = bUw * nx;
          const T c1 = fma(ka, pxI, t) + g;  // coefficient of p_a, a != w
          const T cw = fma(kb, pxI, g);      // coefficient of -pI_w
          const T tn = bT * pxI;
          acc.k[b][0] += c1 * p[0] - tn * q.wn[0];
          acc.k[b][1] += c1 * p[1] - tn * q.wn[1];
          acc.k[b][2] += t * p[2] - cw * pIw + tn * q.wn[2] + bUp * pxI;
        }
      }
    }
  }
}

// The node's scalar sums times its value, added into the row's sums.
template <typename T, int KIND, int BV, int BK>
__device__ __forceinline__ void add_node_sums(Sums<T, BV, BK>& acc, const NodeSums<T>& ns,
                                              const T (&xv)[at_least_one(BV)][3],
                                              const T (&xk)[at_least_one(BK)][3]) {
  if constexpr (BV > 0) {
    // free space: a; image kinds: a + s b off the wall normal, a - s b on it
    const T s = KIND == FREE_SURFACE ? T(1) : T(-1);
    const T off = KIND == FREE_SPACE ? ns.a : ns.a + s * ns.b;
    const T on = KIND == FREE_SPACE ? ns.a : ns.a - s * ns.b;
#pragma unroll
    for (int b = 0; b < BV; ++b) {
      acc.v[b][0] += off * xv[b][0];
      acc.v[b][1] += off * xv[b][1];
      acc.v[b][2] += on * xv[b][2];
    }
  }
  if constexpr (BK > 0 && KIND == NO_SLIP) {
#pragma unroll
    for (int b = 0; b < BK; ++b) {
      acc.k[b][0] -= ns.q[0] * xk[b][0];
      acc.k[b][1] -= ns.q[1] * xk[b][1];
      acc.k[b][2] += ns.q[2] * xk[b][2];
    }
  }
}

// part[split][a][i][BV + BK]: the sums of the block's column nodes.  `wa` is
// the wall axis; component c of the kernel is component (wa + 1 + c) % 3 of
// the arrays.
template <typename T, int KIND, int BV, int BK>
__global__ void __launch_bounds__(ROWS)
    sweep_matvec_kernel(const T* __restrict__ xi, const T* __restrict__ Y,
                        const T* __restrict__ N, const T* __restrict__ W,
                        const T* __restrict__ XV, const T* __restrict__ XK,
                        T* __restrict__ part, int64_t nr, int64_t n, int64_t m,
                        int64_t ldv, int64_t v0, int nv, int64_t ldk, int64_t k0,
                        int nk, int64_t cols_per_split, T wall_position, int wa) {
  constexpr int NV = at_least_one(BV), NK = at_least_one(BK);
  __shared__ Sample<T> tile[CT][SS];
  __shared__ T sxv[CT][NV][3];
  __shared__ T sxk[CT][NK][3];
  constexpr int UNROLL = BV + BK <= 2 ? K5_UNROLL : K5_UNROLL_WIDE;

  const int tid = threadIdx.x;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * ROWS + tid;
  const int64_t jlo = static_cast<int64_t>(blockIdx.y) * cols_per_split;
  const int64_t jhi = jlo + cols_per_split < n ? jlo + cols_per_split : n;
  // the arrays' component of the kernel's component c
  const auto perm = [wa](int c) { return (wa + 1 + c) % 3; };

  T x[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = i < nr ? xi[i * 3 + perm(c)] : T(0);
  const T h0 = x[2] - wall_position;
  // the mirrored row point, rounded as kernels/images.py image_point does
  const T xw_img = x[2] - T(2) * h0;

  Sums<T, BV, BK> acc;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
#pragma unroll
    for (int b = 0; b < NV; ++b) acc.v[b][a] = T(0);
#pragma unroll
    for (int b = 0; b < NK; ++b) acc.k[b][a] = T(0);
  }

  for (int64_t j0 = jlo; j0 < jhi; j0 += CT) {
    const int cn = static_cast<int>(jhi - j0 < CT ? jhi - j0 : CT);
    for (int64_t s0 = 0; s0 < m; s0 += SS) {
      const int sn = static_cast<int>(m - s0 < SS ? m - s0 : SS);
      __syncthreads();
      for (int t = tid; t < CT * SS; t += ROWS) {
        const int c = t / SS;
        const int s = t % SS;
        Sample<T> q;
        // past the node's samples: weight zero, so the loop needs no tail
        q.y[0] = q.y[1] = q.y[2] = q.w = q.wn[0] = q.wn[1] = q.wn[2] = q.pad = T(0);
        if (c < cn && s < sn) {
          const int64_t g = (j0 + c) * m + s0 + s;
          q.w = W[g];
#pragma unroll
          for (int a = 0; a < 3; ++a) {
            q.y[a] = Y[g * 3 + perm(a)];
            if constexpr (BK > 0) q.wn[a] = q.w * N[g * 3 + perm(a)];
          }
        }
        tile[c][s] = q;
      }
      if (s0 == 0) {
        for (int t = tid; t < CT * BV * 3; t += ROWS) {
          const int c = t / (NV * 3), b = (t / 3) % NV, a = t % 3;
          sxv[c][b][a] =
              c < cn && b < nv ? XV[(perm(a) * n + j0 + c) * ldv + v0 + b] : T(0);
        }
        for (int t = tid; t < CT * BK * 3; t += ROWS) {
          const int c = t / (NK * 3), b = (t / 3) % NK, a = t % 3;
          sxk[c][b][a] =
              c < cn && b < nk ? XK[(perm(a) * n + j0 + c) * ldk + k0 + b] : T(0);
        }
      }
      __syncthreads();

      const int sn_whole = (sn + UNROLL - 1) / UNROLL * UNROLL;
      for (int c = 0; c < cn; ++c) {
        T xv[NV][3], xk[NK][3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < NV; ++b) xv[b][a] = BV > 0 ? sxv[c][b][a] : T(0);
#pragma unroll
          for (int b = 0; b < NK; ++b) xk[b][a] = BK > 0 ? sxk[c][b][a] : T(0);
        }
        NodeSums<T> ns;
        ns.a = ns.b = ns.q[0] = ns.q[1] = ns.q[2] = T(0);
        for (int s = 0; s < sn_whole; s += UNROLL) {
          // the group's pairs first: one test, and a branch that is next to
          // never taken, keeps the dummy offset's selects out of the loop
          Pair<T> g[UNROLL];
          bool dummy[UNROLL], any = false;
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            g[u] = pair_of<T, KIND>(tile[c][s + u], x, xw_img, h0);
            dummy[u] = is_zero(g[u].r2);
            any = any || dummy[u];
          }
          if (any) {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              if (dummy[u]) make_dummy(g[u]);
              add_sample<T, KIND, BV, BK>(acc, ns, g[u], tile[c][s + u], xv, xk, nv, nk);
            }
          } else {
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
              add_sample<T, KIND, BV, BK>(acc, ns, g[u], tile[c][s + u], xv, xk, nv, nk);
            }
          }
        }
        add_node_sums<T, KIND, BV, BK>(acc, ns, xv, xk);
      }
    }
  }

  if (i >= nr) return;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    T* out = part + ((static_cast<int64_t>(blockIdx.y) * 3 + perm(a)) * nr + i) * (BV + BK);
#pragma unroll
    for (int b = 0; b < BV; ++b) out[b] = acc.v[b][a];
#pragma unroll
    for (int b = 0; b < BK; ++b) out[BV + b] = acc.k[b][a];
  }
}

// The splits' partial sums added in the order of the splits and scaled by
// the constant of their operator: 1/8pi for V, 3/4pi for K (the stresslet's
// -3/4pi negated for the exterior problem, reference `:2941-2947`).  bv, bk
// are the widths of the launch that wrote `part`, nv, nk the columns it
// really has.
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
    OV[row * ldv + v0 + b] = static_cast<T>(1.0 / (8.0 * PI)) * sum;
  } else {
    OK[row * ldk + k0 + (b - bv)] = static_cast<T>(3.0 / (4.0 * PI)) * sum;
  }
}

struct Args {
  const void *xi, *Y, *N, *W, *XV, *XK;
  void *OV, *OK, *part;
  int64_t nr, n, m, BV, BK;
  int64_t splits;  // of the column nodes: splits_for(nr, n)
  double wall_position;
  int wall_axis;
  cudaStream_t stream;
};

template <typename T, int KIND, int BV, int BK>
int launch_chunk(const Args& g, int64_t v0, int nv, int64_t k0, int nk) {
  const int64_t cols_per_split = (g.n + g.splits - 1) / g.splits;
  const dim3 grid(static_cast<unsigned>((g.nr + ROWS - 1) / ROWS),
                  static_cast<unsigned>(g.splits));
  sweep_matvec_kernel<T, KIND, BV, BK><<<grid, ROWS, 0, g.stream>>>(
      static_cast<const T*>(g.xi), static_cast<const T*>(g.Y),
      static_cast<const T*>(g.N), static_cast<const T*>(g.W),
      static_cast<const T*>(g.XV), static_cast<const T*>(g.XK),
      static_cast<T*>(g.part), g.nr, g.n, g.m, g.BV, v0, nv, g.BK, k0, nk,
      cols_per_split, static_cast<T>(g.wall_position), g.wall_axis);
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

// The widths (bv, bk) of the instantiation that serves columns [c0, c0 + BW)
// of a (BV, BK) batch: narrow batches have their own, a chunk with no column
// of V or none of K the one-sided wide one.
void chunk_widths(int64_t BV, int64_t BK, int64_t c0, int* bv, int* bk) {
  if (BV <= 1 && BK <= 1) {
    *bv = static_cast<int>(BV);
    *bk = static_cast<int>(BK);
    return;
  }
  *bv = c0 < BV ? BW : 0;
  *bk = c0 < BK ? BW : 0;
}

template <typename T, int KIND>
int launch_batches(const Args& g) {
  if (g.BV <= 1 && g.BK <= 1) {
    if (g.BK == 0) return launch_chunk<T, KIND, 1, 0>(g, 0, 1, 0, 0);
    if (g.BV == 0) return launch_chunk<T, KIND, 0, 1>(g, 0, 0, 0, 1);
    return launch_chunk<T, KIND, 1, 1>(g, 0, 1, 0, 1);
  }
  for (int64_t c0 = 0; c0 < g.BV || c0 < g.BK; c0 += BW) {
    const int64_t lv = g.BV - c0, lk = g.BK - c0;
    const int nv = static_cast<int>(lv < 0 ? 0 : lv < BW ? lv : BW);
    const int nk = static_cast<int>(lk < 0 ? 0 : lk < BW ? lk : BW);
    int rc;
    if (nk == 0) {
      rc = launch_chunk<T, KIND, BW, 0>(g, c0, nv, c0, 0);
    } else if (nv == 0) {
      rc = launch_chunk<T, KIND, 0, BW>(g, c0, 0, c0, nk);
    } else {
      rc = launch_chunk<T, KIND, BW, BW>(g, c0, nv, c0, nk);
    }
    if (rc != 0) return rc;
  }
  return 0;
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
int launch(const Args& g, int kind) {
  if (g.nr <= 0 || g.n <= 0 || (g.BV <= 0 && g.BK <= 0))
    return static_cast<int>(cudaGetLastError());
  if (kind == FREE_SPACE) return launch_batches<T, FREE_SPACE>(g);
  if (g.wall_axis < 0 || g.wall_axis > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (kind == FREE_SURFACE) return launch_batches<T, FREE_SURFACE>(g);
  if (kind == NO_SLIP) return launch_batches<T, NO_SLIP>(g);
  return static_cast<int>(cudaErrorInvalidValue);
}

Args make_args(const void* xi, const void* Y, const void* N, const void* W,
               const void* XV, const void* XK, void* OV, void* OK, void* part,
               int64_t nr, int64_t n, int64_t m, int64_t BV, int64_t BK, int kind,
               int wall_axis, double wall_position, void* stream) {
  // the free-space kernel never reads the wall: its coordinates stay as
  // they are
  return Args{xi, Y,  N, W,  XV, XK, OV, OK, part,
              nr, n,  m, BV, BK, splits_for(nr, n), wall_position,
              kind == FREE_SPACE ? 2 : wall_axis,
              static_cast<cudaStream_t>(stream)};
}

}  // namespace

extern "C" {

// The values of scratch a sweep needs: its partial sums, one set per split
// of the column nodes, as wide as the widest instantiation the batch goes
// through (a function of the shapes and the current device's SM count
// alone).
int64_t sweep_matvec_part_elems(int64_t nr, int64_t n, int64_t BV, int64_t BK) {
  int width = 0;
  for (int64_t c0 = 0; c0 == 0 || c0 < BV || c0 < BK; c0 += BW) {
    int bv, bk;
    chunk_widths(BV, BK, c0, &bv, &bk);
    if (bv + bk > width) width = bv + bk;
  }
  return splits_for(nr, n) * 3 * nr * width;
}

int sweep_matvec_f32(const void* xi, const void* Y, const void* N,
                     const void* W, const void* XV, const void* XK, void* OV,
                     void* OK, void* part, int64_t nr, int64_t n, int64_t m,
                     int64_t BV, int64_t BK, int kind, int wall_axis,
                     double wall_position, void* stream) {
  return launch<float>(make_args(xi, Y, N, W, XV, XK, OV, OK, part, nr, n, m, BV, BK,
                                 kind, wall_axis, wall_position, stream),
                       kind);
}

int sweep_matvec_f64(const void* xi, const void* Y, const void* N,
                     const void* W, const void* XV, const void* XK, void* OV,
                     void* OK, void* part, int64_t nr, int64_t n, int64_t m,
                     int64_t BV, int64_t BK, int kind, int wall_axis,
                     double wall_position, void* stream) {
  return launch<double>(make_args(xi, Y, N, W, XV, XK, OV, OK, part, nr, n, m, BV, BK,
                                  kind, wall_axis, wall_position, stream),
                        kind);
}

// y[k] = rsqrt_pos(x[k]): the f64 inverse square root of the sweep alone,
// for the tests that hold it against 1 / sqrt.
__global__ void rsqrt_pos_kernel(const double* __restrict__ x, double* __restrict__ y,
                                 int64_t n) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (k < n) y[k] = node_sweep::rsqrt_pos(x[k]);
}

int sweep_matvec_rsqrt_f64(const void* x, void* y, int64_t n, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  rsqrt_pos_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(y), n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
