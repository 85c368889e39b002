// K6: the panel-centric slot kernel of the "gather" assembly, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel bemstokes_tpu/ops/pallas_assemble.py:45
// `_kernel` (launched through `pallas_tile_slots`, `:114`).  Its plain torch
// version is `tile_slots_reference` in
// bemstokes_tpu_torch/ops/slot_kernel.py.
//
// What it computes.  For every collocation row t (point xi[t]) and panel c,
// over the panel's nq quadrature points (points xq[c, q], unit normals
// nrm[c, q]) and for each of its nl local nodes l (weights wphi[c, q, l] =
// JxW * phi_l), with R = xq[c, q] - xi[t] and r = |R|:
//
//   V[c*nl + l, 3a + b, t] =  keep[c, t] sum_q wphi (delta_ab / r + R_a R_b / r^3) / (8 pi)
//   K[c*nl + l, 3a + b, t] = -keep[c, t] sum_q wphi (-3 / (4 pi)) (R . n) R_a R_b / r^5
//
// The Green's functions are evaluated once per (row, panel quadrature
// point) and shared by the panel's nl local nodes; the node sweep K1
// evaluates them once per (row, column-node sample), nl times as often.
// keep[c, t] = 0 marks a row node on one of its own panels (the singular
// rule handles those pairs): such a pair can have R = 0 exactly, so it takes
// the dummy offset R = (1, 1, 1), as the TPU kernel does
// (pallas_assemble.py:64-69), and `keep` multiplies the sums after the
// contraction over q.  An incidence gather-reduce outside the kernel maps
// slot (c, l) to its node column.
//
// What bounds it.  The stores.  At the 6,146-node sphere (6,144 panels,
// nq = 16, nl = 4) one assembly evaluates 6146 * 6144 * 16 = 6.04e8 pairs,
// a quarter of K1's, but writes 2 * 24,576 * 9 * 6,146 * 8 B = 21.75 GB of
// f64 slots, against 5.4 GB for the dense operators: at the card's memory
// rate the stores take longer than the arithmetic does at its FP64 rate.
//
// What the design does about it.  The row index t is the fastest axis of
// the output, so consecutive threads take consecutive rows: every store of
// a warp is one contiguous segment, written once, by the one thread that
// owns (c, l, t) — no atomics, the same bits on every run.  A thread holds
// the 12 sums (6 of V, 6 of K: both 3x3 blocks are symmetric) of LB local
// nodes in registers, 48 for LB = 4; elements with more local nodes (Q2:
// nl = 9) take ceil(nl / LB) passes over the panel's points and evaluate the
// Green's functions once a pass, which keeps the registers of a thread below
// the spill.  A panel's points, normals and weights are the same address
// for every thread of a block, so they are read through the read-only cache
// and broadcast; nothing is staged in shared memory.  Not carried over from
// the TPU kernel: the SoA transposes, the C * nq chunk planes, the MXU
// contraction, the [C * nl * 9, T] block.  No tensor cores, TMA or wgmma.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous and of
// one type T (float or double):
//   xi [nt, 3], xq [nc, nq, 3], nrm [nc, nq, 3], wphi [nc, nq, nl],
//   keep [nc, nt]; V, K [nc * nl, 9, nt] (out).
// Launches on `stream`, does not synchronise, and returns cudaGetLastError().

#include "node_sweep_common.cuh"

namespace {

using node_sweep::dot3_rn;
using node_sweep::rsqrt_t;
using node_sweep::ut;

constexpr int TT = 128;  // rows per block (threadIdx.x)
constexpr int PB = 4;    // panels per block, walked in turn

template <typename T, int LB>
__global__ void __launch_bounds__(TT)
    tile_slots_kernel(const T* __restrict__ xi, const T* __restrict__ xq,
                      const T* __restrict__ nrm, const T* __restrict__ wphi,
                      const T* __restrict__ keep, T* __restrict__ V,
                      T* __restrict__ K, int64_t nt, int64_t nc, int nq,
                      int nl) {
  const T cG = static_cast<T>(1.0 / (8.0 * 3.14159265358979323846));
  const T cW = static_cast<T>(-3.0 / (4.0 * 3.14159265358979323846));

  const int64_t t = static_cast<int64_t>(blockIdx.y) * TT + threadIdx.x;
  if (t >= nt) return;
  const T x0 = xi[t * 3 + 0], x1 = xi[t * 3 + 1], x2 = xi[t * 3 + 2];

  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * PB;
  for (int p = 0; p < PB; ++p) {
    const int64_t c = c0 + p;
    if (c >= nc) break;
    const T kp = keep[c * nt + t];
    const bool masked = !(kp > T(0));
    const T* __restrict__ yq = xq + c * nq * 3;
    const T* __restrict__ nn = nrm + c * nq * 3;
    const T* __restrict__ wp = wphi + c * nq * nl;

    for (int l0 = 0; l0 < nl; l0 += LB) {
      T v[LB][6], k[LB][6];
#pragma unroll
      for (int j = 0; j < LB; ++j) {
#pragma unroll
        for (int s = 0; s < 6; ++s) v[j][s] = k[j][s] = T(0);
      }

      for (int q = 0; q < nq; ++q) {
        const T R0 = masked ? T(1) : __ldg(yq + q * 3 + 0) - x0;
        const T R1 = masked ? T(1) : __ldg(yq + q * 3 + 1) - x1;
        const T R2 = masked ? T(1) : __ldg(yq + q * 3 + 2) - x2;
        const T r2 = dot3_rn(R0, R1, R2, R0, R1, R2);
        const T invR = rsqrt_t(r2);
        const T invR2 = invR * invR;
        const T invR3 = invR2 * invR;
        // W.n = (cW R_a R_b) (R.n / r^5), r^-5 = r^-1 (r^-2)^2: the plain
        // version's rounding steps
        const T tw = dot3_rn(R0, R1, R2, __ldg(nn + q * 3 + 0),
                             __ldg(nn + q * 3 + 1), __ldg(nn + q * 3 + 2)) *
                     (invR * (invR2 * invR2));
        const T d[6] = {R0 * R0, R0 * R1, R0 * R2, R1 * R1, R1 * R2, R2 * R2};
        T g[6], w[6];
#pragma unroll
        for (int s = 0; s < 6; ++s) {
          // slots 0, 3, 5 are the diagonal (0,0), (1,1), (2,2)
          const T dy = d[s] * invR3;
          g[s] = cG * ((s == 0 || s == 3 || s == 5) ? dy + invR : dy);
          w[s] = (cW * d[s]) * tw;
        }
#pragma unroll
        for (int j = 0; j < LB; ++j) {
          const int l = l0 + j;
          const T wl = l < nl ? __ldg(wp + q * nl + l) : T(0);
#pragma unroll
          for (int s = 0; s < 6; ++s) {
            v[j][s] += wl * g[s];
            k[j][s] += wl * w[s];
          }
        }
      }

#pragma unroll
      for (int j = 0; j < LB; ++j) {
        const int l = l0 + j;
        if (l >= nl) break;
        const int64_t base = (c * nl + l) * 9 * nt + t;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
#pragma unroll
          for (int b = 0; b < 3; ++b) {
            V[base + (3 * a + b) * nt] = v[j][ut(a, b)] * kp;
            // minus sign: exterior problem (reference `:2941-2947`)
            K[base + (3 * a + b) * nt] = -(k[j][ut(a, b)] * kp);
          }
        }
      }
    }
  }
}

template <typename T>
int launch(const T* xi, const T* xq, const T* nrm, const T* wphi,
           const T* keep, T* V, T* K, int64_t nt, int64_t nc, int nq, int nl,
           void* stream) {
  if (nt <= 0 || nc <= 0 || nl <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 block(TT);
  const dim3 grid(static_cast<unsigned>((nc + PB - 1) / PB),
                  static_cast<unsigned>((nt + TT - 1) / TT));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // local nodes per pass: 3 where that divides nl with no idle slot in the
  // last pass (Q2: 9 = 3 x 3), else 4 (Q1: one pass)
  if (nl > 4 && nl % 3 == 0) {
    tile_slots_kernel<T, 3>
        <<<grid, block, 0, s>>>(xi, xq, nrm, wphi, keep, V, K, nt, nc, nq, nl);
  } else {
    tile_slots_kernel<T, 4>
        <<<grid, block, 0, s>>>(xi, xq, nrm, wphi, keep, V, K, nt, nc, nq, nl);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int tile_slots_f32(const void* xi, const void* xq, const void* nrm,
                   const void* wphi, const void* keep, void* V, void* K,
                   int64_t nt, int64_t nc, int nq, int nl, void* stream) {
  return launch(static_cast<const float*>(xi), static_cast<const float*>(xq),
                static_cast<const float*>(nrm),
                static_cast<const float*>(wphi),
                static_cast<const float*>(keep), static_cast<float*>(V),
                static_cast<float*>(K), nt, nc, nq, nl, stream);
}

int tile_slots_f64(const void* xi, const void* xq, const void* nrm,
                   const void* wphi, const void* keep, void* V, void* K,
                   int64_t nt, int64_t nc, int nq, int nl, void* stream) {
  return launch(static_cast<const double*>(xi), static_cast<const double*>(xq),
                static_cast<const double*>(nrm),
                static_cast<const double*>(wphi),
                static_cast<const double*>(keep), static_cast<double*>(V),
                static_cast<double*>(K), nt, nc, nq, nl, stream);
}

}  // extern "C"
