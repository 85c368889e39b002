// K6: the panel-centric slot kernel of the "gather" assembly, for Hopper
// (sm_90a), with two entry points: `tile_slots`, the slot tensors the TPU
// kernel returns, and `tile_nodes`, the node columns those slots reduce to,
// which is what the gather assembly calls.
//
// Replaces the Pallas TPU kernel bemstokes_tpu/ops/pallas_assemble.py:45
// `_kernel` (launched through `pallas_tile_slots`, `:114`).  The plain torch
// versions are `tile_slots_reference` and `tile_nodes_reference` in
// bemstokes_tpu_torch/ops/slot_kernel.py.
//
// tile_slots.  What it computes.  For every collocation row t (point xi[t]) and panel c,
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
// tile_nodes: the same Green's functions summed into the node columns
// inside the kernel, the entry point of the gather assembly.
//
//   V[j, 3a + b, t] = sum over the slots (c, l) of node j of V_slots[c*nl + l, 3a + b, t]
//
// and K likewise: what `gather_reduce` (bemstokes_tpu_torch/ops/slot_kernel.py)
// makes of the slot tensors, without them.  The slots were 4 times the node
// columns at nl = 4 (21.75 GB a create_sphere(5) bulk in f64, stored and
// read back by the gather-reduce); the node columns are what the assembly
// keeps (5.4 GB), and the bound becomes the arithmetic.
//
// Owner computes, over node groups.  The nodes are cut into groups of ~32
// (sorted by their lowest incident panel, so that a group's panels lie
// together); a block takes 32 rows (one a lane) and one group, and holds the
// group's 12 sums a (row, node) in shared memory: 6 of V and 6 of K, both
// blocks symmetric, 96 KiB in f64 for 32 nodes (110 KiB with the panel
// buffers and round tables below), so two blocks share an SM.
// Its warps walk the union of the panels incident to the group's nodes, one
// panel a warp, in rounds laid out on the host (`node_groups`): no two
// panels of a round share a node of the group, so each warp adds its
// panel's slots of the group's nodes straight into the accumulators without
// atomics, a barrier between rounds, and every accumulator takes its terms
// in the schedule's order: the same bits on every run.  Slots of nodes
// outside the group are dropped (another block owns them); a panel's
// Green's functions are evaluated once per group whose nodes it touches, ~1.5
// times per panel at 32 nodes a group (Q1).  With 8 warps an SM nothing
// hides memory latency: a warp that read its panel's points, normals and
// weights from global memory a point at a time, behind a chain of dependent
// loads of the round's tables, would wait on memory, not on arithmetic.  So
// a block copies its group's round tables into shared memory once, and each
// warp copies its next round's panel into a second shared buffer with
// cp.async while it computes the current one; all lanes of a warp then read
// the same panel from shared memory, broadcast.  The own-cell mask is an
// integer test of the row's node against the panel's nodes (the pair is
// skipped: it can have R = 0).  The arithmetic is that of the node sweeps:
// r^2 by FMAs, `rsqrt_pos`, K's factor (R.N / r^2) / r^3 with R.N rounded
// to nearest, the constants 1/8pi and 3/4pi applied at the store.  Q2
// elements take passes of 3 local nodes, and a pass whose nodes all lie
// outside the group is skipped.
//
// Interface: plain C, loaded with ctypes.  All arrays are contiguous; the
// floating ones of one type T (float or double), the tables int32:
//   tile_slots: xi [nt, 3], xq [nc, nq, 3], nrm [nc, nq, 3],
//     wphi [nc, nq, nl], keep [nc, nt]; V, K [nc * nl, 9, nt] (out).
//   tile_nodes: xi, xq, nrm, wphi as above, row_ids [nt] (the node of each
//     row), cells [nc, nl] (each panel's nodes), node_ptr [G + 1],
//     nodes [n], round_ptr [G + 1], round_panel [R, NODE_WARPS],
//     round_place [R, NODE_WARPS, nl] (ops/slot_kernel.py `NodeGroups`);
//     V, K [n, 9, nt] (out); group_max the largest group, round_max the
//     most rounds a group has.  A round holds NODE_WARPS panels, the
//     NODE_GROUP_WARPS of ops/slot_kernel.py.
// Launch on `stream`, do not synchronise, and return cudaGetLastError().

#include "node_sweep_common.cuh"

namespace {

using node_sweep::dot3_rn;
using node_sweep::rsqrt_pos;
using node_sweep::rsqrt_t;
using node_sweep::ut;

constexpr int TT = 128;  // rows per block (threadIdx.x)
constexpr int PB = 4;    // panels per block, walked in turn

// tile_nodes' block: NODE_ROWS rows (threadIdx.x) by NODE_WARPS warps
// (threadIdx.y), one panel of a round a warp.  The off-card check of the
// arithmetic cuts it to one row (tests/test_torch_node_sweep_emulation.py).
#ifndef TILE_NODES_ROWS
#define TILE_NODES_ROWS 32
#endif
constexpr int NODE_ROWS = TILE_NODES_ROWS;
constexpr int NODE_WARPS = 4;
constexpr int SUMS = 12;  // a (row, node)'s accumulators: 6 of V, 6 of K

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

// The sums of LB local nodes l0 .. l0 + LB - 1 of one panel (points yq,
// normals nn [nq, 3], weights wp [nq, nl], staged in shared memory) seen
// from the row point x: V's sum_q w_l (delta_ab / r + R_a R_b / r^3) and K's
// sum_q w_l (R.N) R_a R_b / r^5 in the symmetric slots ut(a, b), without the
// constants.  EXACT: LB divides nl, so no weight of the pass lies past the
// panel's nodes.  Points a trip: two in f64, one in f32 (each the faster on
// the card, PERF.md).
template <typename T, int LB, bool EXACT>
__device__ __forceinline__ void panel_sums(T x0, T x1, T x2, const T* yq, const T* nn, const T* wp,
                                           int nq, int nl, int l0, T (&v)[LB][6], T (&k)[LB][6]) {
#pragma unroll
  for (int j = 0; j < LB; ++j) {
#pragma unroll
    for (int s = 0; s < 6; ++s) v[j][s] = k[j][s] = T(0);
  }
  constexpr int Q_UNROLL = node_sweep::unroll<T>(2, 1);
#pragma unroll Q_UNROLL
  for (int q = 0; q < nq; ++q) {
    const T R0 = yq[q * 3 + 0] - x0;
    const T R1 = yq[q * 3 + 1] - x1;
    const T R2 = yq[q * 3 + 2] - x2;
    const T r2 = fma(R2, R2, fma(R1, R1, R0 * R0));
    const T iR = rsqrt_pos(r2), iR2 = iR * iR, iR3 = iR2 * iR;
    // (R.N / r^2) / r^3, R.N rounded as the plain version rounds it
    const T kf = (dot3_rn(R0, R1, R2, nn[q * 3 + 0], nn[q * 3 + 1], nn[q * 3 + 2]) * iR2) * iR3;
    const T d[6] = {R0 * R0, R0 * R1, R0 * R2, R1 * R1, R1 * R2, R2 * R2};
    T g[6], w[6];
#pragma unroll
    for (int s = 0; s < 6; ++s) {
      // slots 0, 3, 5 are the diagonal (0,0), (1,1), (2,2)
      g[s] = (s == 0 || s == 3 || s == 5) ? fma(d[s], iR3, iR) : d[s] * iR3;
      w[s] = d[s] * kf;
    }
#pragma unroll
    for (int j = 0; j < LB; ++j) {
      const T wl = EXACT || l0 + j < nl ? wp[q * nl + l0 + j] : T(0);
#pragma unroll
      for (int s = 0; s < 6; ++s) {
        v[j][s] = fma(wl, g[s], v[j][s]);
        k[j][s] = fma(wl, w[s], k[j][s]);
      }
    }
  }
}

// The block's dynamic shared memory.
__device__ __forceinline__ unsigned char* shared_bytes() {
#ifdef NODE_SWEEP_HOST_EMULATION
  return static_cast<unsigned char*>(node_sweep_host_shared());  // off-card check
#else
  extern __shared__ __align__(16) unsigned char smem[];
  return smem;
#endif
}

// Copy one element from global to shared memory without waiting for it
// (cp.async); `copies_wait<N>` waits until at most N of the thread's
// committed groups of copies are in flight.
template <typename T>
__device__ __forceinline__ void copy_async(T* dst, const T* src) {
#ifdef NODE_SWEEP_HOST_EMULATION
  *dst = *src;
#else
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(sizeof(T)) : "memory");
#endif
}
__device__ __forceinline__ void copies_commit() {
#ifndef NODE_SWEEP_HOST_EMULATION
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
__device__ __forceinline__ void copies_wait() {
#ifndef NODE_SWEEP_HOST_EMULATION
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Shared memory of a tile_nodes block, in bytes: the accumulators
// [group_max][SUMS][NODE_ROWS], two stages of one panel a warp (points and
// normals [nq][3], weights [nq][nl]), and the group's round tables (each
// slot's panel, and its local nodes' places and nodes).
template <typename T>
__host__ __device__ __forceinline__ size_t node_smem(int group_max, int round_max, int nq, int nl) {
  return static_cast<size_t>(group_max) * SUMS * NODE_ROWS * sizeof(T) +
         static_cast<size_t>(2 * NODE_WARPS) * nq * (6 + nl) * sizeof(T) +
         static_cast<size_t>(round_max) * NODE_WARPS * (1 + 2 * nl) * sizeof(int);
}

template <typename T, int LB, bool EXACT>
__global__ void __launch_bounds__(NODE_ROWS* NODE_WARPS)
    tile_nodes_kernel(const T* __restrict__ xi, const T* __restrict__ xq,
                      const T* __restrict__ nrm, const T* __restrict__ wphi,
                      const int* __restrict__ row_ids, const int* __restrict__ cells,
                      const int* __restrict__ node_ptr, const int* __restrict__ nodes,
                      const int* __restrict__ round_ptr, const int* __restrict__ round_panel,
                      const int* __restrict__ round_place, T* __restrict__ V,
                      T* __restrict__ K, int64_t nt, int nq, int nl, int group_max) {
  const int tr = threadIdx.x;
  const int wp = threadIdx.y;
  const int tid = wp * NODE_ROWS + tr;
  const int g = blockIdx.x;
  const int64_t t = static_cast<int64_t>(blockIdx.y) * NODE_ROWS + tr;
  const bool row_ok = t < nt;
  const int n0 = node_ptr[g];
  const int gn = node_ptr[g + 1] - n0;
  const int r0 = round_ptr[g];
  const int rounds = round_ptr[g + 1] - r0;
  const int per_panel = nq * (6 + nl);

  T* acc = reinterpret_cast<T*>(shared_bytes());
  T* stage = acc + static_cast<size_t>(group_max) * SUMS * NODE_ROWS;  // [2][NODE_WARPS][per_panel]
  int* panel_of = reinterpret_cast<int*>(stage + 2 * NODE_WARPS * per_panel);  // [rounds][NODE_WARPS]
  int* place_of = panel_of + rounds * NODE_WARPS;  // [rounds][NODE_WARPS][nl]
  int* node_of = place_of + rounds * NODE_WARPS * nl;  // [rounds][NODE_WARPS][nl]

  // this warp's panel of round k into stage buffer k & 1
  auto stage_panel = [&](int k) {
    const int c = panel_of[k * NODE_WARPS + wp];
    if (c < 0) return;
    T* dst = stage + ((k & 1) * NODE_WARPS + wp) * per_panel;
    for (int i = tr; i < nq * 3; i += NODE_ROWS) {
      copy_async(dst + i, xq + static_cast<int64_t>(c) * nq * 3 + i);
      copy_async(dst + nq * 3 + i, nrm + static_cast<int64_t>(c) * nq * 3 + i);
    }
    for (int i = tr; i < nq * nl; i += NODE_ROWS)
      copy_async(dst + nq * 6 + i, wphi + static_cast<int64_t>(c) * nq * nl + i);
  };

  for (int e = tid; e < gn * SUMS * NODE_ROWS; e += NODE_ROWS * NODE_WARPS) acc[e] = T(0);
  for (int e = tid; e < rounds * NODE_WARPS; e += NODE_ROWS * NODE_WARPS)
    panel_of[e] = round_panel[static_cast<int64_t>(r0) * NODE_WARPS + e];
  for (int e = tid; e < rounds * NODE_WARPS * nl; e += NODE_ROWS * NODE_WARPS) {
    place_of[e] = round_place[static_cast<int64_t>(r0) * NODE_WARPS * nl + e];
    const int c = round_panel[static_cast<int64_t>(r0) * NODE_WARPS + e / nl];
    node_of[e] = c < 0 ? -1 : cells[static_cast<int64_t>(c) * nl + e % nl];
  }
  T x0 = T(0), x1 = T(0), x2 = T(0);
  int id = -1;
  if (row_ok) {
    x0 = xi[t * 3 + 0];
    x1 = xi[t * 3 + 1];
    x2 = xi[t * 3 + 2];
    id = row_ids[t];
  }
  __syncthreads();

  if (rounds > 0) stage_panel(0);
  copies_commit();
  for (int k = 0; k < rounds; ++k) {
    // the next round's panel loads while this one computes
    if (k + 1 < rounds) stage_panel(k + 1);
    copies_commit();
    copies_wait<1>();
    __syncwarp();
    const int slot = k * NODE_WARPS + wp;
    bool skip = panel_of[slot] < 0 || !row_ok;
    // own cell: the row's node is a node of the panel (the singular rule's)
    for (int l = 0; l < nl && !skip; ++l) skip = node_of[slot * nl + l] == id;
    if (!skip) {
      const int* place = place_of + slot * nl;
      const T* yq = stage + ((k & 1) * NODE_WARPS + wp) * per_panel;
      for (int l0 = 0; l0 < nl; l0 += LB) {
        bool any = false;
#pragma unroll
        for (int j = 0; j < LB; ++j) any = any || (l0 + j < nl && place[l0 + j] >= 0);
        if (!any) continue;  // every node of the pass lies outside the group
        T v[LB][6], k6[LB][6];
        panel_sums<T, LB, EXACT>(x0, x1, x2, yq, yq + nq * 3, yq + nq * 6, nq, nl, l0, v, k6);
#pragma unroll
        for (int j = 0; j < LB; ++j) {
          const int p = l0 + j < nl ? place[l0 + j] : -1;
          if (p < 0) continue;
          T* a = acc + p * SUMS * NODE_ROWS + tr;
#pragma unroll
          for (int s = 0; s < 6; ++s) {
            a[s * NODE_ROWS] += v[j][s];
            a[(6 + s) * NODE_ROWS] += k6[j][s];
          }
        }
      }
    }
    // the accumulators take the rounds in order; the stage buffer is free
    __syncthreads();
  }

  if (!row_ok) return;
  const T cG = static_cast<T>(1.0 / (8.0 * 3.14159265358979323846));
  // -(-3 / 4pi): W.n's constant, negated for the exterior problem
  // (reference `:2941-2947`)
  const T cK = static_cast<T>(3.0 / (4.0 * 3.14159265358979323846));
  for (int p = wp; p < gn; p += NODE_WARPS) {
    const int64_t base = static_cast<int64_t>(nodes[n0 + p]) * 9 * nt + t;
    const T* a = acc + p * SUMS * NODE_ROWS + tr;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      const int s = ut(e / 3, e % 3);
      V[base + e * nt] = cG * a[s * NODE_ROWS];
      K[base + e * nt] = cK * a[(6 + s) * NODE_ROWS];
    }
  }
}

template <typename T, int LB, bool EXACT>
int launch_nodes_lb(const T* xi, const T* xq, const T* nrm, const T* wphi, const int* row_ids,
                    const int* cells, const int* node_ptr, const int* nodes,
                    const int* round_ptr, const int* round_panel, const int* round_place,
                    T* V, T* K, int64_t nt, int nq, int nl, int64_t n_groups, int group_max,
                    int round_max, cudaStream_t stream) {
  const size_t smem = node_smem<T>(group_max, round_max, nq, nl);
  auto kernel = tile_nodes_kernel<T, LB, EXACT>;
  cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  // all of the SM's unified memory as shared memory: two f64 blocks of
  // 110 KiB fit
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(NODE_ROWS, NODE_WARPS);
  const dim3 grid(static_cast<unsigned>(n_groups), static_cast<unsigned>((nt + NODE_ROWS - 1) / NODE_ROWS));
  kernel<<<grid, block, smem, stream>>>(xi, xq, nrm, wphi, row_ids, cells, node_ptr, nodes, round_ptr,
                                        round_panel, round_place, V, K, nt, nq, nl, group_max);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_nodes(const void* xi, const void* xq, const void* nrm, const void* wphi,
                 const void* row_ids, const void* cells, const void* node_ptr, const void* nodes,
                 const void* round_ptr, const void* round_panel, const void* round_place, void* V,
                 void* K, int64_t nt, int64_t nc, int nq, int nl, int64_t n_groups, int group_max,
                 int round_max, void* stream) {
  if (n_groups > 0x7fffffff || (nt + NODE_ROWS - 1) / NODE_ROWS > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (nt <= 0 || nc <= 0 || nl <= 0 || n_groups <= 0) return static_cast<int>(cudaGetLastError());
  const T* xi_ = static_cast<const T*>(xi);
  const T* xq_ = static_cast<const T*>(xq);
  const T* nrm_ = static_cast<const T*>(nrm);
  const T* wphi_ = static_cast<const T*>(wphi);
  const int* ids = static_cast<const int*>(row_ids);
  const int* cells_ = static_cast<const int*>(cells);
  const int* np_ = static_cast<const int*>(node_ptr);
  const int* nodes_ = static_cast<const int*>(nodes);
  const int* rp = static_cast<const int*>(round_ptr);
  const int* rpan = static_cast<const int*>(round_panel);
  const int* rpl = static_cast<const int*>(round_place);
  T* V_ = static_cast<T*>(V);
  T* K_ = static_cast<T*>(K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // local nodes per pass as in tile_slots: 3 for Q2 (nl = 9), else 4
  if (nl > 4 && nl % 3 == 0)
    return launch_nodes_lb<T, 3, true>(xi_, xq_, nrm_, wphi_, ids, cells_, np_, nodes_, rp, rpan, rpl, V_,
                                       K_, nt, nq, nl, n_groups, group_max, round_max, s);
  if (nl % 4 == 0)
    return launch_nodes_lb<T, 4, true>(xi_, xq_, nrm_, wphi_, ids, cells_, np_, nodes_, rp, rpan, rpl, V_,
                                       K_, nt, nq, nl, n_groups, group_max, round_max, s);
  return launch_nodes_lb<T, 4, false>(xi_, xq_, nrm_, wphi_, ids, cells_, np_, nodes_, rp, rpan, rpl, V_, K_,
                                      nt, nq, nl, n_groups, group_max, round_max, s);
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

int tile_nodes_f32(const void* xi, const void* xq, const void* nrm, const void* wphi,
                   const void* row_ids, const void* cells, const void* node_ptr,
                   const void* nodes, const void* round_ptr, const void* round_panel,
                   const void* round_place, void* V, void* K, int64_t nt, int64_t nc, int nq,
                   int nl, int64_t n_groups, int group_max, int round_max, void* stream) {
  return launch_nodes<float>(xi, xq, nrm, wphi, row_ids, cells, node_ptr, nodes, round_ptr,
                             round_panel, round_place, V, K, nt, nc, nq, nl, n_groups, group_max,
                             round_max, stream);
}

int tile_nodes_f64(const void* xi, const void* xq, const void* nrm, const void* wphi,
                   const void* row_ids, const void* cells, const void* node_ptr,
                   const void* nodes, const void* round_ptr, const void* round_panel,
                   const void* round_place, void* V, void* K, int64_t nt, int64_t nc, int nq,
                   int nl, int64_t n_groups, int group_max, int round_max, void* stream) {
  return launch_nodes<double>(xi, xq, nrm, wphi, row_ids, cells, node_ptr, nodes, round_ptr,
                              round_panel, round_place, V, K, nt, nc, nq, nl, n_groups, group_max,
                              round_max, stream);
}

}  // extern "C"
