// The stale LU's apply for one right-hand side: forward substitution with
// the unit-lower L, then back substitution with U, one launch a triangle.
// The forward launch gathers b by the row permutation kept from the
// factorization as it reads it, where it is given one.  Two layouts of the
// factor, each read where it lies: column-major, entry (i, j) at i + j n (the
// factor torch.linalg.lu_factor returns), and row-major, entry (i, j) at
// i ld + j with ld >= n (a rank's diagonal block of the distributed slab LU,
// whose rows are [m, W m], ld = W m).  The column-major instantiation keeps
// n as its stride: a leading dimension of its own would cost it instructions,
// and no caller has such a factor.
//
// It replaces no TPU kernel: the JAX package solves with XLA's triangular
// solve.  It was added because cuBLAS's trsv, which the port called before
// (la/direct.py lu_apply), streamed each 2.13 GB triangle at 23,101 unknowns
// at 38-46 % of the card's bandwidth.
//
// Bound: bytes.  A triangle of n^2 / 2 values is read once, two flops a
// value: 0.64 ms a triangle at 23,101 unknowns in f64 at 3.35 TB/s, 0.406 ms
// at a slab's m = 18,435 (either layout).  Beside it runs a chain of
// N = ceil(n / TB) dependent steps, one a block row (289 at m = 18,435), each
// a hand-over between SMs: it, not the bytes, bounds small or f32 factors.
//
// Design.  The triangle is cut into TB x TB tiles; a tile column (column-
// major) or a tile row (row-major) is TB contiguous values.  Block row R
// (step s = R forward, s = N - 1 - R backward) needs the off-diagonal tiles of the steps before it and its
// diagonal block, whose inverse D^-1 the wrapper computes once a
// factorization (`dinv`), with M = D^-1 times the tile of the step just
// before (`coupling`).  The work items of a step: segments of SEG tiles
// over its older tiles, each publishing a partial product, then the owner:
// it streams the rest of the step's OWNER newest tiles, adds the
// partials, takes z = D^-1 (b - all but the newest tile's product) before
// the previous step is solved, and then only x = z - M x_{s-1}: the chain
// from one step to the next is one poll and one TB x TB product from
// shared memory.  (A second coupling tile, to take z before the step
// before the previous one, made the owner wait longer than it saved.)
// Persistent
// blocks take items from a global ticket in that order, so a block waits
// only on items that blocks before it already hold (no deadlock, whatever
// the grid).  A warp loads its next tile into registers before it waits
// for the solution values that tile multiplies: a tile's bytes do not
// depend on x.  Each published value (a solution entry, a partial sum)
// travels with the launch number in one 16-byte (8-byte in f32) word, so a
// reader polls the value itself: no flag, fence or second read on the
// chain, and nothing to clear between launches; the ticket counter only
// grows, each launch from its `base`.  Sums are taken in a fixed order: the
// bits do not depend on which block took which item.
//
// The layouts differ only in how a warp reads a tile (ROW, a template
// parameter).  Column-major: a warp reads tile columns, its lanes down the
// rows, and sums each row's products in its registers.  Row-major: a warp
// reads tile rows, its lanes along the columns (256-byte runs of a row in
// f64), keeps one sum a row it reads over all the tiles of its sweep, and
// adds them across its lanes once, at the sweep's end, by shuffles; from
// there both go through the same block sums, partials and chain.  The
// row-major stream runs with one block an SM (the wrapper's grid): with two
// it is slower, for no cause found (m = 18,435, f64, ld = 4 m: 0.66 ms a
// triangle against 0.75; polling the solution one word a warp, 16 or 64
// tiles a segment, a second tile in flight, more registers and other cache
// hints for the tile loads changed it by under 5 %), where the
// column-major stream gains from the second block (0.61 against 0.63 ms).
//
// The words are read and written by relaxed gpu-scope accesses in inline
// PTX (volatile: a poll is never hoisted out of its loop).  In f32 a word
// is one 64-bit scalar access, indivisible under the PTX memory model.  In
// f64 it is one aligned 16-byte vector access, which the model describes as
// two element accesses; the scheme relies on the hardware performing an
// aligned 16-byte access as one, as CUB's decoupled look-back does with its
// 16-byte (status, value) words.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TB = 64;                  // tile edge
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = TB / WARPS;        // tile columns a warp reads
constexpr int SEG = 32;                 // older tiles a segment item streams
constexpr int OWNER = 3;                // a step's newest tiles, its owner's own

// a value and the launch that wrote it, read and written as one word
template <typename T>
struct Tagged;
template <>
struct Tagged<double> {
  using Word = double2;
  static __device__ __forceinline__ Word make(double v, unsigned tag) {
    return double2{v, __longlong_as_double(static_cast<long long>(tag))};
  }
  static __device__ __forceinline__ unsigned tag(Word w) { return static_cast<unsigned>(__double_as_longlong(w.y)); }
};
template <>
struct Tagged<float> {
  using Word = float2;
  static __device__ __forceinline__ Word make(float v, unsigned tag) {
    return float2{v, __int_as_float(static_cast<int>(tag))};
  }
  static __device__ __forceinline__ unsigned tag(Word w) { return static_cast<unsigned>(__float_as_int(w.y)); }
};

template <typename T>
struct Args {
  const T* lu;          // [n, n]: entry (i, j) at i + j n (column-major) or i ld + j (row-major)
  const T* dinv;        // [N][TB cols][TB rows]: inverse D^-1 of each diagonal block
  const T* coupling;    // [N][TB cols][TB rows]: D^-1 times the block row's tile of the step before
  const T* b;           // right-hand side, element i at b[i * b_stride]
  int64_t b_stride;
  const int64_t* perm;  // row permutation gathered from b, or null
  T* x;                 // [n] solution
  typename Tagged<T>::Word* xt;       // [n] the solution as the launch publishes it
  typename Tagged<T>::Word* partial;  // [items][TB]
  unsigned long long* ticket;
  unsigned long long base;
  const int* step_start;  // [N + 1]: first item of each step
  int64_t n;
  int steps;
  int upper;
  unsigned launch;
  int items;
  int64_t ld;           // the row-major factor's leading dimension, >= n
};

#ifdef LU_TRSV_HOST_EMULATION
// the host build runs the grid's items in ticket order: every value a block
// reads has been published already, or the order is wrong
int lu_trsv_host_error = 0;
#endif


#ifdef LU_TRSV_HOST_EMULATION
template <typename W>
__device__ __forceinline__ W ld_word(const W* p) {
  return *p;
}

template <typename W>
__device__ __forceinline__ void st_word(W* p, W v) {
  *p = v;
}
#else
__device__ __forceinline__ double2 ld_word(const double2* p) {
  double2 w;
  asm volatile("ld.relaxed.gpu.v2.f64 {%0, %1}, [%2];" : "=d"(w.x), "=d"(w.y) : "l"(p));
  return w;
}

__device__ __forceinline__ float2 ld_word(const float2* p) {
  unsigned long long u;
  asm volatile("ld.relaxed.gpu.b64 %0, [%1];" : "=l"(u) : "l"(p));
  return float2{__uint_as_float(static_cast<unsigned>(u)), __uint_as_float(static_cast<unsigned>(u >> 32))};
}

__device__ __forceinline__ void st_word(double2* p, double2 v) {
  asm volatile("st.relaxed.gpu.v2.f64 [%0], {%1, %2};" ::"l"(p), "d"(v.x), "d"(v.y) : "memory");
}

__device__ __forceinline__ void st_word(float2* p, float2 v) {
  const unsigned long long u =
      static_cast<unsigned long long>(__float_as_uint(v.x)) | static_cast<unsigned long long>(__float_as_uint(v.y)) << 32;
  asm volatile("st.relaxed.gpu.b64 [%0], %1;" ::"l"(p), "l"(u) : "memory");
}
#endif

// the value of the word w read from p, once this launch has published it
// (the caller issues its reads first, then settles each: one round trip
// when they are all there)
template <typename T>
__device__ __forceinline__ T settle(typename Tagged<T>::Word w, const typename Tagged<T>::Word* p,
                                    unsigned launch) {
#ifdef LU_TRSV_HOST_EMULATION
  if (Tagged<T>::tag(w) != launch) lu_trsv_host_error = 1;
#else
  if (Tagged<T>::tag(w) != launch) {
    // a wait is microseconds; one of seconds is a fault: stop the kernel
    // with an error rather than hang the card
    const long long t0 = clock64();
    do {
      if (clock64() - t0 > 20000000000LL) __trap();
      w = ld_word(p);
    } while (Tagged<T>::tag(w) != launch);
  }
#endif
  return w.x;
}

// a tile's values are read once: stream them past L1 and first out of L2
template <typename T>
__device__ __forceinline__ T ld_stream(const T* p) {
#ifdef LU_TRSV_HOST_EMULATION
  return *p;
#else
  return __ldcs(p);
#endif
}

// 16 bytes from global into shared memory, asynchronously
__device__ __forceinline__ void copy16(void* dst, const void* src) {
#ifdef LU_TRSV_HOST_EMULATION
  const auto* s = static_cast<const unsigned char*>(src);
  auto* d = static_cast<unsigned char*>(dst);
  for (int i = 0; i < 16; ++i) d[i] = s[i];
#else
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(addr), "l"(src) : "memory");
#endif
}

__device__ __forceinline__ void copies_done() {
#ifndef LU_TRSV_HOST_EMULATION
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
}

// TB x TB values from global into shared memory, asynchronously
template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, int tid) {
  constexpr int CHUNKS = TB * TB * int(sizeof(T)) / 16;
  for (int i = tid; i < CHUNKS; i += THREADS)
    copy16(reinterpret_cast<unsigned char*>(dst) + 16 * i, reinterpret_cast<const unsigned char*>(src) + 16 * i);
}

// first row (or column) of step s's block row
template <typename T>
__device__ __forceinline__ int64_t block_start(const Args<T>& a, int s) {
  return int64_t(a.upper ? a.steps - 1 - s : s) * TB;
}

// the tile (rows from row0, columns from col0), one coalesced 256-byte load
// a half line in f64: column-major, a warp reads columns w + WARPS j, lane l
// rows l and l + 32; row-major, a warp reads rows w + WARPS j, lane l
// columns l and l + 32
template <typename T, bool ROW>
__device__ __forceinline__ void load_tile(T (&v)[2 * COLS], const Args<T>& a, int64_t row0, int64_t col0,
                                          int w, int lane) {
  const int64_t n = a.n;
  // along the contiguous dimension (lanes), across it (warps)
  const int64_t along = ROW ? col0 : row0, across = ROW ? row0 : col0, ld = ROW ? a.ld : n;
  const int64_t l0 = along + lane, l1 = l0 + 32;
  if (row0 + TB <= n && col0 + TB <= n) {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const T* p = a.lu + (across + w + WARPS * j) * ld;
      v[2 * j] = ld_stream(p + l0);
      v[2 * j + 1] = ld_stream(p + l1);
    }
  } else {
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int64_t c = across + w + WARPS * j;
      const T* p = a.lu + c * ld;
      v[2 * j] = (c < n && l0 < n) ? ld_stream(p + l0) : T(0);
      v[2 * j + 1] = (c < n && l1 < n) ? ld_stream(p + l1) : T(0);
    }
  }
}

// the solution values of the columns a warp multiplies in block col0
template <typename T>
__device__ __forceinline__ void solved(T (&ys)[COLS], const Args<T>& a, int64_t col0, int w) {
  typename Tagged<T>::Word words[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int64_t c = col0 + w + WARPS * j;
    words[j] = c < a.n ? ld_word(a.xt + c) : Tagged<T>::make(T(0), a.launch);
  }
#pragma unroll
  for (int j = 0; j < COLS; ++j) ys[j] = settle<T>(words[j], a.xt + col0 + w + WARPS * j, a.launch);
}

// the solution values of the columns lane and lane + 32 of block col0 (row-major)
template <typename T>
__device__ __forceinline__ void solved_lanes(T& y0, T& y1, const Args<T>& a, int64_t col0, int lane) {
  const int64_t c0 = col0 + lane, c1 = c0 + 32;
  const typename Tagged<T>::Word w0 = c0 < a.n ? ld_word(a.xt + c0) : Tagged<T>::make(T(0), a.launch);
  const typename Tagged<T>::Word w1 = c1 < a.n ? ld_word(a.xt + c1) : Tagged<T>::make(T(0), a.launch);
  y0 = settle<T>(w0, a.xt + c0, a.launch);
  y1 = settle<T>(w1, a.xt + c1, a.launch);
}

constexpr unsigned ALL_LANES = 0xffffffffu;

// one step of lane_sums: the lanes with bit o keep the sum `hi` and send
// `lo` across, the others the reverse, so each pair of sums becomes one
template <typename T>
__device__ __forceinline__ T halve(T lo, T hi, int lane, int o) {
  const bool upper = (lane & o) != 0;
  return (upper ? hi : lo) + __shfl_xor_sync(ALL_LANES, upper ? lo : hi, o);
}

// row-major: a warp's sums of its rows w + WARPS j (one a lane in acc[j]),
// each added over the warp's lanes, as the column-major sweep holds them:
// rows lane and lane + 32 in acc0 and acc1, zero in the rows of other warps.
// Three steps halve the sums a lane holds (after them lane l holds row
// index j = l / 4, summed over 8 lanes), two more finish each sum, in an
// order that does not depend on the data
template <typename T>
__device__ __forceinline__ void lane_sums(T (&acc)[COLS], int w, int lane, T& acc0, T& acc1) {
  static_assert(COLS == 8, "the halving steps take 8 sums a lane");
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] = halve(acc[i], acc[i + 4], lane, 16);
#pragma unroll
  for (int i = 0; i < 2; ++i) acc[i] = halve(acc[i], acc[i + 2], lane, 8);
  T v = halve(acc[0], acc[1], lane, 4);
  v += __shfl_xor_sync(ALL_LANES, v, 2);
  v += __shfl_xor_sync(ALL_LANES, v, 1);
  // row lane is index lane / WARPS of warp lane % WARPS, row lane + 32 index
  // lane / WARPS + 4 of the same warp; index j sits in lane 4 j
  const T s0 = __shfl_sync(ALL_LANES, v, (lane / WARPS) * 4);
  const T s1 = __shfl_sync(ALL_LANES, v, (lane / WARPS + 4) * 4);
  if (lane % WARPS == w) {
    acc0 += s0;
    acc1 += s1;
  }
}

// the sum, in item order, of the partial products of `count` items from
// `first` (row r of the block)
template <typename T>
__device__ __forceinline__ T partials(const Args<T>& a, int first, int count, int r) {
  constexpr int BATCH = 4;
  T v = T(0);
  for (int i0 = 0; i0 < count; i0 += BATCH) {
    typename Tagged<T>::Word words[BATCH];
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (i0 + j < count) words[j] = ld_word(&a.partial[int64_t(first + i0 + j) * TB + r]);
#pragma unroll
    for (int j = 0; j < BATCH; ++j)
      if (i0 + j < count) v += settle<T>(words[j], &a.partial[int64_t(first + i0 + j) * TB + r], a.launch);
  }
  return v;
}

// acc0, acc1 (rows lane, lane + 32 of step s's block) += the tiles of steps
// [t0, t1) times their solved values; `meanwhile()` runs once the first
// tile's loads are issued.  (Two tiles in flight a warp measured no faster
// and spilled registers in f64.)
template <typename T, bool ROW, typename F>
__device__ __forceinline__ void sweep(const Args<T>& a, int s, int t0, int t1, int w, int lane, T& acc0, T& acc1,
                                      F meanwhile) {
  const int64_t row0 = block_start(a, s);
  T tile[2 * COLS];
  if (t0 < t1) load_tile<T, ROW>(tile, a, row0, block_start(a, t0), w, lane);
  meanwhile();
  if constexpr (ROW) {
    T acc[COLS];
#pragma unroll
    for (int j = 0; j < COLS; ++j) acc[j] = T(0);
    for (int t = t0; t < t1; ++t) {
      T y0, y1;
      solved_lanes(y0, y1, a, block_start(a, t), lane);
#pragma unroll
      for (int j = 0; j < COLS; ++j) acc[j] = fma(tile[2 * j + 1], y1, fma(tile[2 * j], y0, acc[j]));
      if (t + 1 < t1) load_tile<T, ROW>(tile, a, row0, block_start(a, t + 1), w, lane);
    }
    lane_sums(acc, w, lane, acc0, acc1);
  } else {
    for (int t = t0; t < t1; ++t) {
      T ys[COLS];
      solved(ys, a, block_start(a, t), w);
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        acc0 = fma(tile[2 * j], ys[j], acc0);
        acc1 = fma(tile[2 * j + 1], ys[j], acc1);
      }
      if (t + 1 < t1) load_tile<T, ROW>(tile, a, row0, block_start(a, t + 1), w, lane);
    }
  }
}

// the block's dynamic shared memory: the diagonal block's inverse and the
// coupling tile (TB x TB each), two buffers of the warps' partial sums, the
// right-hand side
template <typename T>
constexpr int smem_bytes() {
  return int(sizeof(T)) * (2 * TB * TB + 2 * WARPS * TB + TB);
}

template <typename T>
__device__ __forceinline__ T* smem() {
#ifdef LU_TRSV_HOST_EMULATION
  return static_cast<T*>(node_sweep_host_shared());
#else
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);
#endif
}

// the block's 8 warps' sums of (lane, lane + 32) into red, then warp 0 adds
// them in warp order: rows lane and lane + 32 in v0, v1.  Two calls in a row
// take two buffers: the barrier of the second keeps the first's readers
// ahead of the third's writers
template <typename T>
__device__ __forceinline__ void block_sum(T* red, T acc0, T acc1, int w, int lane, T& v0, T& v1) {
  red[w * TB + lane] = acc0;
  red[w * TB + lane + 32] = acc1;
  __syncthreads();
  if (w == 0) {
    v0 = T(0);
    v1 = T(0);
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      v0 += red[i * TB + lane];
      v1 += red[i * TB + lane + 32];
    }
  }
}

// v0, v1 -= the tile (column-major in shared memory) times the solution of
// block col0, once published
template <typename T>
__device__ __forceinline__ void couple(const Args<T>& a, const T* tile, int64_t col0, T* red, int w, int lane,
                                       T& v0, T& v1) {
  T ys[COLS];
  solved(ys, a, col0, w);
  T m0 = T(0), m1 = T(0);
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int c = w + WARPS * j;
    m0 = fma(tile[c * TB + lane], ys[j], m0);
    m1 = fma(tile[c * TB + lane + 32], ys[j], m1);
  }
  T u0 = T(0), u1 = T(0);
  block_sum(red, m0, m1, w, lane, u0, u1);
  v0 -= u0;
  v1 -= u1;
}

template <typename T, bool ROW>
__global__ void __launch_bounds__(THREADS, 2) lu_trsv_kernel(Args<T> a) {
  using Tag = Tagged<T>;
  T* dsm = smem<T>();          // [TB cols][TB rows] inverse of the diagonal block
  T* msm = dsm + TB * TB;      // [TB cols][TB rows] coupling tile
  T* red = msm + TB * TB;      // [WARPS][TB]
  T* red2 = red + WARPS * TB;  // [WARPS][TB]
  T* rs = red2 + WARPS * TB;   // [TB]
  __shared__ int item;
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  for (;;) {
    if (tid == 0) item = int(atomicAdd(a.ticket, 1ull) - a.base);
    __syncthreads();
    const int t = item;
    if (t >= a.items) return;
    // the step: the last s with step_start[s] <= t
    int s = 0, hi = a.steps - 1;
    while (s < hi) {
      const int mid = (s + hi + 1) / 2;
      if (__ldg(&a.step_start[mid]) <= t) s = mid; else hi = mid - 1;
    }
    const int first = __ldg(&a.step_start[s]);
    const int k = t - first, q = __ldg(&a.step_start[s + 1]) - first;
    const int own_lo = s > OWNER ? s - OWNER : 0;
    T acc0 = T(0), acc1 = T(0), v0 = T(0), v1 = T(0);
    if (k < q - 1) {
      // a segment of the step's older tiles: its partial product
      const int t0 = k * SEG;
      const int t1 = t0 + SEG < own_lo ? t0 + SEG : own_lo;
      sweep<T, ROW>(a, s, t0, t1, w, lane, acc0, acc1, [] {});
      block_sum(red, acc0, acc1, w, lane, v0, v1);
      if (w == 0) {
        st_word(&a.partial[int64_t(t) * TB + lane], Tag::make(v0, a.launch));
        st_word(&a.partial[int64_t(t) * TB + lane + 32], Tag::make(v1, a.launch));
      }
      continue;
    }
    // the owner.  Before the previous step is solved: its older own tiles,
    // the segments' partials and the diagonal block's inverse give
    // z = D^-1 (b - the products of all tiles but the newest); then
    // x = z - M x_{s-1}
    const int64_t row0 = block_start(a, s);
    const int64_t blk = row0 / TB;
    copy_tile(dsm, a.dinv + blk * TB * TB, tid);
    if (s > 0) copy_tile(msm, a.coupling + blk * TB * TB, tid);
    // the segments' partials while the owner's own tiles load: it is taken
    // long before its newest tiles can be multiplied, and most partials are
    // in by then
    T rhs = T(0), pre = T(0);
    sweep<T, ROW>(a, s, own_lo, s > 0 ? s - 1 : 0, w, lane, acc0, acc1, [&] {
      if (tid < TB) {
        if (row0 + tid < a.n) {
          const int64_t row = row0 + tid;
          rhs = a.b[(a.perm ? a.perm[row] : row) * a.b_stride];
        }
        pre = partials(a, first, q - 1, tid);
      }
    });
    red[w * TB + lane] = acc0;
    red[w * TB + lane + 32] = acc1;
    copies_done();
    __syncthreads();
    if (tid < TB) {
      T v = pre;
#pragma unroll
      for (int i = 0; i < WARPS; ++i) v += red[i * TB + tid];
      rs[tid] = rhs - v;
    }
    __syncthreads();
    T z0 = T(0), z1 = T(0);
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int c = w + WARPS * j;
      z0 = fma(dsm[c * TB + lane], rs[c], z0);
      z1 = fma(dsm[c * TB + lane + 32], rs[c], z1);
    }
    block_sum(red2, z0, z1, w, lane, v0, v1);  // warp 0: z
    if (s > 0) couple(a, msm, block_start(a, s - 1), red, w, lane, v0, v1);
    if (w == 0) {
      if (row0 + lane < a.n) {
        st_word(&a.xt[row0 + lane], Tag::make(v0, a.launch));
        a.x[row0 + lane] = v0;
      }
      if (row0 + lane + 32 < a.n) {
        st_word(&a.xt[row0 + lane + 32], Tag::make(v1, a.launch));
        a.x[row0 + lane + 32] = v1;
      }
    }
  }
}

template <typename T, bool ROW>
int launch(const Args<T>& a, int grid, cudaStream_t stream) {
#ifdef LU_TRSV_HOST_EMULATION
  lu_trsv_host_error = 0;
#endif
  const int e = int(
      cudaFuncSetAttribute(lu_trsv_kernel<T, ROW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>()));
  if (e != 0) return e;
  lu_trsv_kernel<T, ROW><<<grid, THREADS, smem_bytes<T>(), stream>>>(a);
#ifdef LU_TRSV_HOST_EMULATION
  if (lu_trsv_host_error) return 99;
#endif
  return int(cudaGetLastError());
}

// the work items of `steps` steps: each step's owner, and a segment item a
// SEG of its tiles older than its OWNER newest
int count_items(int steps) {
  int items = 0;
  for (int s = 0; s < steps; ++s) items += (s > OWNER ? (s - OWNER + SEG - 1) / SEG : 0) + 1;
  return items;
}

template <typename T>
int entry(const T* lu, int64_t ld, int row_major, const T* dinv, const T* coupling, const T* b, int64_t b_stride,
          const int64_t* perm, T* x, void* xt, void* partial, unsigned long long* ticket, unsigned long long base,
          const int* step_start, int64_t n, int steps, int upper, unsigned launch_id, int items, int grid,
          cudaStream_t stream) {
  // a plan of another tile or split (its step_start and scratch) is refused
  if (n < 1 || (row_major ? ld < n : ld != n) || steps != (n + TB - 1) / TB || items != count_items(steps) ||
      grid < 1 || launch_id == 0)
    return int(cudaErrorInvalidValue);
  using Word = typename Tagged<T>::Word;
  const Args<T> a{lu, dinv, coupling, b, b_stride, perm, x, static_cast<Word*>(xt), static_cast<Word*>(partial),
                   ticket, base, step_start, n, steps, upper, launch_id, items, ld};
  return row_major ? launch<T, true>(a, grid, stream) : launch<T, false>(a, grid, stream);
}

}  // namespace

// one triangle: upper = 0 the unit-lower L (b gathered by perm, if given),
// 1 U, of the factor lu: row-major with leading dimension ld >= n where
// row_major is 1, column-major with ld = n where it is 0.  xt holds n and partial
// items x TB (value, launch) words of 2 x the value's bytes, zero before a
// factor's first launch; launch_id counts from 1.  Returns the CUDA error of
// the launch.
extern "C" int lu_trsv_f64(const double* lu, int64_t ld, int row_major, const double* dinv, const double* coupling,
                           const double* b, int64_t b_stride, const int64_t* perm, double* x, void* xt,
                           void* partial, unsigned long long* ticket, unsigned long long base, const int* step_start,
                           int64_t n, int steps, int upper, unsigned launch_id, int items, int grid,
                           cudaStream_t stream) {
  return entry(lu, ld, row_major, dinv, coupling, b, b_stride, perm, x, xt, partial, ticket, base, step_start, n,
               steps, upper, launch_id, items, grid, stream);
}

extern "C" int lu_trsv_f32(const float* lu, int64_t ld, int row_major, const float* dinv, const float* coupling,
                           const float* b, int64_t b_stride, const int64_t* perm, float* x, void* xt, void* partial,
                           unsigned long long* ticket, unsigned long long base, const int* step_start, int64_t n,
                           int steps, int upper, unsigned launch_id, int items, int grid, cudaStream_t stream) {
  return entry(lu, ld, row_major, dinv, coupling, b, b_stride, perm, x, xt, partial, ticket, base, step_start, n,
               steps, upper, launch_id, items, grid, stream);
}
