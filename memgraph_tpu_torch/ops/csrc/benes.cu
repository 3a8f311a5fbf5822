// Benes network passes on Hopper (sm_90a), with a plain C interface for
// ctypes (memgraph_tpu_torch/ops/benes_cuda.py binds and checks them).
//
// Replaces the two Pallas TPU kernels of memgraph_tpu/ops/benes_pallas.py:
//   benes_mid_gather   <- _mid_kernel   (benes_pallas.py:138, launched at :225)
//   benes_outer_gather <- _outer_kernel (benes_pallas.py:155, launched at :208)
// The stage kernels benes_mid and benes_outer, the passes as masked
// exchanges (the TPU kernels' own form), run only at placement, once per
// plan: they compose the stages into the indices that the two gathers
// then apply every iteration.
//
// benes_mid_gather: the middle stages all act inside aligned 2^K tiles,
// so for a given plan the pass is one fixed permutation inside each tile.
// The TPU ran it as 2K-1 masked rolls because VMEM has no fast arbitrary
// gather; Hopper's shared memory has one.  So a block loads its tile
// (16-byte loads) and its 2-byte tile-local indices, waits at ONE barrier
// and gathers: y[t·2^K + j] = x[t·2^K + idx[t·2^K + j]], the index read as
// unsigned 16 bits (K <= 16; int16 storage holds positions up to 65535).
// No stage loop, no per-stage barrier, no dependent mask load from L2.
// It is bound by bytes: read x and write y (2·N·e) plus the index (2·N).
// The indices are loaded before the barrier, so their latency overlaps
// the tile's.
//
// benes_outer_gather: one side's outer stages (d >= 2^K) only exchange
// rows g <-> g ^ (d >> K) of the (R = 2^(n-K), 2^K) view, each within its
// column, so for a given plan the pass is, per column c, one fixed
// permutation of the R rows: y[g, c] = x[idx[g, c], c], idx a row
// (n-K <= 15: int16 storage, never negative).  The TPU ran the stages as
// masked rolls along the row axis of a VMEM block, a mask word re-read at
// every stage; Hopper's shared memory gathers at any row instead.  A block
// owns CH consecutive columns across all R rows: it starts a cp.async of
// 16 bytes for every 16 bytes of its R row segments (all in flight at
// once, not staged through registers), loads the row indices of its
// output words into registers meanwhile, waits, passes ONE barrier and
// gathers.  A warp takes 32 consecutive 4-byte words of one output row
// (f32: a column a lane; bf16: two columns a lane, their two indices read
// as one 32-bit word), so its shared reads of s[src][c] fall in bank
// c mod 32 whatever src is: no bank conflicts and no padding once a row
// segment has 128 bytes.  CH is chosen per launch: 128-byte row segments,
// at most 64 KB a block (three blocks share an SM) and, where the net is
// large enough, at least two waves of blocks on 132 SMs.  It is bound by
// bytes: read x and write y (2·N·e) plus the index (2·N).
//
// benes_mid / benes_outer (placement; this design replaces PR 1's, which
// read per-element int32 mask planes): for every live stage (row, d) in
// order, each position i does x[i] <- bit(i) ? x[i ^ d] : x[i], where
// bit(i) is bit i of the stage's packed mask row in np.packbits order,
// (row[i >> 3] >> (7 - (i & 7))) & 1, straight from the host router.  The
// routed masks are symmetric (bit(i) == bit(i ^ d)), so each pair
// (j, j + d) with bit d of j clear is swapped by one thread from bit(j).
//   - The block's values (benes_mid: one 2^K tile; benes_outer: CH columns
//     of all 2^(n-K) rows) stay in shared memory for the whole pass.
//   - A stage needs only its slice of the packed row: 2^K/8 bytes a tile,
//     CH/8 bytes a row segment.  A ring of kRing slices is filled by
//     cp.async, a commit group a stage, so later stages' bits are in
//     flight while earlier stages swap and the stage loop never waits on
//     L2.  PR 1's design re-read a 4-byte mask word per pair at every
//     stage (about 32 MB of L2 traffic a stage on the 2^24 net, and the
//     host spent seconds unpacking 2^24-bit rows into those planes).
//   - A thread moves 16-byte vectors (V = 8 16-bit or 4 32-bit values) and
//     swaps them lane-wise with one mask byte (or nibble), widened to lane
//     masks by two multiplies and four byte permutes: t = (a ^ b) & lanes,
//     a ^= t, b ^= t.  Two consecutive stages of distinct
//     distances >= V share one barrier and one pass over shared memory
//     (a thread holds the four vectors j, j + d0, j + d1, j + d0 + d1);
//     the run of stages with d < V (inside one vector) is applied in
//     registers in one pass.  A barrier separates passes.
// Bound by bytes: read x and write y (2·N·e) plus the live stages' packed
// rows (stages·⌈N/8⌉).  Tiles of under 128 values (benes_mid) and row
// segments of under 32 columns (benes_outer) take a scalar path that
// reads the mask bytes from global memory; only small or test networks
// have them.
//
// Values are moved as raw 16- or 32-bit words, so bf16 and f32 are exact
// by construction.  x and y may be the same buffer: each block reads its
// whole region (tile or column chunk) into shared memory before it writes
// any of it, and no two blocks share a region.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxStages = 64;
constexpr int kRing = 8;   // stage slices a block keeps in flight

// One stage: row << 8 | log2(distance), row indexing the packed rows.
struct StageList {
  int n;
  int code[kMaxStages];
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// cp.async of q = 4, 8 or 16 bytes
__device__ __forceinline__ void cp_async_q(void* smem, const void* gmem,
                                           int q) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (q == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else if (q == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
                 "l"(gmem)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most `pending` (0 .. kRing - 1) of this thread's newest
// commit groups are still in flight.
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// x with a zero bit inserted at position b
__device__ __forceinline__ int insert_zero(int x, int b) {
  return ((x >> b) << (b + 1)) | (x & ((1 << b) - 1));
}

// Lane masks of the 16-byte vector of V values starting at value e0 (a
// multiple of V) of a stage slice: all ones over each value whose mask
// bit is set.  Bit k of the vector is bit 7 - k of its byte (packbits
// order; f32 vectors take half a byte).  Two multiplies spread the bits to
// the sign bits of 8 bytes, and byte permutes with sign replication
// (prmt) widen each to its lane; 16-bit values sit little-endian, value
// 2w in the low half of word w.
__device__ __forceinline__ uint32_t prmt_sign(uint32_t x, uint32_t y,
                                              uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(x), "r"(y), "r"(sel));
  return r;
}

template <typename E>
__device__ __forceinline__ uint4 vec_lanes(const unsigned char* slice,
                                           int e0) {
  const uint32_t b = slice[e0 >> 3];
  if constexpr (sizeof(E) == 4) {
    // the vector's 4 bits to bits 7..4, then byte k's sign = bit 7 - k
    const uint32_t x = (((b << (e0 & 4)) & 0xf0u) * 0x08040201u) &
                       0x80808080u;
    return make_uint4(prmt_sign(x, 0, 0x8888), prmt_sign(x, 0, 0x9999),
                      prmt_sign(x, 0, 0xaaaa), prmt_sign(x, 0, 0xbbbb));
  } else {
    // byte k of (x, y)'s sign = bit 7 - k of b: no carries cross bytes
    const uint32_t x = (b * 0x08040201u) & 0x80808080u;
    const uint32_t y = ((b << 4) * 0x08040201u) & 0x80808080u;
    return make_uint4(prmt_sign(x, y, 0x9988), prmt_sign(x, y, 0xbbaa),
                      prmt_sign(x, y, 0xddcc), prmt_sign(x, y, 0xffee));
  }
}

// The V mask bits of the vector at e0 as an integer, value k at bit
// V-1-k (for the stages inside one vector).
template <typename E>
__device__ __forceinline__ unsigned vec_bits(const unsigned char* slice,
                                             int e0) {
  const unsigned b = slice[e0 >> 3];
  if constexpr (sizeof(E) == 4)
    return (e0 & 4) ? (b & 0xfu) : (b >> 4);
  else
    return b;
}

// Exchange the lanes of a and b that m selects.
__device__ __forceinline__ void swap_masked(uint4& a, uint4& b,
                                            const uint4 m) {
  uint32_t t;
  t = (a.x ^ b.x) & m.x; a.x ^= t; b.x ^= t;
  t = (a.y ^ b.y) & m.y; a.y ^= t; b.y ^= t;
  t = (a.z ^ b.z) & m.z; a.z ^= t; b.z ^= t;
  t = (a.w ^ b.w) & m.w; a.w ^= t; b.w ^= t;
}

template <typename E>
__device__ __forceinline__ void unpack(const uint4 u,
                                       uint32_t (&e)[16 / sizeof(E)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(E) == 4) {
      e[i] = w[i];
    } else {
      e[2 * i] = w[i] & 0xffffu;
      e[2 * i + 1] = w[i] >> 16;
    }
  }
}

template <typename E>
__device__ __forceinline__ uint4 pack(const uint32_t (&e)[16 / sizeof(E)]) {
  if constexpr (sizeof(E) == 4)
    return make_uint4(e[0], e[1], e[2], e[3]);
  else
    return make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16,
                      e[4] | e[5] << 16, e[6] | e[7] << 16);
}

// One stage of distance 2^LD < V inside a vector held as V values.
template <int V, int LD>
__device__ __forceinline__ void swap_in_vec(uint32_t (&e)[V], unsigned m) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (k & (1 << LD)) continue;
    const bool s = (m >> (V - 1 - k)) & 1u;
    const uint32_t a = e[k], b = e[k + (1 << LD)];
    e[k] = s ? b : a;
    e[k + (1 << LD)] = s ? a : b;
  }
}

template <int V>
__device__ __forceinline__ void swap_in_vec(uint32_t (&e)[V], unsigned m,
                                            int ld) {
  if (ld == 0) {
    swap_in_vec<V, 0>(e, m);
  } else if (ld == 1) {
    swap_in_vec<V, 1>(e, m);
  } else {
    if constexpr (V == 8) swap_in_vec<V, 2>(e, m);
  }
}

// Stages in the next pass starting at stage k: the run of stages inside
// one vector (log2 d < lv), else two stages of distinct distances >= V
// where the next one is such, else one.  code: row << 8 | log2(d).
__device__ __forceinline__ int pass_len(const int* code, int n, int k,
                                        int lv) {
  const int l0 = code[k] & 0xff;
  if (l0 < lv) {
    int r = 1;
    while (k + r < n && (code[k + r] & 0xff) < lv) ++r;
    return r;
  }
  if (k + 1 < n) {
    const int l1 = code[k + 1] & 0xff;
    if (l1 >= lv && l1 != l0) return 2;
  }
  return 1;
}

// The stage list in shared memory (a dynamic index into the kernel's
// parameters would copy them to local memory); the caller passes a
// barrier before reading it.
__device__ __forceinline__ void load_codes(const StageList& st, int* code) {
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kMaxStages; ++i) code[i] = st.code[i];
  }
}

// Where benes_mid keeps 16-byte vector v of its tile: v with its bank
// group (bits 0-2) XORed by 7·v3 ^ 5·v4.  A quarter-warp's 8 lanes then
// hit 8 distinct bank groups in every pass, also those whose distances
// (1-4 vectors) would otherwise put 2-4 lanes on one group.
__device__ __forceinline__ int swz(int v) {
  return v ^ (((v >> 3) & 1) * 7) ^ (((v >> 4) & 1) * 5);
}

// One pass of R (1 or 2) stages of distinct distances 2^ld[r] >= V over
// a tile in shared memory: a thread holds the 2^R vectors j + (any sum
// of the distances), j with those R bits clear, and applies the R stages
// in order in registers (stage r pairs vector i with i | 2^r, from the
// mask bit of the lower one, slice sl[r]).  Three stages a pass (94
// registers) measured no faster than two on the H100.
template <typename E, int R>
__device__ __forceinline__ void mid_pass(uint4* sv, const int* ld,
                                         const unsigned char* const* sl,
                                         int T) {
  constexpr int LV = sizeof(E) == 4 ? 2 : 3;
  int d[R], srt[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    d[r] = 1 << ld[r];
    srt[r] = ld[r];
  }
#pragma unroll
  for (int a = 0; a < R; ++a)          // ascending, for the insertions
#pragma unroll
    for (int b = 0; b + 1 < R - a; ++b)
      if (srt[b] > srt[b + 1]) {
        const int t = srt[b];
        srt[b] = srt[b + 1];
        srt[b + 1] = t;
      }
  for (int q = threadIdx.x; q < (T >> (LV + R)); q += blockDim.x) {
    int j = q << LV;
#pragma unroll
    for (int r = 0; r < R; ++r) j = insert_zero(j, srt[r]);
    int pos[1 << R];
    uint4 v[1 << R];
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) {
      pos[i] = j;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (i & (1 << r)) pos[i] += d[r];
      v[i] = sv[swz(pos[i] >> LV)];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int i = 0; i < (1 << R); ++i)
        if (!(i & (1 << r)))
          swap_masked(v[i], v[i | (1 << r)],
                      vec_lanes<E>(sl[r], pos[i]));
#pragma unroll
    for (int i = 0; i < (1 << R); ++i) sv[swz(pos[i] >> LV)] = v[i];
  }
}

// benes_mid, tiles of 2^K >= 128 values.  Shared memory: the tile (T·e
// bytes), then kRing slices of T/8 mask bytes.
template <typename E>
__global__ void __launch_bounds__(512)
    benes_mid_kernel(const E* x, E* y, const unsigned char* __restrict__ rows,
                     long long row_stride, int K, StageList st) {
  constexpr int V = 16 / static_cast<int>(sizeof(E));
  constexpr int LV = sizeof(E) == 4 ? 2 : 3;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int code[kMaxStages];
  uint4* sv = reinterpret_cast<uint4*>(smem_raw);
  const int T = 1 << K;
  const int SB = T >> 3;
  unsigned char* ring = smem_raw + static_cast<size_t>(T) * sizeof(E);
  const long long base = static_cast<long long>(blockIdx.x) << K;
  const int n = st.n;
  const int n_vec = T / V;
  load_codes(st, code);
  // 1. the tile: one commit group
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    cp_async16(sv + swz(i), xv + i);
  cp_async_commit();
  __syncthreads();   // code[]
  // 2. stage slices, a commit group each, kRing ahead
  const unsigned char* tile_bits = rows + (base >> 3);
  auto issue = [&](int s) {
    const unsigned char* src =
        tile_bits + static_cast<long long>(code[s] >> 8) * row_stride;
    unsigned char* dst = ring + (s % kRing) * SB;
    for (int i = threadIdx.x; i < (SB >> 4); i += blockDim.x)
      cp_async16(dst + 16 * i, src + 16 * i);
    cp_async_commit();
  };
  int issued = 0;
  for (; issued < n && issued < kRing; ++issued) issue(issued);
  for (int k = 0; k < n;) {
    const int r = pass_len(code, n, k, LV);
    cp_async_wait_pending(issued - (k + r));   // slices k .. k+r-1 landed
    __syncthreads();                           // ... for every thread
    // the slots of stages before k are free: refill them
    for (; issued < n && issued < k + kRing; ++issued) issue(issued);
    int ld[2];
    const unsigned char* sl[2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      ld[q] = code[k + (q < r ? q : 0)] & 0xff;
      sl[q] = ring + ((k + (q < r ? q : 0)) % kRing) * SB;
    }
    if (ld[0] < LV) {
      // a run of stages inside each 16-byte vector, in registers
      for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
        uint32_t e[V];
        unpack<E>(sv[swz(i)], e);
        for (int q = 0; q < r; ++q)
          swap_in_vec<V>(e, vec_bits<E>(ring + ((k + q) % kRing) * SB, i * V),
                         code[k + q] & 0xff);
        sv[swz(i)] = pack<E>(e);
      }
    } else if (r == 2) {
      mid_pass<E, 2>(sv, ld, sl, T);
    } else {
      mid_pass<E, 1>(sv, ld, sl, T);
    }
    k += r;
  }
  cp_async_wait_all();   // the tile, where no stage is live
  __syncthreads();
  uint4* yv = reinterpret_cast<uint4*>(y + base);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) yv[i] = sv[swz(i)];
}

// benes_mid, tiles of 2^K < 128 values: a pair a thread, mask bytes read
// from global memory (sub-byte tiles share a byte).
template <typename E>
__global__ void benes_mid_small_kernel(const E* x, E* y,
                                       const unsigned char* __restrict__ rows,
                                       long long row_stride, int K,
                                       StageList st) {
  __shared__ E s[64];
  const int T = 1 << K;
  const long long base = static_cast<long long>(blockIdx.x) << K;
  const int t = threadIdx.x;
  if (t < T) s[t] = x[base + t];
  __syncthreads();
  for (int k = 0; k < st.n; ++k) {
    const int ld = st.code[k] & 0xff;
    const unsigned char* row =
        rows + static_cast<long long>(st.code[k] >> 8) * row_stride;
    if (t < T / 2) {
      const int j = insert_zero(t, ld);
      const long long i = base + j;
      if ((__ldg(row + (i >> 3)) >> (7 - (i & 7))) & 1) {
        const E a = s[j];
        s[j] = s[j + (1 << ld)];
        s[j + (1 << ld)] = a;
      }
    }
    __syncthreads();
  }
  if (t < T) y[base + t] = s[t];
}

// benes_outer, row segments of CH = 2^ch_log >= 32 columns.  Shared
// memory: the chunk, sv[g·CV + v] (CV 16-byte vectors a row segment),
// then kRing slices of R·CH/8 mask bytes (row g's CH/8 bytes at g·CH/8).
template <typename E>
__global__ void __launch_bounds__(512)
    benes_outer_kernel(const E* x, E* y,
                       const unsigned char* __restrict__ rows,
                       long long row_stride, int K, int r_log, int ch_log,
                       StageList st) {
  constexpr int LV = sizeof(E) == 4 ? 2 : 3;
  constexpr int V = 1 << LV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* sv = reinterpret_cast<uint4*>(smem_raw);
  const int cv_log = ch_log - LV;
  const int CV = 1 << cv_log;
  const int seg = 1 << (ch_log - 3);           // mask bytes a row segment
  const int q_bytes = seg < 16 ? seg : 16;     // cp.async size
  const int SB = seg << r_log;
  const long long M = 1LL << K;
  const long long c0 = static_cast<long long>(blockIdx.x) << ch_log;
  unsigned char* ring =
      smem_raw + (static_cast<size_t>(sizeof(E)) << (r_log + ch_log));
  const int n = st.n;
  const int n_vec = CV << r_log;
  __shared__ int code[kMaxStages];
  load_codes(st, code);
  // 1. the chunk: one commit group
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const long long g = i >> cv_log;
    cp_async16(sv + i, x + g * M + c0 + ((i & (CV - 1)) << LV));
  }
  cp_async_commit();
  // 2. stage slices, a commit group each, kRing ahead
  const unsigned char* chunk_bits = rows + (c0 >> 3);
  const int chunks_log = r_log + (ch_log - 3) - (q_bytes == 16 ? 4
                                                 : q_bytes == 8 ? 3 : 2);
  const int per_seg = seg / q_bytes;
  auto issue = [&](int s) {
    const unsigned char* src =
        chunk_bits + static_cast<long long>(code[s] >> 8) * row_stride;
    unsigned char* dst = ring + (s % kRing) * SB;
    for (int i = threadIdx.x; i < (1 << chunks_log); i += blockDim.x) {
      const long long g = i / per_seg;
      const int off = (i % per_seg) * q_bytes;
      cp_async_q(dst + g * seg + off, src + g * (M >> 3) + off, q_bytes);
    }
    cp_async_commit();
  };
  __syncthreads();   // code[]
  int issued = 0;
  for (; issued < n && issued < kRing; ++issued) issue(issued);
  for (int k = 0; k < n;) {
    const int r = pass_len(code, n, k, 0);
    cp_async_wait_pending(issued - (k + r));
    __syncthreads();
    for (; issued < n && issued < k + kRing; ++issued) issue(issued);
    const int l0 = (code[k] & 0xff) - K;   // log2 of the row distance
    const unsigned char* sl0 = ring + (k % kRing) * SB;
    if (r == 2) {
      const int l1 = (code[k + 1] & 0xff) - K;
      const unsigned char* sl1 = ring + ((k + 1) % kRing) * SB;
      const int t0 = 1 << l0, t1 = 1 << l1;
      const int lo = l0 < l1 ? l0 : l1, hi = l0 < l1 ? l1 : l0;
      for (int q = threadIdx.x; q < (n_vec >> 2); q += blockDim.x) {
        const int v = q & (CV - 1);
        const int g = insert_zero(insert_zero(q >> cv_log, lo), hi);
        const int a = (g << cv_log) + v, b = ((g + t0) << cv_log) + v,
                  c = ((g + t1) << cv_log) + v,
                  w = ((g + t0 + t1) << cv_log) + v;
        uint4 va = sv[a], vb = sv[b], vc = sv[c], vw = sv[w];
        swap_masked(va, vb, vec_lanes<E>(sl0 + g * seg, v * V));
        swap_masked(vc, vw,
                    vec_lanes<E>(sl0 + (g + t1) * seg, v * V));
        swap_masked(va, vc, vec_lanes<E>(sl1 + g * seg, v * V));
        swap_masked(vb, vw,
                    vec_lanes<E>(sl1 + (g + t0) * seg, v * V));
        sv[a] = va;
        sv[b] = vb;
        sv[c] = vc;
        sv[w] = vw;
      }
    } else {
      const int t0 = 1 << l0;
      for (int q = threadIdx.x; q < (n_vec >> 1); q += blockDim.x) {
        const int v = q & (CV - 1);
        const int g = insert_zero(q >> cv_log, l0);
        const int a = (g << cv_log) + v, b = ((g + t0) << cv_log) + v;
        uint4 va = sv[a], vb = sv[b];
        swap_masked(va, vb, vec_lanes<E>(sl0 + g * seg, v * V));
        sv[a] = va;
        sv[b] = vb;
      }
    }
    k += r;
  }
  cp_async_wait_all();
  __syncthreads();
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x) {
    const long long g = i >> cv_log;
    *reinterpret_cast<uint4*>(y + g * M + c0 + ((i & (CV - 1)) << LV)) =
        sv[i];
  }
}

// benes_outer, row segments of under 32 columns (many rows, or 2^K < 32):
// a pair a thread, mask bytes read from global memory.  s[g·CH + c].
template <typename E>
__global__ void __launch_bounds__(512)
    benes_outer_scalar_kernel(const E* x, E* y,
                              const unsigned char* __restrict__ rows,
                              long long row_stride, int K, int r_log,
                              int ch_log, StageList st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* s = reinterpret_cast<E*>(smem_raw);
  const int CH = 1 << ch_log;
  const int cells = 1 << (r_log + ch_log);
  const long long M = 1LL << K;
  const long long c0 = static_cast<long long>(blockIdx.x) << ch_log;
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    s[i] = x[(i >> ch_log) * M + c0 + (i & (CH - 1))];
  __syncthreads();
  for (int k = 0; k < st.n; ++k) {
    const int lt = (st.code[k] & 0xff) - K;
    const unsigned char* row =
        rows + static_cast<long long>(st.code[k] >> 8) * row_stride;
    for (int q = threadIdx.x; q < cells / 2; q += blockDim.x) {
      const int c = q & (CH - 1);
      const int g = insert_zero(q >> ch_log, lt);
      const long long i = g * M + c0 + c;
      if ((__ldg(row + (i >> 3)) >> (7 - (i & 7))) & 1) {
        const int a_i = (g << ch_log) + c;
        const int b_i = ((g + (1 << lt)) << ch_log) + c;
        const E a = s[a_i];
        s[a_i] = s[b_i];
        s[b_i] = a;
      }
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < cells; i += blockDim.x)
    y[(i >> ch_log) * M + c0 + (i & (CH - 1))] = s[i];
}

// CPT: 8-slot chunks a thread (T / 8 / blockDim.x); its CPT index vectors
// stay in registers from before the barrier to the gather.
template <typename E, int CPT>
__global__ void __launch_bounds__(1024)
    benes_mid_gather_kernel(const E* x, E* y,
                            const uint16_t* __restrict__ idx, int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int T = 1 << K;
  const long long base = static_cast<long long>(blockIdx.x) << K;
  const uint4* iv = reinterpret_cast<const uint4*>(idx + base);
  uint4 w[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    w[k] = __ldg(iv + threadIdx.x + k * blockDim.x);
  const uint4* xv = reinterpret_cast<const uint4*>(x + base);
  uint4* sv = reinterpret_cast<uint4*>(smem_raw);
  const int n_vec = (T * static_cast<int>(sizeof(E))) >> 4;
#pragma unroll 8
  for (int j = threadIdx.x; j < n_vec; j += blockDim.x) sv[j] = xv[j];
  __syncthreads();
  const E* s = reinterpret_cast<const E*>(smem_raw);
  uint4* yv = reinterpret_cast<uint4*>(y + base);
#pragma unroll
  for (int k = 0; k < CPT; ++k) {
    const int c = threadIdx.x + k * blockDim.x;
    const uint32_t p[4] = {w[k].x, w[k].y, w[k].z, w[k].w};
    uint32_t v[8];   // little-endian: slot 8c + 2i is p[i]'s low half
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      v[2 * i] = s[p[i] & 0xffffu];
      v[2 * i + 1] = s[p[i] >> 16];
    }
    if constexpr (sizeof(E) == 4) {
      yv[2 * c] = make_uint4(v[0], v[1], v[2], v[3]);
      yv[2 * c + 1] = make_uint4(v[4], v[5], v[6], v[7]);
    } else {
      yv[c] = make_uint4(v[0] | v[1] << 16, v[2] | v[3] << 16,
                         v[4] | v[5] << 16, v[6] | v[7] << 16);
    }
  }
}

// Tiles of 2 or 4 slots (nets of 2 or 4): a slot a thread, no vectors.
template <typename E>
__global__ void benes_mid_gather_small_kernel(const E* x, E* y,
                                              const uint16_t* idx, int K) {
  const long long base = static_cast<long long>(blockIdx.x) << K;
  const E v = x[base + idx[base + threadIdx.x]];
  __syncthreads();   // every read of the tile before any write (y may be x)
  y[base + threadIdx.x] = v;
}

// WPT: 4-byte output words a thread; their row indices stay in registers
// from before the barrier to the gather.  The block's chunk: columns
// [blockIdx.x·CH, +CH) of all 2^r_log rows, CH = 2^ch_log.
template <typename E, int WPT>
__global__ void __launch_bounds__(512)
    benes_outer_gather_kernel(const E* x, E* y,
                              const uint16_t* __restrict__ idx, int K,
                              int r_log, int ch_log) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kColsPerWord = 4 / static_cast<int>(sizeof(E));
  const int seg_log = ch_log + (sizeof(E) == 4 ? 2 : 1);   // row segment B
  const int w_log = seg_log - 2;                           // its words
  const long long c0 = static_cast<long long>(blockIdx.x) << ch_log;
  // 1. the chunk into shared memory, s[g·CH + c]: 16-byte cp.async where
  //    a row segment has 16 bytes, else 4-byte words
  if (seg_log >= 4) {
    const int v_log = seg_log - 4;
    const int n_vec = 1 << (r_log + v_log);
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x) {
      const long long g = v >> v_log;
      const int j = v & ((1 << v_log) - 1);
      cp_async16(smem_raw + (static_cast<size_t>(v) << 4),
                 reinterpret_cast<const unsigned char*>(x + (g << K) + c0) +
                     (j << 4));
    }
  } else {
    uint32_t* sw = reinterpret_cast<uint32_t*>(smem_raw);
    const int n_w = 1 << (r_log + w_log);
    for (int v = threadIdx.x; v < n_w; v += blockDim.x) {
      const long long g = v >> w_log;
      sw[v] = reinterpret_cast<const uint32_t*>(x + (g << K) + c0)
          [v & ((1 << w_log) - 1)];
    }
  }
  // 2. meanwhile, the row indices of this thread's output words
  uint32_t p[WPT];
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int w = threadIdx.x + k * blockDim.x;
    const long long g = w >> w_log;
    const uint16_t* ip =
        idx + (g << K) + c0 + (w & ((1 << w_log) - 1)) * kColsPerWord;
    if constexpr (kColsPerWord == 1)
      p[k] = __ldg(ip);
    else
      p[k] = __ldg(reinterpret_cast<const unsigned int*>(ip));
  }
  cp_async_wait_all();
  __syncthreads();
  // 3. gather and store a 4-byte word a lane
#pragma unroll
  for (int k = 0; k < WPT; ++k) {
    const int w = threadIdx.x + k * blockDim.x;
    const long long g = w >> w_log;
    const int j = w & ((1 << w_log) - 1);
    uint32_t v;
    if constexpr (kColsPerWord == 1) {
      v = reinterpret_cast<const uint32_t*>(smem_raw)[(p[k] << ch_log) + j];
    } else {
      const uint16_t* s = reinterpret_cast<const uint16_t*>(smem_raw);
      v = static_cast<uint32_t>(s[((p[k] & 0xffffu) << ch_log) + 2 * j]) |
          static_cast<uint32_t>(s[((p[k] >> 16) << ch_log) + 2 * j + 1])
              << 16;
    }
    reinterpret_cast<uint32_t*>(y + (g << K) + c0)[j] = v;
  }
}

int log2_exact(long long v) {
  int r = 0;
  while ((1LL << r) < v) ++r;
  return (1LL << r) == v ? r : -1;
}

bool fill_stages(const int* codes, int n_codes, StageList* st) {
  if (n_codes < 0 || n_codes > kMaxStages) return false;
  st->n = n_codes;
  for (int i = 0; i < n_codes; ++i) st->code[i] = codes[i];
  return true;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename E>
cudaError_t launch_mid(const void* x, void* y, const void* rows,
                       long long row_stride, long long n_elems, int K,
                       const StageList& st, cudaStream_t stream) {
  const E* xe = static_cast<const E*>(x);
  E* ye = static_cast<E*>(y);
  const unsigned char* re = static_cast<const unsigned char*>(rows);
  const unsigned blocks = static_cast<unsigned>(n_elems >> K);
  const int T = 1 << K;
  if (K < 7) {
    const int threads = T < 32 ? 32 : T;
    benes_mid_small_kernel<E><<<blocks, threads, 0, stream>>>(
        xe, ye, re, row_stride, K, st);
    return cudaGetLastError();
  }
  if (!aligned16(x) || !aligned16(y) || !aligned16(rows) || row_stride % 16)
    return cudaErrorMisalignedAddress;
  const int lv = sizeof(E) == 4 ? 2 : 3;
  int threads = T >> (lv + 1);
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  const size_t smem = static_cast<size_t>(T) * sizeof(E) +
                      static_cast<size_t>(kRing) * (T >> 3);
  cudaError_t err = cudaFuncSetAttribute(
      benes_mid_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  benes_mid_kernel<E><<<blocks, threads, smem, stream>>>(xe, ye, re,
                                                         row_stride, K, st);
  return cudaGetLastError();
}

template <typename E, int CPT>
cudaError_t launch_mid_gather_cpt(const E* x, E* y, const uint16_t* idx,
                                  int K, unsigned blocks, int threads,
                                  cudaStream_t stream) {
  const size_t smem = sizeof(E) << K;
  cudaError_t err = cudaFuncSetAttribute(
      benes_mid_gather_kernel<E, CPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  benes_mid_gather_kernel<E, CPT><<<blocks, threads, smem, stream>>>(
      x, y, idx, K);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_mid_gather(const void* x, void* y, const void* idx,
                              long long n_elems, int K, cudaStream_t stream) {
  const E* xe = static_cast<const E*>(x);
  E* ye = static_cast<E*>(y);
  const uint16_t* ie = static_cast<const uint16_t*>(idx);
  const unsigned blocks = static_cast<unsigned>(n_elems >> K);
  const int T = 1 << K;
  if (T < 8) {
    benes_mid_gather_small_kernel<E><<<blocks, T, 0, stream>>>(xe, ye, ie, K);
    return cudaGetLastError();
  }
  const int chunks = T / 8;
  const int threads = chunks < 1024 ? chunks : 1024;
  switch (chunks / threads) {
    case 1:
      return launch_mid_gather_cpt<E, 1>(xe, ye, ie, K, blocks, threads,
                                          stream);
    case 2:
      return launch_mid_gather_cpt<E, 2>(xe, ye, ie, K, blocks, threads,
                                          stream);
    case 4:
      return launch_mid_gather_cpt<E, 4>(xe, ye, ie, K, blocks, threads,
                                          stream);
    case 8:
      return launch_mid_gather_cpt<E, 8>(xe, ye, ie, K, blocks, threads,
                                          stream);
    default: return cudaErrorInvalidValue;
  }
}

// Two waves of blocks on an H100 SXM's 132 SMs.
constexpr long long kMinBlocks = 264;

template <typename E, int WPT>
cudaError_t launch_outer_gather_wpt(const E* x, E* y, const uint16_t* idx,
                                    int K, int r_log, int ch_log, int threads,
                                    cudaStream_t stream) {
  const size_t smem = sizeof(E) << (r_log + ch_log);
  cudaError_t err = cudaFuncSetAttribute(
      benes_outer_gather_kernel<E, WPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = 1u << (K - ch_log);
  benes_outer_gather_kernel<E, WPT><<<blocks, threads, smem, stream>>>(
      x, y, idx, K, r_log, ch_log);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_outer_gather(const void* x, void* y, const void* idx,
                                long long n_elems, int K,
                                cudaStream_t stream) {
  const E* xe = static_cast<const E*>(x);
  E* ye = static_cast<E*>(y);
  const uint16_t* ie = static_cast<const uint16_t*>(idx);
  const int r_log = log2_exact(n_elems) - K;
  const int e_log = sizeof(E) == 4 ? 2 : 1;
  // columns a block: 128-byte row segments (a warp's 32 words) ...
  int ch_log = 7 - e_log < K ? 7 - e_log : K;
  // ... cut to at most 64 KB a block (128 KB where one 4-byte word a row
  // is that much already) ...
  const int floor_log = 2 - e_log;
  while (ch_log > floor_log && r_log + ch_log + e_log > 16) --ch_log;
  // ... and widened while the block stays within 64 KB and the grid
  // keeps two waves
  while (ch_log < K && r_log + ch_log + 1 + e_log <= 16 &&
         (1LL << (K - ch_log - 1)) >= kMinBlocks)
    ++ch_log;
  const int words = 1 << (r_log + ch_log + e_log - 2);
  const int threads = words < 512 ? words : 512;
  switch (words / threads) {
    case 1:
      return launch_outer_gather_wpt<E, 1>(xe, ye, ie, K, r_log, ch_log,
                                            threads, stream);
    case 2:
      return launch_outer_gather_wpt<E, 2>(xe, ye, ie, K, r_log, ch_log,
                                            threads, stream);
    case 4:
      return launch_outer_gather_wpt<E, 4>(xe, ye, ie, K, r_log, ch_log,
                                            threads, stream);
    case 8:
      return launch_outer_gather_wpt<E, 8>(xe, ye, ie, K, r_log, ch_log,
                                            threads, stream);
    case 16:
      return launch_outer_gather_wpt<E, 16>(xe, ye, ie, K, r_log, ch_log,
                                             threads, stream);
    case 32:
      return launch_outer_gather_wpt<E, 32>(xe, ye, ie, K, r_log, ch_log,
                                             threads, stream);
    case 64:
      return launch_outer_gather_wpt<E, 64>(xe, ye, ie, K, r_log, ch_log,
                                             threads, stream);
    default: return cudaErrorInvalidValue;
  }
}

template <typename E>
cudaError_t launch_outer(const void* x, void* y, const void* rows,
                         long long row_stride, long long n_elems, int K,
                         const StageList& st, cudaStream_t stream) {
  const E* xe = static_cast<const E*>(x);
  E* ye = static_cast<E*>(y);
  const unsigned char* re = static_cast<const unsigned char*>(rows);
  const int r_log = log2_exact(n_elems) - K;
  const int e_log = sizeof(E) == 4 ? 2 : 1;
  // columns a block: at most 64 KB of values (more only where one column
  // of all rows is that much already) ...
  int ch_log = 16 - e_log - r_log;
  if (ch_log < 0) ch_log = 0;
  if (ch_log > K) ch_log = K;
  // ... cut to keep two waves of blocks while segments keep 32 columns
  while (ch_log > 5 && (1LL << (K - ch_log)) < kMinBlocks) --ch_log;
  const unsigned blocks = 1u << (K - ch_log);
  const int cells = 1 << (r_log + ch_log);
  size_t smem = static_cast<size_t>(cells) * sizeof(E);
  cudaError_t err;
  if (ch_log < 5) {
    int threads = cells / 2;
    threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
    err = cudaFuncSetAttribute(benes_outer_scalar_kernel<E>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    benes_outer_scalar_kernel<E><<<blocks, threads, smem, stream>>>(
        xe, ye, re, row_stride, K, r_log, ch_log, st);
    return cudaGetLastError();
  }
  if (!aligned16(x) || !aligned16(y) || !aligned16(rows) ||
      row_stride % ((1 << (ch_log - 3)) < 16 ? (1 << (ch_log - 3)) : 16))
    return cudaErrorMisalignedAddress;
  smem += static_cast<size_t>(kRing) * (cells >> 3);
  int threads = cells >> (e_log == 2 ? 3 : 4);   // a vector pair a thread
  threads = threads < 32 ? 32 : (threads > 512 ? 512 : threads);
  err = cudaFuncSetAttribute(benes_outer_kernel<E>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  benes_outer_kernel<E><<<blocks, threads, smem, stream>>>(
      xe, ye, re, row_stride, K, r_log, ch_log, st);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// All middle stages (d < 2^K) of a Benes network over n_elems = 2^n
// values of elem_bytes (2 or 4) bytes each; one block per 2^K tile.
// rows: packed mask rows (np.packbits order), row r at r * row_stride
// bytes.  codes: n_codes host ints, row << 8 | log2(d).  x, y and rows
// 16-byte aligned where 2^K >= 128; y may be x.  Returns the CUDA error
// of the launch (0 on success).
int benes_mid(const void* x, void* y, const void* rows, long long row_stride,
              long long n_elems, int K, int elem_bytes, const int* codes,
              int n_codes, void* stream) {
  StageList st;
  const int n = log2_exact(n_elems);
  if (!fill_stages(codes, n_codes, &st) || n < 1 || K < 1 || K > n ||
      (static_cast<long long>(elem_bytes) << K) > 227 * 1024)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_mid<uint32_t>(x, y, rows, row_stride, n_elems, K, st, s);
  if (elem_bytes == 2)
    return launch_mid<uint16_t>(x, y, rows, row_stride, n_elems, K, st, s);
  return cudaErrorInvalidValue;
}

// The middle pass as a gather inside each 2^K tile (2 <= 2^K <= 65536):
// y[i] = x[(i & ~(2^K - 1)) + idx[i]], idx: (n_elems,) unsigned 16-bit
// tile-local positions.  x, y and idx 16-byte aligned; y may be x.
// Returns the CUDA error of the launch.
int benes_mid_gather(const void* x, void* y, const void* idx,
                     long long n_elems, int K, int elem_bytes, void* stream) {
  const int n = log2_exact(n_elems);
  if (n < 1 || K < 1 || K > n || K > 16) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_mid_gather<uint32_t>(x, y, idx, n_elems, K, s);
  if (elem_bytes == 2)
    return launch_mid_gather<uint16_t>(x, y, idx, n_elems, K, s);
  return cudaErrorInvalidValue;
}

// The outer stages (d >= 2^K) of one side of the network, as exchanges
// of rows g <-> g ^ (d >> K) on the (2^(n-K), 2^K) view; rows and codes
// as for benes_mid.  x, y and rows 16-byte aligned where 2^K >= 32.
// Placement runs it on an iota of rows to compose the side's row index.
// Returns the CUDA error of the launch.
int benes_outer(const void* x, void* y, const void* rows,
                long long row_stride, long long n_elems, int K,
                int elem_bytes, const int* codes, int n_codes,
                void* stream) {
  StageList st;
  const int n = log2_exact(n_elems);
  if (!fill_stages(codes, n_codes, &st) || n < 1 || K < 1 || K >= n ||
      n - K > 15)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_outer<uint32_t>(x, y, rows, row_stride, n_elems, K, st, s);
  if (elem_bytes == 2)
    return launch_outer<uint16_t>(x, y, rows, row_stride, n_elems, K, st, s);
  return cudaErrorInvalidValue;
}

// One side's outer pass as a gather by a placed row index on the
// (2^(n-K), 2^K) view of n_elems = 2^n values (1 <= n - K <= 15):
// y[g·2^K + c] = x[idx[g·2^K + c]·2^K + c], idx: (n_elems,) 16-bit rows.
// x, y and idx 16-byte aligned (4-byte where 2^K values are under 16
// bytes); y may be x.  Returns the CUDA error of the launch.
int benes_outer_gather(const void* x, void* y, const void* idx,
                       long long n_elems, int K, int elem_bytes,
                       void* stream) {
  const int n = log2_exact(n_elems);
  if (n < 2 || K < 1 || K >= n || n - K > 15) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_outer_gather<uint32_t>(x, y, idx, n_elems, K, s);
  if (elem_bytes == 2)
    return launch_outer_gather<uint16_t>(x, y, idx, n_elems, K, s);
  return cudaErrorInvalidValue;
}

const char* benes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
