// Benes network passes on Hopper (sm_90a), with a plain C interface for
// ctypes (memgraph_tpu_torch/ops/benes_cuda.py binds and checks them).
//
// Replaces the two Pallas TPU kernels of memgraph_tpu/ops/benes_pallas.py:
//   benes_mid_gather   <- _mid_kernel   (benes_pallas.py:138, launched at :225)
//   benes_outer_gather <- _outer_kernel (benes_pallas.py:155, launched at :208)
// The stage kernels benes_mid and benes_outer, the passes as masked
// exchanges (the TPU kernels' own form), now run only at placement, once
// per plan: they compose the stages into the indices that the two gathers
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
// benes_mid / benes_outer (placement): for every live stage (plane, bit,
// d) in order, each position i does
// x[i] <- ((word[i] >> bit) & 1) ? x[i ^ d] : x[i].
// The routed masks are symmetric (word bit of i == word bit of i ^ d), so
// one thread owns each pair (j, j + d) with bit d of j clear, reads ONE
// mask word and swaps the pair in shared memory: no second buffer, and
// only a __syncthreads() between stages.  Stages with d < 2^K stay
// inside aligned 2^K-element tiles (benes_mid: one block per tile);
// stages with d >= 2^K exchange rows g <-> g ^ (d >> K) of the
// (2^(n-K), 2^K) view (benes_outer: a block owns CH columns across all
// rows).  Placement runs them on an iota of tile-local positions (mid) or
// of rows (outer), moved as raw 16-bit words.  Per launch they read x,
// write y (2·N·e) and read the mask planes (planes·N·4); mask words are
// re-read from L1/L2 at each stage.
//
// Values are moved as raw 16- or 32-bit words, so bf16 and f32 are exact
// by construction.  x and y may be the same buffer: each block reads its
// whole region (tile or column chunk) into shared memory before it writes
// any of it, and no two blocks share a region.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxStages = 64;

// One stage: plane << 16 | bit << 8 | log2(distance).
struct StageList {
  int n;
  int code[kMaxStages];
};

template <typename E>
__global__ void benes_mid_kernel(const E* x, E* y,
                                 const int32_t* __restrict__ words,
                                 long long plane_stride, int K,
                                 StageList st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* s = reinterpret_cast<E*>(smem_raw);
  const int T = 1 << K;
  const long long base = static_cast<long long>(blockIdx.x) << K;
  for (int j = threadIdx.x; j < T; j += blockDim.x) s[j] = x[base + j];
  __syncthreads();
  const int half = T >> 1;
  for (int k = 0; k < st.n; ++k) {
    const int code = st.code[k];
    const int plane = code >> 16;
    const int bit = (code >> 8) & 0xff;
    const int logd = code & 0xff;
    const int d = 1 << logd;
    const int32_t* w = words + plane * plane_stride + base;
    for (int p = threadIdx.x; p < half; p += blockDim.x) {
      const int j = ((p >> logd) << (logd + 1)) | (p & (d - 1));
      if ((__ldg(w + j) >> bit) & 1) {
        const E a = s[j];
        s[j] = s[j + d];
        s[j + d] = a;
      }
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < T; j += blockDim.x) y[base + j] = s[j];
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

template <typename E>
__global__ void benes_outer_kernel(const E* x, E* y,
                                   const int32_t* __restrict__ words, int K,
                                   int g2_log, int ch_log, StageList st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  E* s = reinterpret_cast<E*>(smem_raw);   // s[g * CH + c]
  const int CH = 1 << ch_log;
  const int cells = 1 << (g2_log + ch_log);
  const long long M = 1LL << K;
  const long long c0 = static_cast<long long>(blockIdx.x) << ch_log;
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int g = idx >> ch_log;
    const int c = idx & (CH - 1);
    s[idx] = x[g * M + c0 + c];
  }
  __syncthreads();
  const int pairs = cells >> 1;
  for (int k = 0; k < st.n; ++k) {
    const int code = st.code[k];
    const int bit = (code >> 8) & 0xff;
    const int logt = (code & 0xff) - K;
    const int t = 1 << logt;
    for (int q = threadIdx.x; q < pairs; q += blockDim.x) {
      const int c = q & (CH - 1);
      const int gp = q >> ch_log;
      const int g = ((gp >> logt) << (logt + 1)) | (gp & (t - 1));
      if ((__ldg(words + g * M + c0 + c) >> bit) & 1) {
        const int a_i = (g << ch_log) + c;
        const int b_i = ((g + t) << ch_log) + c;
        const E a = s[a_i];
        s[a_i] = s[b_i];
        s[b_i] = a;
      }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < cells; idx += blockDim.x) {
    const int g = idx >> ch_log;
    const int c = idx & (CH - 1);
    y[g * M + c0 + c] = s[idx];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

template <typename E>
cudaError_t launch_mid(const void* x, void* y, const void* words,
                       long long plane_stride, long long n_elems, int K,
                       const StageList& st, cudaStream_t stream) {
  const int T = 1 << K;
  const int threads = T / 2 < 32 ? 32 : (T / 2 > 1024 ? 1024 : T / 2);
  const size_t smem = static_cast<size_t>(T) * sizeof(E);
  cudaError_t err = cudaFuncSetAttribute(
      benes_mid_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(n_elems >> K);
  benes_mid_kernel<E><<<blocks, threads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y),
      static_cast<const int32_t*>(words), plane_stride, K, st);
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

template <typename E>
cudaError_t launch_outer(const void* x, void* y, const void* words,
                         long long n_elems, int K, const StageList& st,
                         cudaStream_t stream) {
  const int n = log2_exact(n_elems);
  const int g2_log = n - K;
  // about 64 KB of values a block: 2^14 f32 or 2^15 bf16 cells
  const int cells_log = sizeof(E) == 4 ? 14 : 15;
  int ch_log = cells_log - g2_log;
  if (ch_log < 0) ch_log = 0;
  if (ch_log > K) ch_log = K;
  const int cells = 1 << (g2_log + ch_log);
  const int threads = cells / 2 < 32 ? 32 : (cells / 2 > 512 ? 512 : cells / 2);
  const size_t smem = static_cast<size_t>(cells) * sizeof(E);
  cudaError_t err = cudaFuncSetAttribute(
      benes_outer_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned blocks = static_cast<unsigned>(1LL << (K - ch_log));
  benes_outer_kernel<E><<<blocks, threads, smem, stream>>>(
      static_cast<const E*>(x), static_cast<E*>(y),
      static_cast<const int32_t*>(words), K, g2_log, ch_log, st);
  return cudaGetLastError();
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

}  // namespace

extern "C" {

// All middle stages (d < 2^K) of a Benes network over n_elems = 2^n
// values of elem_bytes (2 or 4) bytes each; one block per 2^K tile.
// words: (planes, n_elems) int32, plane p starting at p * plane_stride.
// codes: n_codes host ints, plane << 16 | bit << 8 | log2(d).
// Returns the CUDA error of the launch (0 on success).
int benes_mid(const void* x, void* y, const void* words,
              long long plane_stride, long long n_elems, int K,
              int elem_bytes, const int* codes, int n_codes, void* stream) {
  StageList st;
  const int n = log2_exact(n_elems);
  if (!fill_stages(codes, n_codes, &st) || n < 1 || K < 1 || K > n)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_mid<uint32_t>(x, y, words, plane_stride, n_elems, K, st, s);
  if (elem_bytes == 2)
    return launch_mid<uint16_t>(x, y, words, plane_stride, n_elems, K, st, s);
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
// of rows g <-> g ^ (d >> K) on the (2^(n-K), 2^K) view; words: one
// (n_elems,) int32 plane.  Placement runs it on an iota of rows to compose
// the side's row index.  Returns the CUDA error of the launch.
int benes_outer(const void* x, void* y, const void* words,
                long long n_elems, int K, int elem_bytes, const int* codes,
                int n_codes, void* stream) {
  StageList st;
  const int n = log2_exact(n_elems);
  if (!fill_stages(codes, n_codes, &st) || n < 1 || K < 1 || K >= n ||
      n - K > 15)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (elem_bytes == 4)
    return launch_outer<uint32_t>(x, y, words, n_elems, K, st, s);
  if (elem_bytes == 2)
    return launch_outer<uint16_t>(x, y, words, n_elems, K, st, s);
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
