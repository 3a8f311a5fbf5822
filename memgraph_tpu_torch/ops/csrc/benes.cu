// Benes network passes on Hopper (sm_90a), with a plain C interface for
// ctypes (memgraph_tpu_torch/ops/benes_cuda.py binds and checks them).
//
// Replaces the two Pallas TPU kernels of memgraph_tpu/ops/benes_pallas.py:
//   benes_mid   <- _mid_kernel   (benes_pallas.py:138, launched at :225)
//   benes_outer <- _outer_kernel (benes_pallas.py:155, launched at :208)
//
// What both compute: for every live stage (plane, bit, d) in order, each
// position i does  x[i] <- ((word[i] >> bit) & 1) ? x[i ^ d] : x[i].
// The routed masks are symmetric (word bit of i == word bit of i ^ d), so
// one thread owns each pair (j, j + d) with bit d of j clear, reads ONE
// mask word and swaps the pair in shared memory: no second buffer, and
// only a __syncthreads() between stages.  Stages with d < 2^K stay
// inside aligned 2^K-element tiles (benes_mid: one block per tile);
// stages with d >= 2^K exchange rows g <-> g ^ (d >> K) of the
// (2^(n-K), 2^K) view (benes_outer: a block owns CH columns across all
// rows).  Values are moved as raw 16- or 32-bit words, so bf16 and f32
// are exact by construction.
//
// What bounds them: memory traffic.  Per launch, with e bytes a value:
//   benes_mid:   read x + write y (2·N·e) + read the mid planes (planes·N·4)
//   benes_outer: read x + write y (2·N·e) + read the outer plane (N·4)
// There is no arithmetic to speak of.  The design reads and writes every
// value once per launch, holding a whole tile (or column chunk) in shared
// memory through all of the launch's stages, so the 2K-1 middle stages
// cost one round trip instead of 2K-1.  Mask words are re-read from
// L1/L2 at each stage (the first read of a tile's words comes from
// device memory); fewer mask bits, TMA and wider loads are later work.
//
// x and y may be the same buffer: each block reads its whole region into
// shared memory before it writes any of it, and no two blocks share a
// region.

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

// The outer stages (d >= 2^K) of one side of the network, as exchanges
// of rows g <-> g ^ (d >> K) on the (2^(n-K), 2^K) view; words: one
// (n_elems,) int32 plane.  Returns the CUDA error of the launch.
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

const char* benes_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
