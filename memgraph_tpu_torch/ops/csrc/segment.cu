// Deterministic segment sums on Hopper (sm_90a), with a plain C interface
// for ctypes (memgraph_tpu_torch/ops/segment_cuda.py binds and checks them).
//
// No Pallas kernel lies behind these: the JAX package reduces its semiring
// sums with jax.ops.segment_sum(indices_are_sorted=True), a deterministic
// XLA reduction (memgraph_tpu/ops/semiring.py:edge_reduce), and the port's
// index_add_ is float atomics on CUDA, whose order changes from run to run.
// These kernels fix the order, so that a sum gives the same bits on every
// run, on the card and in the plain PyTorch version on the CPU, and the same
// bits for a column whether it is reduced alone or beside other lanes.
//
// csr_spmm_sum (K1): y[j, l] = sum over e in [ptr[j], ptr[j+1]) of
// r(x[g[e], l] (x) w[e]), summed in run order from 0.0:
//   - (x) is times (w read) or first (no w);
//   - r is the identity (f32) or rounding to bfloat16 and back (bf16);
//   - g may be absent: x then holds one row a run element (precomputed
//     per-edge values, the masked and generic paths of semiring.spmv);
//   - x is (n_in, B) row-major, B >= 1 lanes, contiguous lanes.
// The product and the sum are rounded separately (__fmul_rn, __fadd_rn):
// no FMA contraction, as the JAX package rounds the product and then the
// sum and as the CPU's index_add_ in edge order does.  So the result is
// bit-equal to the plain version and does not depend on B.
// Design (first, simple): one thread a (destination, lane), lanes
// contiguous, so for B >= 32 a warp's gathered row of x is one coalesced
// read; for B = 1 a warp walks 32 neighbouring runs.  A run is walked in
// groups of 32 (then 8, then 1) contributions, each group's loads issued
// before its adds, so that their latencies overlap; the adds stay in run
// order.  Bound by bytes: each edge's index and weight and B gathered
// values, and n_seg * B values written.  A skewed in-degree (the north
// star's node 0 has about 10^4 in-edges) is one thread's serial walk,
// about a DRAM latency a group: the run is not split, because a split
// would change the order.
//
// lane_sum (K2): (n, B) -> (B,) in one fixed order that does not depend on
// B: rows are cut into chunks of 256 (the last padded with 0.0), each
// chunk reduced by the halving tree s[r] += s[r + h], h = 128 .. 1, then
// the chunk partials are reduced the same way, level by level, until one
// is left.  The first level reads one of three forms: sum(v), sum(v * m)
// (m one value a row) and sum(|a - b|).  A block holds one chunk of up to
// 32 lanes in shared memory (32 KB).  Bound by bytes: the inputs read
// once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWide = 32;
constexpr int kUnroll = 8;
constexpr int kChunk = 256;       // rows a lane_sum block reduces
constexpr int kLaneTile = 32;     // lanes a lane_sum block holds

enum Mul { kFirst = 0, kTimes = 1 };
enum Form { kSum = 0, kDot = 1, kL1 = 2 };

template <typename G, bool kGather, int kMul, bool kBf16>
__device__ __forceinline__ float contribution(
    const float* __restrict__ x, const G* __restrict__ g,
    const float* __restrict__ w, int64_t e, int B, int l) {
  const int64_t row = kGather ? static_cast<int64_t>(g[e]) : e;
  float v = x[row * B + l];
  if (kMul == kTimes) v = __fmul_rn(v, w[e]);
  if (kBf16) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename P, typename G, bool kGather, int kMul, bool kBf16>
__global__ void __launch_bounds__(kThreads) csr_spmm_sum_kernel(
    const float* __restrict__ x, const P* __restrict__ ptr,
    const G* __restrict__ g, const float* __restrict__ w,
    float* __restrict__ y, int64_t n_seg, int B) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= n_seg * B) return;
  const int64_t j = t / B;
  const int l = static_cast<int>(t - j * B);
  const int64_t end = static_cast<int64_t>(ptr[j + 1]);
  int64_t e = static_cast<int64_t>(ptr[j]);
  float acc = 0.0f;
  // groups of 32, then of 8, then one: a group's loads are all issued
  // before its adds, which stay in run order
  for (; e + kWide <= end; e += kWide) {
    float v[kWide];
#pragma unroll
    for (int k = 0; k < kWide; ++k)
      v[k] = contribution<G, kGather, kMul, kBf16>(x, g, w, e + k, B, l);
#pragma unroll
    for (int k = 0; k < kWide; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; e + kUnroll <= end; e += kUnroll) {
    float v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      v[k] = contribution<G, kGather, kMul, kBf16>(x, g, w, e + k, B, l);
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) acc = __fadd_rn(acc, v[k]);
  }
  for (; e < end; ++e)
    acc = __fadd_rn(acc,
                    contribution<G, kGather, kMul, kBf16>(x, g, w, e, B, l));
  y[t] = acc;
}

template <typename P, typename G, bool kGather>
cudaError_t launch_spmm(const float* x, const void* ptr, const void* g,
                        const float* w, float* y, int64_t n_seg, int B,
                        int mul, int bf16, cudaStream_t stream) {
  const int64_t total = n_seg * B;
  const unsigned blocks =
      static_cast<unsigned>((total + kThreads - 1) / kThreads);
  if (total == 0) return cudaSuccess;
  const P* p = static_cast<const P*>(ptr);
  const G* gg = static_cast<const G*>(g);
#define MG_SPMM(MUL, BF)                                                     \
  csr_spmm_sum_kernel<P, G, kGather, MUL, BF>                                \
      <<<blocks, kThreads, 0, stream>>>(x, p, gg, w, y, n_seg, B)
  if (mul == kTimes) {
    if (bf16) MG_SPMM(kTimes, true); else MG_SPMM(kTimes, false);
  } else {
    if (bf16) MG_SPMM(kFirst, true); else MG_SPMM(kFirst, false);
  }
#undef MG_SPMM
  return cudaGetLastError();
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) lane_sum_level(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, float* __restrict__ out, int64_t rows,
    int B) {
  __shared__ float s[kChunk * kLaneTile];
  const int64_t chunk = blockIdx.x;
  const int l0 = blockIdx.y * kLaneTile;
  const int lt = min(kLaneTile, B - l0);
  const int tid = threadIdx.x;
  for (int i = tid; i < kChunk * lt; i += kThreads) {
    const int r = i / lt, c = i - (i / lt) * lt;
    const int64_t row = chunk * kChunk + r;
    float v = 0.0f;
    if (row < rows) {
      const int64_t at = row * B + l0 + c;
      if (kForm == kSum) v = a[at];
      else if (kForm == kDot) v = __fmul_rn(a[at], m[row]);
      else v = fabsf(__fsub_rn(a[at], b[at]));
    }
    s[r * lt + c] = v;
  }
  for (int h = kChunk / 2; h >= 1; h >>= 1) {
    __syncthreads();
    for (int i = tid; i < h * lt; i += kThreads) {
      const int r = i / lt, c = i - (i / lt) * lt;
      s[r * lt + c] = __fadd_rn(s[r * lt + c], s[(r + h) * lt + c]);
    }
  }
  __syncthreads();
  if (tid < lt) out[chunk * B + l0 + tid] = s[tid];
}

}  // namespace

extern "C" {

// K1.  x: (n_in, B) f32; ptr: n_seg + 1 offsets (int32 if ptr64 == 0, else
// int64); g: run-element -> row of x (int32 if g64 == 0, else int64) or
// null (x has a row a run element); w: one f32 a run element (mul == 1) or
// null; y: (n_seg, B) f32.  Returns the launch's CUDA error code.
int csr_spmm_sum(const float* x, const void* ptr, int ptr64, const void* g,
                 int g64, const float* w, float* y, long long n_seg, int B,
                 int mul, int bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || n_seg < 0 || (mul == kTimes && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t rc;
  if (g == nullptr) {
    rc = ptr64 ? launch_spmm<int64_t, int32_t, false>(x, ptr, g, w, y, n_seg,
                                                      B, mul, bf16, st)
               : launch_spmm<int32_t, int32_t, false>(x, ptr, g, w, y, n_seg,
                                                      B, mul, bf16, st);
  } else if (ptr64) {
    rc = g64 ? launch_spmm<int64_t, int64_t, true>(x, ptr, g, w, y, n_seg, B,
                                                   mul, bf16, st)
             : launch_spmm<int64_t, int32_t, true>(x, ptr, g, w, y, n_seg, B,
                                                   mul, bf16, st);
  } else {
    rc = g64 ? launch_spmm<int32_t, int64_t, true>(x, ptr, g, w, y, n_seg, B,
                                                   mul, bf16, st)
             : launch_spmm<int32_t, int32_t, true>(x, ptr, g, w, y, n_seg, B,
                                                   mul, bf16, st);
  }
  return static_cast<int>(rc);
}

// K2.  a (and b): (rows, B) f32; m: rows f32 (form 1) or null; out: B f32.
// scratch: two buffers of ceil(rows / 256) * B floats each, for the chunk
// partials of the levels after the first.  form: 0 sum(a), 1 sum(a * m),
// 2 sum(|a - b|).  One launch a level; returns the first CUDA error.
int lane_sum(const float* a, const float* b, const float* m, float* out,
             float* scratch0, float* scratch1, long long rows, int B,
             int form, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || rows < 0 || form < 0 || form > 2 ||
      (form == kDot && m == nullptr) || (form == kL1 && b == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned lane_tiles = (B + kLaneTile - 1) / kLaneTile;
  const float* in = a;
  float* bufs[2] = {scratch0, scratch1};
  int level = 0;
  int64_t n = rows;
  while (true) {
    const int64_t chunks = n > 0 ? (n + kChunk - 1) / kChunk : 1;
    float* dst = chunks == 1 ? out : bufs[level & 1];
    const dim3 grid(static_cast<unsigned>(chunks), lane_tiles);
    const int f = level == 0 ? form : kSum;
    if (f == kSum)
      lane_sum_level<kSum><<<grid, kThreads, 0, st>>>(in, b, m, dst, n, B);
    else if (f == kDot)
      lane_sum_level<kDot><<<grid, kThreads, 0, st>>>(in, b, m, dst, n, B);
    else
      lane_sum_level<kL1><<<grid, kThreads, 0, st>>>(in, b, m, dst, n, B);
    const cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return static_cast<int>(rc);
    if (chunks == 1) return 0;
    in = dst;
    n = chunks;
    ++level;
  }
}

const char* segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
