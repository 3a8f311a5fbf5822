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
// Bound by bytes: each edge's index and weight and B gathered values, and
// n_seg * B values written.  The adds of a run form one dependent chain
// (its order is the contract), so a skewed in-degree (the north star's
// node 0 has about 10^4 in-edges) sets a floor of a chain of adds; what
// the design spreads is the loads.  One launch.  When the caller knows
// that no run is longer than kLong (a graph records its longest runs once,
// ops/csr.py), it is a thread a (run, lane) and nothing else; else it has
// two roles by block:
//   - the first long_blocks blocks (two an SM): long runs (more than kLong
//     elements).
//     Their first kWalkers warps split the (run, lane tile) items by a
//     stride (item q to warp q mod W), so the heavy runs of a skewed
//     graph, which sit side by side, land on different warps; each reads the
//     offsets of its items, picks the long ones by a ballot and walks each
//     in turn with all 32 lanes.  A tile is 2^cw_log2 lanes (1, 2, 4, 8 for
//     B = 1, 2, 3-4, more), a chunk the 32 >> cw_log2 run elements the warp
//     copies at once: lane (i, c) copies element i's index, weight and
//     column c by cp.async into a ring in shared memory, kDepth chunks
//     ahead of the adds (a commit group a chunk, cp.async.wait_group for
//     the oldest), and every lane of column c adds the chunk's products
//     in element order.
//   - the other blocks: a thread a (run, lane), lanes contiguous, so for
//     B >= 32 a warp's gathered row of x is one coalesced read; the run's
//     loads issued in groups before their adds.  A thread whose run is
//     long leaves it to the long role.
// The launch shape (all short or two roles, the lane tile, long_blocks) is
// decided here, in csr_spmm_sum, from B, the caller's longest run and the
// SM count.  A longest run given too small only slows the call: the
// thread-a-(run, lane) walk sums a run of any length in the same order.
// No float atomics and no list of long runs: which warp walks a run does
// not change the order of its adds.
//
// lane_sum (K2): (n, B) -> (B,) in one fixed order that does not depend on
// B: rows are cut into chunks of 256 (the last padded with 0.0), each
// chunk reduced by the halving tree s[r] += s[r + h], h = 128 .. 1, then
// the chunk partials are reduced the same way, level by level, until one
// is left.  The first level reads one of three forms: sum(v), sum(v * m)
// (m one value a row) and sum(|a - b|).  Bound by bytes: the inputs read
// once.  One launch for every level:
//   - a warp reduces a chunk of one column in registers: lane t holds rows
//     32k + t (k = 0 .. 7), so h = 128, 64, 32 are v[k] += v[k + 4],
//     v[k] += v[k + 2], v[0] += v[1] and h = 16 .. 1 are __shfl_down_sync:
//     exactly the tree's pairs.  Up to kWarpLanes lanes a warp takes a
//     (chunk, column) and reads its rows straight from device memory (the
//     block's warps share the rows' sectors through L1); wider B stages a
//     block's chunk of up to 32 lanes in shared memory (odd row pitch, no
//     bank conflict) and gives each warp a column.
//   - the levels after the first: the warp (or block) that arrives last at
//     a chunk of the next level (an integer ticket, atomicInc, which wraps
//     the counter back to 0 for the next call) reduces it, from partials
//     read through L2 after a fence.  The counters start at zero once (the
//     caller's zeroed buffer, one a stream) and every call leaves them so.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kWide = 32;
constexpr int kUnroll = 8;
constexpr int kLong = 128;        // a longer run is walked by a warp
constexpr int kScan = 4;          // items a lane scans at once (long role)
constexpr int kWalkers = 4;       // warps of a long-role block that walk
constexpr int kChunk = 256;       // rows a lane_sum chunk holds
constexpr int kLaneTile = 32;     // lanes a lane_sum block holds
constexpr int kWarpLanes = 8;     // up to this B, lane_sum runs by warps
constexpr int kMaxLevels = 8;

enum Mul { kFirst = 0, kTimes = 1 };
enum Form { kSum = 0, kDot = 1, kL1 = 2 };

__device__ __forceinline__ int64_t offset(const void* ptr, int ptr64,
                                          int64_t j) {
  return ptr64 ? static_cast<const int64_t*>(ptr)[j]
               : static_cast<int64_t>(static_cast<const int32_t*>(ptr)[j]);
}

template <int kMul, bool kBf16>
__device__ __forceinline__ float combine(float v, float wv) {
  if (kMul == kTimes) v = __fmul_rn(v, wv);
  if (kBf16) v = __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

template <typename G, bool kGather, int kMul, bool kBf16>
__device__ __forceinline__ float contribution(
    const float* __restrict__ x, const G* __restrict__ g,
    const float* __restrict__ w, int64_t e, int B, int l) {
  const int64_t row = kGather ? static_cast<int64_t>(g[e]) : e;
  return combine<kMul, kBf16>(x[row * B + l],
                              kMul == kTimes ? w[e] : 0.0f);
}

// Short role: thread t sums (run t / B, lane t % B); beside a long role
// (kSkipLong), only if the run is short.  offset_of(j) reads ptr[j].
template <typename G, bool kGather, int kMul, bool kBf16, bool kSkipLong,
          typename Offset>
__device__ __forceinline__ void short_run(
    const float* __restrict__ x, Offset offset_of,
    const G* __restrict__ g, const float* __restrict__ w,
    float* __restrict__ y, int64_t n_seg, int B, int64_t t) {
  if (t >= n_seg * B) return;
  const int64_t j = t / B;
  const int l = static_cast<int>(t - j * B);
  const int64_t end = offset_of(j + 1);
  int64_t e = offset_of(j);
  if (kSkipLong && end - e > kLong) return;
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

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// A long-run warp's ring in shared memory: kDepth chunks in flight, each a
// group of cp.async copies (a chunk's 32 gathered values, its weights, and
// the indices of the chunk kDepth further on).  The ring is static shared
// memory, so every block of the launch holds kWalkers of them and the
// short role's L1 shrinks with them (measured: the CSR runs, which have no
// long run, paid for it, so a launch whose runs are all short takes
// csr_spmm_short_kernel, which holds none); up to 4 lanes 4 chunks, 8
// lanes a tile (4 sectors a chunk) 8.
template <int kCwLog2>
__host__ __device__ constexpr int depth_of() { return kCwLog2 == 3 ? 8 : 4; }

template <typename G, int kDepth>
struct Ring {
  float x[kDepth][32];   // slot k: column c's values at c * kE + i
  float w[kDepth][32];   // slot k: element i's weight
  G g[kDepth][32];       // slot k: element i's index of the next chunk
};

// Long role, one walk: the whole warp sums lanes [tile * kCw, + kCw) of run
// j = [lo, hi).  Lane (i, c) = (lane >> kCwLog2, lane & (kCw - 1)) copies
// run element lo + i + kE * t (chunk t), column c, into the ring by
// cp.async, kDepth chunks ahead of the adds: the copies of chunk t are one
// commit group, and cp.async.wait_group waits for the oldest group alone
// (a ring of loads into registers measured one memory latency a chunk,
// whatever its depth).  Every lane of column c then adds chunk s's
// products, read back 4 at a time, in element order; an element past the
// run's end gives +0.0, whose add leaves the sum's bits as they are (from
// 0.0, a sum of round-to-nearest adds is never -0.0).
template <int kCwLog2, typename G, bool kGather, int kMul, bool kBf16>
__device__ __forceinline__ void long_run(
    const float* __restrict__ x, const G* __restrict__ g,
    const float* __restrict__ w, float* __restrict__ y, int B, int64_t j,
    int tile, int64_t lo, int64_t hi, int lane,
    Ring<G, depth_of<kCwLog2>()>& r) {
  constexpr int kDepth = depth_of<kCwLog2>();
  constexpr int kCw = 1 << kCwLog2;
  constexpr int kE = 32 >> kCwLog2;          // run elements a chunk
  const int c = lane & (kCw - 1);
  const int i = lane >> kCwLog2;
  const int col = tile * kCw + c;
  const bool live = col < B;
  const int64_t n = hi - lo;
  const int64_t chunks = (n + kE - 1) / kE;
  // chunk t's indices into index slot k (the lanes of column 0)
  auto copy_index = [&](int64_t t, int k) {
    const int64_t e = lo + t * kE + i;
    if (kGather && c == 0 && e < hi) cp_async(&r.g[k][i], g + e, sizeof(G));
  };
  // chunk t's values and weights into slot k; its indices are in index
  // slot k, which then takes chunk t + kDepth's
  auto copy_chunk = [&](int64_t t, int k) {
    const int64_t e = lo + t * kE + i;
    const int64_t row = kGather ? static_cast<int64_t>(r.g[k][i]) : e;
    __syncwarp();
    if (e < hi) {
      if (live) cp_async(&r.x[k][c * kE + i], x + row * B + col, 4);
      if (kMul == kTimes && c == 0) cp_async(&r.w[k][i], w + e, 4);
    }
    copy_index(t + kDepth, k);
    cp_async_commit();
  };
  for (int k = 0; k < kDepth; ++k) copy_index(k, k);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  for (int k = 0; k < kDepth; ++k) copy_chunk(k, k);
  float acc = 0.0f;
  for (int64_t s = 0; s < chunks; ++s) {
    const int k = static_cast<int>(s % kDepth);
    cp_async_wait<kDepth - 1>();
    __syncwarp();
    // each lane turns its element's value into its product in place (+0.0
    // past the run's end), then every lane of column c reads the chunk's
    // products back, all the reads issued before the adds
    float& mine_x = r.x[k][c * kE + i];
    mine_x = s * kE + i < n
                 ? combine<kMul, kBf16>(mine_x, kMul == kTimes ? r.w[k][i]
                                                               : 0.0f)
                 : 0.0f;
    __syncwarp();
    const float4* p4 = reinterpret_cast<const float4*>(&r.x[k][c * kE]);
    float4 p[kE / 4];
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) p[q] = p4[q];
#pragma unroll
    for (int q = 0; q < kE / 4; ++q) {
      acc = __fadd_rn(acc, p[q].x);
      acc = __fadd_rn(acc, p[q].y);
      acc = __fadd_rn(acc, p[q].z);
      acc = __fadd_rn(acc, p[q].w);
    }
    copy_chunk(s + kDepth, k);
  }
  cp_async_wait<0>();
  __syncwarp();
  if (i == 0 && live) y[j * B + col] = acc;
}

template <typename T>
__device__ __forceinline__ T pick(const T (&v)[kScan], int u) {
  T r = v[0];
#pragma unroll
  for (int k = 1; k < kScan; ++k)
    if (u == k) r = v[k];
  return r;
}

// Long role: warp `warp` of n_warps takes the items q = warp + n_warps * m,
// item q = (run q / tiles, tile q % tiles), and walks the long ones in the
// order of m.
template <int kCwLog2, typename G, bool kGather, int kMul, bool kBf16>
__device__ __forceinline__ void long_role(
    const float* __restrict__ x, const void* ptr, int ptr64,
    const G* __restrict__ g, const float* __restrict__ w,
    float* __restrict__ y, int64_t n_seg, int B, int64_t warp,
    int64_t n_warps) {
  __shared__ __align__(16) Ring<G, depth_of<kCwLog2>()> rings[kWalkers];
  if (threadIdx.x / 32 >= kWalkers) return;
  auto& ring = rings[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  const int tiles = (B + (1 << kCwLog2) - 1) >> kCwLog2;
  const int64_t items = n_seg * tiles;
  for (int64_t m0 = 0; warp + m0 * n_warps < items; m0 += 32 * kScan) {
    long long q[kScan], lo[kScan], hi[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      q[u] = warp + (m0 + 32 * u + lane) * n_warps;
      lo[u] = hi[u] = 0;
      if (q[u] < items) {
        const int64_t j = q[u] / tiles;
        lo[u] = offset(ptr, ptr64, j);
        hi[u] = offset(ptr, ptr64, j + 1);
      }
    }
    // one call site: the walk is inlined once
#pragma unroll 1
    for (int u = 0; u < kScan; ++u) {
      const long long qu = pick(q, u), lu = pick(lo, u), hu = pick(hi, u);
      unsigned todo = __ballot_sync(0xffffffffu, hu - lu > kLong);
      while (todo) {
        const int src = __ffs(todo) - 1;
        todo &= todo - 1;
        const long long qq = __shfl_sync(0xffffffffu, qu, src);
        const int64_t j = qq / tiles;
        long_run<kCwLog2, G, kGather, kMul, kBf16>(
            x, g, w, y, B, j, static_cast<int>(qq - j * tiles),
            __shfl_sync(0xffffffffu, lu, src),
            __shfl_sync(0xffffffffu, hu, src), lane, ring);
      }
    }
  }
}

// Blocks [0, long_blocks) take the long role, the rest a thread a (run,
// lane).  4 blocks an SM (64 registers a thread) up to B = 4, 5 past it
// (48): the short role's gathers want the occupancy, the long role's walk
// the registers, and the two weigh differently by B (measured).
template <int kCwLog2, typename G, bool kGather, int kMul, bool kBf16>
__global__ void __launch_bounds__(kThreads, kCwLog2 == 3 ? 5 : 4)
    csr_spmm_sum_kernel(
    const float* __restrict__ x, const void* ptr, int ptr64,
    const G* __restrict__ g, const float* __restrict__ w,
    float* __restrict__ y, int64_t n_seg, int B, int long_blocks) {
  if (static_cast<int>(blockIdx.x) < long_blocks) {
    long_role<kCwLog2, G, kGather, kMul, kBf16>(
        x, ptr, ptr64, g, w, y, n_seg, B,
        static_cast<int64_t>(blockIdx.x) * kWalkers + threadIdx.x / 32,
        static_cast<int64_t>(long_blocks) * kWalkers);
  } else {
    short_run<G, kGather, kMul, kBf16, true>(
        x, [=](int64_t j) { return offset(ptr, ptr64, j); }, g, w, y, n_seg,
        B, static_cast<int64_t>(blockIdx.x - long_blocks) * kThreads +
               threadIdx.x);
  }
}

// Every run short: a thread a (run, lane) alone, with no ring in shared
// memory and offsets of their own type (the north star's CSR runs, at most
// 29).  kMinBlocks an SM: 3 at one lane (up to 80 registers: a thread's
// group of loads in flight), 8 past it (32: more warps, each lane of a
// run's row its own thread); measured on the north star's CSR runs
// against 4, 5, 6 and no cap.
template <int kMinBlocks, typename P, typename G, bool kGather, int kMul,
          bool kBf16>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    csr_spmm_short_kernel(
    const float* __restrict__ x, const P* __restrict__ ptr,
    const G* __restrict__ g, const float* __restrict__ w,
    float* __restrict__ y, int64_t n_seg, int B) {
  short_run<G, kGather, kMul, kBf16, false>(
      x, [=](int64_t j) { return static_cast<int64_t>(ptr[j]); }, g, w, y,
      n_seg, B, static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x);
}

template <int kMul, bool kBf16, typename G, bool kGather>
cudaError_t launch_spmm(int cw_log2, int long_blocks, cudaStream_t st,
                        const float* x, const void* ptr, int ptr64,
                        const void* gv, const float* w, float* y,
                        int64_t n_seg, int B) {
  const int64_t blocks = long_blocks + (n_seg * B + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return cudaErrorInvalidConfiguration;
  const G* g = static_cast<const G*>(gv);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (long_blocks == 0) {
#define MG_SHORT(NB, P)                                                      \
  csr_spmm_short_kernel<NB, P, G, kGather, kMul, kBf16>                      \
      <<<grid, kThreads, 0, st>>>(x, static_cast<const P*>(ptr), g, w, y,    \
                                  n_seg, B)
    if (B == 1) {
      if (ptr64) MG_SHORT(3, int64_t); else MG_SHORT(3, int32_t);
    } else {
      if (ptr64) MG_SHORT(8, int64_t); else MG_SHORT(8, int32_t);
    }
#undef MG_SHORT
    return cudaGetLastError();
  }
#define MG_SPMM(CW)                                                          \
  csr_spmm_sum_kernel<CW, G, kGather, kMul, kBf16>                           \
      <<<grid, kThreads, 0, st>>>(x, ptr, ptr64, g, w, y, n_seg, B,          \
                                  long_blocks)
  switch (cw_log2) {
    case 0: MG_SPMM(0); break;
    case 1: MG_SPMM(1); break;
    case 2: MG_SPMM(2); break;
    default: MG_SPMM(3); break;
  }
#undef MG_SPMM
  return cudaGetLastError();
}

template <typename G, bool kGather>
cudaError_t launch_forms(int mul, int bf16, int cw_log2, int long_blocks,
                         cudaStream_t st, const float* x, const void* ptr,
                         int ptr64, const void* g, const float* w, float* y,
                         int64_t n_seg, int B) {
#define MG_SPMM(MUL, BF)                                                     \
  launch_spmm<MUL, BF, G, kGather>(cw_log2, long_blocks, st, x, ptr, ptr64,  \
                                   g, w, y, n_seg, B)
  if (mul == kTimes) return bf16 ? MG_SPMM(kTimes, true)
                                 : MG_SPMM(kTimes, false);
  return bf16 ? MG_SPMM(kFirst, true) : MG_SPMM(kFirst, false);
#undef MG_SPMM
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// The levels of one call: level l reduces rows[l] input rows (level 0: a,
// b, m in their form; l >= 1: buf[l], the partials of level l - 1) into
// chunks written to buf[l + 1] (buf[n] is out); cnt[l] (l >= 1) holds a
// ticket counter per chunk of level l and lane tile.
struct LaneLevels {
  int n;
  long long rows[kMaxLevels];
  float* buf[kMaxLevels + 1];
  unsigned* cnt[kMaxLevels];
};

// The tree of a chunk, lane t holding rows 32k + t in v[k]; lane 0's result.
__device__ __forceinline__ float chunk_tree(float (&v)[8]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = __fadd_rn(v[k], v[k + 4]);   // h = 128
#pragma unroll
  for (int k = 0; k < 2; ++k) v[k] = __fadd_rn(v[k], v[k + 2]);   // h = 64
  v[0] = __fadd_rn(v[0], v[1]);                                   // h = 32
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1)
    v[0] = __fadd_rn(v[0], __shfl_down_sync(0xffffffffu, v[0], h));
  return v[0];
}

// Row `row`, column offset `at` of a level's input: the first level's form,
// or (kPartial) a partial written by another block, read through L2.
template <int kForm, bool kPartial>
__device__ __forceinline__ float level_value(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, int64_t at, int64_t row) {
  if (kPartial) return __ldcg(a + at);
  if (kForm == kSum) return a[at];
  if (kForm == kDot) return __fmul_rn(a[at], m[row]);
  return fabsf(__fsub_rn(a[at], b[at]));
}

__host__ __device__ __forceinline__ int64_t chunks_of(int64_t rows) {
  return rows > 0 ? (rows + kChunk - 1) / kChunk : 1;
}

// One warp reduces chunk `chunk` of column `col` of (rows, B); lane 0
// writes it.
template <int kForm, bool kPartial>
__device__ __forceinline__ void warp_chunk(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, float* dst, int64_t rows, int B,
    int64_t chunk, int col, int lane) {
  float v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int64_t row = chunk * kChunk + 32 * k + lane;
    v[k] = row < rows
               ? level_value<kForm, kPartial>(a, b, m, row * B + col, row)
               : 0.0f;
  }
  const float r = chunk_tree(v);
  if (lane == 0) dst[chunk * B + col] = r;
}

// B > 1: the block stages chunk `chunk`, lanes [32 tile, + 32) of (rows, B)
// in shared memory (row pitch odd: lane t's reads of a column fall in
// distinct banks); warp w reduces columns w, w + 8, ...
template <int kForm, bool kPartial>
__device__ __forceinline__ void block_chunk(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, float* dst, int64_t rows, int B,
    int64_t chunk, int tile, float* s) {
  const int l0 = tile * kLaneTile;
  const int lt = min(kLaneTile, B - l0);
  const int pitch = lt | 1;
  for (int i = threadIdx.x; i < kChunk * lt; i += kThreads) {
    const int r = i / lt, c = i - (i / lt) * lt;
    const int64_t row = chunk * kChunk + r;
    s[r * pitch + c] =
        row < rows ? level_value<kForm, kPartial>(a, b, m, row * B + l0 + c,
                                                  row)
                   : 0.0f;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int c = threadIdx.x / 32; c < lt; c += kWarps) {
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = s[(32 * k + lane) * pitch + c];
    const float r = chunk_tree(v);
    if (lane == 0) dst[chunk * B + l0 + c] = r;
  }
}

// B <= kWarpLanes: warps alone.  Warp item = (chunk, column) of level 0;
// the last warp to arrive at a chunk of a later level reduces it for every
// column.  Lanes of a row lie side by side, so a block's warps read the
// same sectors (the L1 serves the columns after the first).
template <int kForm>
__device__ __forceinline__ void lane_sum_warps(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, const LaneLevels& lv, int B) {
  const int lane = threadIdx.x & 31;
  const int64_t item =
      static_cast<int64_t>(blockIdx.x) * kWarps + threadIdx.x / 32;
  int64_t chunk = item / B;
  if (chunk >= chunks_of(lv.rows[0])) return;
  warp_chunk<kForm, false>(a, b, m, lv.buf[1], lv.rows[0], B, chunk,
                           static_cast<int>(item - chunk * B), lane);
  for (int l = 1; l < lv.n; ++l) {
    const int64_t rows = lv.rows[l];
    const int64_t group = chunk / kChunk;
    const int64_t in_group = rows - group * kChunk < kChunk
                                 ? rows - group * kChunk : kChunk;
    const unsigned expected =
        static_cast<unsigned>(in_group * (l == 1 ? B : 1));
    __threadfence();
    unsigned old = 0;
    if (lane == 0) old = atomicInc(lv.cnt[l] + group, expected - 1);
    if (__shfl_sync(0xffffffffu, old, 0) != expected - 1) return;
    __threadfence();
    for (int c = 0; c < B; ++c)
      warp_chunk<kSum, true>(lv.buf[l], nullptr, nullptr, lv.buf[l + 1],
                             rows, B, group, c, lane);
    chunk = group;
  }
}

// B > kWarpLanes: a block a (chunk, lane tile), staged in shared memory;
// the last block to arrive at a chunk of a later level reduces it.
template <int kForm>
__device__ __forceinline__ void lane_sum_blocks(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, const LaneLevels& lv, int B) {
  __shared__ float s[kChunk * (kLaneTile + 1)];
  __shared__ int last;
  const int tile = blockIdx.y;
  int64_t chunk = blockIdx.x;
  block_chunk<kForm, false>(a, b, m, lv.buf[1], lv.rows[0], B, chunk, tile,
                            s);
  for (int l = 1; l < lv.n; ++l) {
    const int64_t rows = lv.rows[l];
    const int64_t group = chunk / kChunk;
    const int64_t in_group = rows - group * kChunk < kChunk
                                 ? rows - group * kChunk : kChunk;
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last = atomicInc(lv.cnt[l] + group * gridDim.y + tile,
                       static_cast<unsigned>(in_group - 1)) ==
             static_cast<unsigned>(in_group - 1);
    __syncthreads();
    if (!last) return;
    __threadfence();
    block_chunk<kSum, true>(lv.buf[l], nullptr, nullptr, lv.buf[l + 1], rows,
                            B, group, tile, s);
    chunk = group;
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) lane_sum_kernel(
    const float* __restrict__ a, const float* __restrict__ b,
    const float* __restrict__ m, LaneLevels lv, int B) {
  if (B <= kWarpLanes)
    lane_sum_warps<kForm>(a, b, m, lv, B);
  else
    lane_sum_blocks<kForm>(a, b, m, lv, B);
}

}  // namespace

extern "C" {

// K1.  x: (n_in, B) f32; ptr: n_seg + 1 offsets (int32 if ptr64 == 0, else
// int64); g: run-element -> row of x (int32 if g64 == 0, else int64) or
// null (x has a row a run element); w: one f32 a run element (mul == 1) or
// null; y: (n_seg, B) f32.  longest: the longest run, or -1 when the caller
// does not know it; at most kLong, the launch is the short walk alone.
// One launch; returns its CUDA error code.
int csr_spmm_sum(const float* x, const void* ptr, int ptr64, const void* g,
                 int g64, const float* w, float* y, long long n_seg, int B,
                 int mul, int bf16, long long longest, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || n_seg < 0 || (mul == kTimes && w == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_seg * B == 0) return 0;
  const int cw_log2 = B == 1 ? 0 : B == 2 ? 1 : B <= 4 ? 2 : 3;
  int long_blocks = 0;
  if (longest < 0 || longest > kLong) {
    int dev = 0, sms = 0;
    cudaError_t attr = cudaGetDevice(&dev);
    if (attr == cudaSuccess)
      attr = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
    if (attr != cudaSuccess) return static_cast<int>(attr);
    long_blocks = 2 * sms;
  }
  cudaError_t rc;
  if (g == nullptr)
    rc = launch_forms<int32_t, false>(mul, bf16, cw_log2, long_blocks, st, x,
                                      ptr, ptr64, g, w, y, n_seg, B);
  else if (g64)
    rc = launch_forms<int64_t, true>(mul, bf16, cw_log2, long_blocks, st, x,
                                     ptr, ptr64, g, w, y, n_seg, B);
  else
    rc = launch_forms<int32_t, true>(mul, bf16, cw_log2, long_blocks, st, x,
                                     ptr, ptr64, g, w, y, n_seg, B);
  return static_cast<int>(rc);
}

// The longest run the short walk takes beside a long role (kLong).
int segment_long_run() { return kLong; }

// K2.  a (and b): (rows, B) f32; m: rows f32 (form 1) or null; out: B f32.
// scratch: n_scratch floats for the partials of the levels after the
// first; tickets: n_tickets zeroed counters (left zeroed), one a chunk of
// each level after the first and lane tile (segment_cuda.lane_sum_scratch
// gives both sizes).  form: 0 sum(a), 1 sum(a * m), 2 sum(|a - b|).  One
// launch; returns its CUDA error code.
int lane_sum(const float* a, const float* b, const float* m, float* out,
             float* scratch, long long n_scratch, unsigned* tickets,
             long long n_tickets, long long rows, int B, int form,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B < 1 || rows < 0 || form < 0 || form > 2 ||
      (rows > 0 && ((form == kDot && m == nullptr) ||
                    (form == kL1 && b == nullptr))))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = B <= kWarpLanes ? 1 : (B + kLaneTile - 1) / kLaneTile;
  LaneLevels lv{};
  int64_t r = rows, floats = 0, counters = 0;
  while (true) {
    if (lv.n == kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
    lv.rows[lv.n] = r;
    if (lv.n > 0) {
      lv.buf[lv.n] = scratch + floats;
      lv.cnt[lv.n] = tickets + counters;
      floats += r * B;
      counters += chunks_of(r) * tiles;
    }
    ++lv.n;
    if (chunks_of(r) == 1) break;
    r = chunks_of(r);
  }
  lv.buf[lv.n] = out;
  if (floats > n_scratch || counters > n_tickets)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t chunks = chunks_of(rows);
  const dim3 grid(static_cast<unsigned>(
                      B <= kWarpLanes ? (chunks * B + kWarps - 1) / kWarps
                                      : chunks),
                  static_cast<unsigned>(B <= kWarpLanes ? 1 : tiles));
  if (form == kSum)
    lane_sum_kernel<kSum><<<grid, kThreads, 0, st>>>(a, b, m, lv, B);
  else if (form == kDot)
    lane_sum_kernel<kDot><<<grid, kThreads, 0, st>>>(a, b, m, lv, B);
  else
    lane_sum_kernel<kL1><<<grid, kThreads, 0, st>>>(a, b, m, lv, B);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
