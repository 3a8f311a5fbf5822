// The Pallas microbenchmark kernels on Hopper (sm_90a), with a plain C
// interface for ctypes (memgraph_tpu_torch/benchmarks/_common.py binds
// them; benchmarks/micro.py, micro2.py and micro3.py wrap and check them).
//
// Each kernel replaces one pallas_call of benchmarks/pallas_micro*.py and
// computes what its Pallas body computes on an (R, 128) f32 array with
// int32 indices.  Its note says what bounds it and what its design does
// about that.  These are the simple first versions: one thread (or warp,
// or block) per natural unit of work, shared memory where a value is
// reused; TMA, wgmma and clusters are later work.  Indices are promised
// in bounds, as the Pallas kernels promise them (mode="promise_in_bounds").
//
// Every entry point launches on the given stream and returns the launch's
// CUDA error (0 on success); none synchronises or allocates.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kLanes = 128;            // the TPU's lane width, kept as layout
constexpr int kTile = 128;             // a 128 x 128 tile
constexpr int kPad = kTile + 1;        // padded tile row: no bank conflicts
constexpr int kTileElems = kTile * kTile;
constexpr int kBlockThreads = 1024;
constexpr int kPerThread = kTileElems / kBlockThreads;   // 16
constexpr unsigned kFull = 0xffffffffu;
// grid-stride kernels launch at most 16 blocks of 256 threads per SM of
// an H100 (132 SMs)
constexpr long long kMaxBlocks = 132 * 16;

unsigned grid_for(long long units, int per_block) {
  long long b = (units + per_block - 1) / per_block;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return static_cast<unsigned>(b < 1 ? 1 : b);
}

// ---------------------------------------------------------------------------
// col_gather <- benchmarks/pallas_micro.py:46 (bench_col_gather)
//   out[s, l] = tab[idx[s, l], l]
// Bound: bytes (read idx and the gathered tab values, write out: 12 B a
// value).  One thread per output; idx and out are read and written
// coalesced, the table through L2 (4 MB at R = 8192 stays resident).
// ---------------------------------------------------------------------------
__global__ void col_gather_kernel(const float* __restrict__ tab,
                                  const int32_t* __restrict__ idx,
                                  float* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < n; e += stride) {
    const int l = static_cast<int>(e & (kLanes - 1));
    out[e] = __ldg(tab + static_cast<long long>(__ldg(idx + e)) * kLanes + l);
  }
}

// A lane row of 128 values lives in one warp, 4 values a lane: lane t holds
// positions t, t + 32, t + 64, t + 96.  lane_take returns the row's value at
// position i (each lane asks for its own i): 4 shuffles from lane i % 32
// and a select by i / 32.  Values move as they are: exact.
__device__ __forceinline__ float lane_take(const float v[4], int i) {
  const int src = i & 31;
  const float a0 = __shfl_sync(kFull, v[0], src);
  const float a1 = __shfl_sync(kFull, v[1], src);
  const float a2 = __shfl_sync(kFull, v[2], src);
  const float a3 = __shfl_sync(kFull, v[3], src);
  const int m = i >> 5;
  return m == 0 ? a0 : (m == 1 ? a1 : (m == 2 ? a2 : a3));
}

// ---------------------------------------------------------------------------
// lane_gather <- benchmarks/pallas_micro.py:78 (bench_lane_gather)
//   out[s, l] = tab[s, idx[s, l]],  idx < 128
// Bound: bytes (12 B a value).  One warp per row: the row is loaded
// coalesced into registers and gathered by shuffles (lane_take), so the
// gather itself touches neither shared nor device memory.
// ---------------------------------------------------------------------------
__global__ void lane_gather_kernel(const float* __restrict__ tab,
                                   const int32_t* __restrict__ idx,
                                   float* __restrict__ out, long long rows) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  // r is the same for every lane of a warp: the loop and the shuffles
  // inside it are warp-uniform
  for (long long r = static_cast<long long>(blockIdx.x) * warps +
                     (threadIdx.x >> 5);
       r < rows; r += stride) {
    const long long base = r * kLanes + lane;
    float v[4];
    int ix[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      v[m] = __ldg(tab + base + 32 * m);
      ix[m] = __ldg(idx + base + 32 * m);
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) out[base + 32 * m] = lane_take(v, ix[m]);
  }
}

// ---------------------------------------------------------------------------
// stream <- benchmarks/pallas_micro.py:111 (bench_stream)
//   o = x * 2 + 1
// Bound: bytes (read x, write o).  16-byte loads and stores in a
// grid-stride loop: the measured rate is the card's achievable device
// memory bandwidth.  x * 2 is exact, so a fused multiply-add rounds the
// same as a multiply then an add.
// ---------------------------------------------------------------------------
__global__ void stream_kernel(const float4* __restrict__ x,
                              float4* __restrict__ o, long long n4) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 v = x[i];
    v.x = v.x * 2.0f + 1.0f;
    v.y = v.y * 2.0f + 1.0f;
    v.z = v.z * 2.0f + 1.0f;
    v.w = v.w * 2.0f + 1.0f;
    o[i] = v;
  }
}

// ---------------------------------------------------------------------------
// gather_loop <- benchmarks/pallas_micro.py:138 (bench_gather_loop)
//   iters x  acc[s, l] <- acc[idx[s, l], l]
// Bound: on chip.  The chain never leaves its column, so one block owns
// one column for the whole launch: the column lives in shared memory
// twice (ping-pong, 2 x R x 4 B) and the column's indices in registers
// (R / 1024 a thread), with one __syncthreads() per iteration and no
// grid-wide barrier.  128 blocks for 132 SMs.  The column is loaded and
// stored with a 512 B stride, once per launch.
// ---------------------------------------------------------------------------
constexpr int kLoopPerThread = 16;     // R <= 16384
__global__ void __launch_bounds__(kBlockThreads)
gather_loop_kernel(const float* __restrict__ tab,
                   const int32_t* __restrict__ idx, float* __restrict__ out,
                   int R, int iters) {
  extern __shared__ __align__(16) float col[];
  float* a = col;
  float* b = col + R;
  const int l = blockIdx.x;
  int ix[kLoopPerThread];
#pragma unroll
  for (int k = 0; k < kLoopPerThread; ++k) {
    const int s = threadIdx.x + k * kBlockThreads;
    if (s < R) {
      ix[k] = __ldg(idx + static_cast<long long>(s) * kLanes + l);
      a[s] = __ldg(tab + static_cast<long long>(s) * kLanes + l);
    }
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < kLoopPerThread; ++k) {
      const int s = threadIdx.x + k * kBlockThreads;
      if (s < R) b[s] = a[ix[k]];
    }
    // every read of a in this iteration is done before the next one
    // writes into it
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
#pragma unroll
  for (int k = 0; k < kLoopPerThread; ++k) {
    const int s = threadIdx.x + k * kBlockThreads;
    if (s < R) out[static_cast<long long>(s) * kLanes + l] = a[s];
  }
}

// ---------------------------------------------------------------------------
// dynslice_gather <- benchmarks/pallas_micro2.py:83 (bench_dynslice_gather)
//   out[r, l] = rank[8 * grp[r / 8] + row3[r, l], l]
// Bound: bytes (read row3, write out, read grp and rank once).  One block
// of 256 threads per 8-row block (1024 values): the TPU's scalar prefetch
// of grp becomes one broadcast load of the block's own grp entry; row3 is
// read and out written as int4 / float4, 4 lanes a thread; rank (4 MB)
// is read through L2.  One pass, no loop.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
dynslice_gather_kernel(const int32_t* __restrict__ grp,
                       const int4* __restrict__ row3,
                       const float* __restrict__ rank,
                       float4* __restrict__ out, long long n_blocks) {
  const int l0 = (threadIdx.x & 31) * 4;
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    const long long g8 = static_cast<long long>(__ldg(grp + b)) * 8;
    const long long q = b * 256 + threadIdx.x;
    const int4 r = row3[q];
    const float* c = rank + l0;
    float4 v;
    v.x = __ldg(c + (g8 + r.x) * kLanes + 0);
    v.y = __ldg(c + (g8 + r.y) * kLanes + 1);
    v.z = __ldg(c + (g8 + r.z) * kLanes + 2);
    v.w = __ldg(c + (g8 + r.w) * kLanes + 3);
    out[q] = v;
  }
}

// ---------------------------------------------------------------------------
// onehot_scatter <- benchmarks/pallas_micro2.py:149 (bench_onehot_scatter)
//   acc[dblk[b], l] += sum_{s < 8, e} vals[8b + s, e] * [lanes[8b + s, e] == l]
// Bound: bytes (read lanes and vals, 8 B a value).  On the TPU this is a
// one-hot matmul; here it is a scatter-add, 128x less work.  One block per
// 8-row block: 1024 values into 128 bins by shared-memory atomics, then
// one 128-wide row added into acc[dblk[b]] by device atomics (blocks
// collide on rows).  The caller zeroes acc.  Sums are taken in the order
// the atomics land, which changes from run to run.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
onehot_scatter_kernel(const int32_t* __restrict__ dblk,
                      const int4* __restrict__ lanes,
                      const float4* __restrict__ vals,
                      float* __restrict__ acc, long long n_blocks) {
  __shared__ float bins[kLanes];
  for (long long b = blockIdx.x; b < n_blocks; b += gridDim.x) {
    if (threadIdx.x < kLanes) bins[threadIdx.x] = 0.0f;
    __syncthreads();
    const long long q = b * 256 + threadIdx.x;
    const int4 ln = lanes[q];
    const float4 v = vals[q];
    atomicAdd(&bins[ln.x], v.x);
    atomicAdd(&bins[ln.y], v.y);
    atomicAdd(&bins[ln.z], v.z);
    atomicAdd(&bins[ln.w], v.w);
    __syncthreads();
    if (threadIdx.x < kLanes)
      atomicAdd(acc + static_cast<long long>(__ldg(dblk + b)) * kLanes +
                    threadIdx.x,
                bins[threadIdx.x]);
    __syncthreads();   // bins are read before the next block zeroes them
  }
}

// ---------------------------------------------------------------------------
// lane_gather_loop <- benchmarks/pallas_micro3.py:49 (bench_lane_gather_loop)
//   iters x  acc[s, l] <- acc[s, idx[s, l]] + 1
// Bound: on chip (the shuffle crossbar).  One warp per row for the whole
// launch: values and indices stay in registers, each iteration is 16
// shuffles and 4 adds a lane.  The gather then + 1 keeps the Pallas
// body's order, so the result is exact.
// ---------------------------------------------------------------------------
__global__ void lane_gather_loop_kernel(const float* __restrict__ x,
                                        const int32_t* __restrict__ idx,
                                        float* __restrict__ out,
                                        long long rows, int iters) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const long long stride = static_cast<long long>(gridDim.x) * warps;
  for (long long r = static_cast<long long>(blockIdx.x) * warps +
                     (threadIdx.x >> 5);
       r < rows; r += stride) {
    const long long base = r * kLanes + lane;
    float v[4];
    int ix[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      v[m] = __ldg(x + base + 32 * m);
      ix[m] = __ldg(idx + base + 32 * m);
    }
    for (int it = 0; it < iters; ++it) {
      float n[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) n[m] = lane_take(v, ix[m]) + 1.0f;
#pragma unroll
      for (int m = 0; m < 4; ++m) v[m] = n[m];
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) out[base + 32 * m] = v[m];
  }
}

// Tile passes for one block of 1024 threads on a padded 128 x 129 tile in
// shared memory.  Thread t owns positions e = t + 1024 k (k < 16), that
// is row i = e / 128 and column j = e % 128.  Each pass reads its 16
// sources into registers, waits, writes, and waits.  Row-major and
// transposed reads both stay off shared-memory bank conflicts thanks to
// the pad (address i * 129 + j).
template <bool kAddOne>
__device__ __forceinline__ void tile_transpose(float* t) {
  float r[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    r[k] = t[(e & (kTile - 1)) * kPad + (e >> 7)];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    t[(e >> 7) * kPad + (e & (kTile - 1))] = kAddOne ? r[k] + 1.0f : r[k];
  }
  __syncthreads();
}

__device__ __forceinline__ void tile_lane_gather(float* t,
                                                 const uint8_t* ix) {
  float r[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    r[k] = t[(e >> 7) * kPad + ix[e]];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    t[(e >> 7) * kPad + (e & (kTile - 1))] = r[k];
  }
  __syncthreads();
}

__device__ __forceinline__ void tile_load(float* t, const float* x) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    t[(e >> 7) * kPad + (e & (kTile - 1))] = x[e];
  }
}

__device__ __forceinline__ void tile_store(const float* t, float* y) {
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    y[e] = t[(e >> 7) * kPad + (e & (kTile - 1))];
  }
}

constexpr size_t kTileBytes = sizeof(float) * kTile * kPad;   // 66,048

// ---------------------------------------------------------------------------
// transpose_loop <- benchmarks/pallas_micro3.py:84 (bench_transpose_loop)
//   iters x  (every 128 x 128 tile) acc <- acc^T + 1
// Bound: on chip (shared memory: 8 B a value an iteration).  One block
// per tile for the whole launch, the tile in shared memory padded to 129
// floats a row.  The shape gives R / 128 blocks (64 at R = 8192), so about
// half the SMs have nothing to do.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kBlockThreads)
transpose_loop_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int iters) {
  extern __shared__ __align__(16) float t[];
  const long long base = static_cast<long long>(blockIdx.x) * kTileElems;
  tile_load(t, x + base);
  __syncthreads();
  for (int it = 0; it < iters; ++it) tile_transpose<true>(t);
  tile_store(t, out + base);
}

// ---------------------------------------------------------------------------
// sandwich <- benchmarks/pallas_micro3.py:124 (bench_sandwich)
//   iters x  [lane-gather s1, transpose, lane-gather s2, transpose,
//             lane-gather s3] on every 128 x 128 tile
// Bound: on chip (shared memory: 5 passes of 8 B a value plus 3 index
// bytes an iteration).  One block per tile for the whole launch.  A tile
// and three int32 index tiles would be 256 KB, over the 227 KB a block
// may have, so the indices (< 128) are kept as uint8: 48 KB beside the
// 66 KB padded tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kBlockThreads)
sandwich_kernel(const float* __restrict__ x, const int32_t* __restrict__ s1,
                const int32_t* __restrict__ s2,
                const int32_t* __restrict__ s3, float* __restrict__ out,
                int iters) {
  extern __shared__ __align__(16) float t[];
  uint8_t* ix = reinterpret_cast<uint8_t*>(t + kTile * kPad);
  const long long base = static_cast<long long>(blockIdx.x) * kTileElems;
  tile_load(t, x + base);
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kBlockThreads;
    ix[e] = static_cast<uint8_t>(__ldg(s1 + base + e));
    ix[kTileElems + e] = static_cast<uint8_t>(__ldg(s2 + base + e));
    ix[2 * kTileElems + e] = static_cast<uint8_t>(__ldg(s3 + base + e));
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    tile_lane_gather(t, ix);
    tile_transpose<false>(t);
    tile_lane_gather(t, ix + kTileElems);
    tile_transpose<false>(t);
    tile_lane_gather(t, ix + 2 * kTileElems);
  }
  tile_store(t, out + base);
}

// ---------------------------------------------------------------------------
// big_matmul <- benchmarks/pallas_micro3.py:156 (bench_big_matmul)
//   acc = 0;  iters x  acc <- acc + A @ B     (A M x K, B K x N, f32)
// Bound: operations (2 M N K a product, no TF32: the reference is full
// f32).  A SIMT tiled GEMM: a block owns a 32 x 32 tile of acc in
// registers for all iterations (4 rows x 1 column a thread, 256 threads),
// streams 32 x 32 tiles of A and B through shared memory (A stored
// transposed so a thread reads its 4 A values as one broadcast float4),
// and recomputes the product every iteration: the loop-invariant product
// is the measurement and is not hoisted.  Each iteration's product is
// summed apart and then added to acc, as the Pallas body does.
// ---------------------------------------------------------------------------
constexpr int kBM = 32, kBN = 32, kBK = 32;
__global__ void __launch_bounds__(256)
big_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ C, int K, int N, int iters) {
  __shared__ __align__(16) float At[kBK][kBM + 4];   // At[k][m]
  __shared__ __align__(16) float Bs[kBK][kBN];
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;       // 0..7
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int it = 0; it < iters; ++it) {
    float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = ty + 8 * q;
        At[tx][r] = __ldg(A + static_cast<long long>(m0 + r) * K + k0 + tx);
        Bs[r][tx] = __ldg(B + static_cast<long long>(k0 + r) * N + n0 + tx);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a = *reinterpret_cast<const float4*>(&At[kk][ty * 4]);
        const float b = Bs[kk][tx];
        p[0] = fmaf(a.x, b, p[0]);
        p[1] = fmaf(a.y, b, p[1]);
        p[2] = fmaf(a.z, b, p[2]);
        p[3] = fmaf(a.w, b, p[3]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m] += p[m];
  }
#pragma unroll
  for (int m = 0; m < 4; ++m)
    C[static_cast<long long>(m0 + ty * 4 + m) * N + n0 + tx] = acc[m];
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// out[s, l] = tab[idx[s, l], l] over (rows, 128).
int micro_col_gather(const void* tab, const void* idx, void* out,
                     long long rows, void* stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  const long long n = rows * kLanes;
  col_gather_kernel<<<grid_for(n, 256), 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), n);
  return cudaGetLastError();
}

// out[s, l] = tab[s, idx[s, l]] over (rows, 128), idx < 128.
int micro_lane_gather(const void* tab, const void* idx, void* out,
                      long long rows, void* stream) {
  if (rows < 1) return cudaErrorInvalidValue;
  lane_gather_kernel<<<grid_for(rows, 8), 256, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows);
  return cudaGetLastError();
}

// o = x * 2 + 1 over n values (n % 4 == 0, both 16-byte aligned).
int micro_stream(const void* x, void* o, long long n, void* stream) {
  if (n < 4 || n % 4 != 0) return cudaErrorInvalidValue;
  const long long n4 = n / 4;
  stream_kernel<<<grid_for(n4, 256), 256, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<float4*>(o), n4);
  return cudaGetLastError();
}

// iters chained column gathers of (rows, 128), rows <= 16384.
int micro_gather_loop(const void* tab, const void* idx, void* out, int rows,
                      int iters, void* stream) {
  if (rows < 1 || rows > kLoopPerThread * kBlockThreads || iters < 0)
    return cudaErrorInvalidValue;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(rows);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(gather_loop_kernel), smem);
  if (err != cudaSuccess) return err;
  gather_loop_kernel<<<kLanes, kBlockThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tab), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows, iters);
  return cudaGetLastError();
}

// out[r, l] = rank[8 * grp[r / 8] + row3[r, l], l] over (rows, 128);
// rows % 8 == 0, grp has rows / 8 entries.
int micro_dynslice_gather(const void* grp, const void* row3,
                          const void* rank, void* out, long long rows,
                          void* stream) {
  if (rows < 8 || rows % 8 != 0) return cudaErrorInvalidValue;
  const long long n_blocks = rows / 8;
  dynslice_gather_kernel<<<grid_for(n_blocks, 1), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(grp), static_cast<const int4*>(row3),
      static_cast<const float*>(rank), static_cast<float4*>(out), n_blocks);
  return cudaGetLastError();
}

// acc[dblk[b], lanes[8b + s, e]] += vals[8b + s, e] over (rows, 128);
// rows % 8 == 0; acc must hold zeros (or the sums to add to).
int micro_onehot_scatter(const void* dblk, const void* lanes,
                         const void* vals, void* acc, long long rows,
                         void* stream) {
  if (rows < 8 || rows % 8 != 0) return cudaErrorInvalidValue;
  const long long n_blocks = rows / 8;
  onehot_scatter_kernel<<<grid_for(n_blocks, 1), 256, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(dblk), static_cast<const int4*>(lanes),
      static_cast<const float4*>(vals), static_cast<float*>(acc), n_blocks);
  return cudaGetLastError();
}

// iters x (lane gather, + 1) over (rows, 128).
int micro_lane_gather_loop(const void* x, const void* idx, void* out,
                           long long rows, int iters, void* stream) {
  if (rows < 1 || iters < 0) return cudaErrorInvalidValue;
  lane_gather_loop_kernel<<<grid_for(rows, 8), 256, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows, iters);
  return cudaGetLastError();
}

// iters x (transpose every 128 x 128 tile, + 1); rows % 128 == 0.
int micro_transpose_loop(const void* x, void* out, long long rows, int iters,
                         void* stream) {
  if (rows < kTile || rows % kTile != 0 || iters < 0)
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(transpose_loop_kernel), kTileBytes);
  if (err != cudaSuccess) return err;
  transpose_loop_kernel<<<static_cast<unsigned>(rows / kTile), kBlockThreads,
                          kTileBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), iters);
  return cudaGetLastError();
}

// iters x the 5-pass sandwich on every tile; rows % 128 == 0.
int micro_sandwich(const void* x, const void* s1, const void* s2,
                   const void* s3, void* out, long long rows, int iters,
                   void* stream) {
  if (rows < kTile || rows % kTile != 0 || iters < 0)
    return cudaErrorInvalidValue;
  const size_t smem = kTileBytes + 3 * kTileElems;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(sandwich_kernel), smem);
  if (err != cudaSuccess) return err;
  sandwich_kernel<<<static_cast<unsigned>(rows / kTile), kBlockThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), static_cast<const int32_t*>(s3),
      static_cast<float*>(out), iters);
  return cudaGetLastError();
}

// C = iters x (+ A @ B) from zero; A (M, K), B (K, N), all multiples of 32.
int micro_big_matmul(const void* A, const void* B, void* C, int M, int K,
                     int N, int iters, void* stream) {
  if (M < kBM || K < kBK || N < kBN || M % kBM || K % kBK || N % kBN ||
      iters < 0)
    return cudaErrorInvalidValue;
  const dim3 grid(N / kBN, M / kBM);
  big_matmul_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(A), static_cast<const float*>(B),
      static_cast<float*>(C), K, N, iters);
  return cudaGetLastError();
}

const char* micro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
