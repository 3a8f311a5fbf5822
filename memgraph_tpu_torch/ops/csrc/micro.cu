// The Pallas microbenchmark kernels on Hopper (sm_90a), with a plain C
// interface for ctypes (memgraph_tpu_torch/benchmarks/_common.py binds
// them; benchmarks/micro.py, micro2.py and micro3.py wrap and check them).
//
// Each kernel replaces one pallas_call of benchmarks/pallas_micro*.py and
// computes what its Pallas body computes on an (R, 128) f32 array with
// int32 indices.  Its note says what bounds it and what its design does
// about that.  Most are the simple first versions: one thread (or warp,
// or block) per natural unit of work, shared memory where a value is
// reused.  The looping kernels were redesigned: transpose_loop splits each
// tile over two blocks by the transpose's quadrant orbits, sandwich fuses
// its gathers with its transposes, lane_gather_loop keeps a row a lane in
// a bank-aligned layout, gather_loop takes its columns in and out through
// tile transposes.  Indices are promised in bounds, as the Pallas kernels
// promise them (mode="promise_in_bounds").
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
constexpr unsigned kFull = 0xffffffffu;
// grid-stride kernels launch at most 16 blocks of 256 threads per SM of
// an H100 (132 SMs)
constexpr long long kMaxBlocks = 132 * 16;
// shared memory a block may use on an H100 (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

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

// Waits for the grid launched before this one on the stream (a no-op
// unless this grid was launched by launch_after).
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// ---------------------------------------------------------------------------
// tile_transpose: dst[c * dp + r] = src[r * sp + c] over 32 x 32 tiles,
// src rows r < src_rows (zeros read past them), dst rows c < dst_rows.
// One 256-thread block a tile (blockIdx.z picks one of two matrices):
// 16-byte loads and stores on both sides, 8 lanes to a 128-byte row, and a
// 32 x 33 shared tile that both the row-wise writes and the column-wise
// reads cross on 32 distinct banks.  Values move as 32-bit words.
// ---------------------------------------------------------------------------
constexpr int kTT = 32;                // transpose tile edge
constexpr int kTTThreads = 256;
__global__ void __launch_bounds__(kTTThreads)
tile_transpose_kernel(const uint32_t* __restrict__ src0,
                      uint32_t* __restrict__ dst0,
                      const uint32_t* __restrict__ src1,
                      uint32_t* __restrict__ dst1, int src_rows, int sp,
                      int dst_rows, int dp) {
  __shared__ uint32_t tile[kTT][kTT + 1];
  wait_prior_grid();
  const uint32_t* src = blockIdx.z ? src1 : src0;
  uint32_t* dst = blockIdx.z ? dst1 : dst0;
  const int r0 = blockIdx.y * kTT, c0 = blockIdx.x * kTT;
  const int j = threadIdx.x & 31, w = threadIdx.x >> 5;
  // lane j: row 4 w + j / 8 of the tile, its 16 bytes j % 8
  const int r = 4 * w + (j >> 3), q = j & 7;
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (r0 + r < src_rows)
    v = __ldg(reinterpret_cast<const uint4*>(
                  src + static_cast<long long>(r0 + r) * sp + c0) + q);
  // bank r + 4 q + k: 32 distinct over the warp for each k
  tile[r][4 * q] = v.x;
  tile[r][4 * q + 1] = v.y;
  tile[r][4 * q + 2] = v.z;
  tile[r][4 * q + 3] = v.w;
  __syncthreads();
  // lane j: dst row c0 + 4 w + j / 8, its source rows 4 (j % 8) .. + 3
  const int c = 4 * w + (j >> 3);
  if (c0 + c < dst_rows) {
    const uint4 o = make_uint4(tile[4 * q][c], tile[4 * q + 1][c],
                               tile[4 * q + 2][c], tile[4 * q + 3][c]);
    *(reinterpret_cast<uint4*>(dst + static_cast<long long>(c0 + c) * dp +
                               r0) + q) = o;
  }
}

// ---------------------------------------------------------------------------
// gather_loop <- benchmarks/pallas_micro.py:138 (bench_gather_loop)
//   iters x  acc[s, l] <- acc[idx[s, l], l]
// Bound: on chip.  The chain never leaves its column, so one block owns
// one column for the whole launch (128 blocks for 132 SMs).  The column
// enters and leaves the block contiguously: tile_transpose first turns
// tab and idx into column-major (128, pitch) scratch, pitch = R rounded
// up to 32 (padding: value 0, index 0), the loop kernel reads its column
// and writes it back with 16-byte accesses, and tile_transpose writes out
// from the result; the second and third launches start while the one
// before drains (launch_after).  In the loop the column lives in shared
// memory twice (ping-pong, 2 x pitch x 4 B); thread k owns the 4-position
// groups k, k + 1024, ... and keeps their indices in registers.  Each
// iteration it reads all of its gathered values before it stores any (one
// 16-byte store a group), then one __syncthreads().  The random reads are
// the limit: 32 sources fall on an expected ~3.6 distinct addresses of
// the busiest bank.
// ---------------------------------------------------------------------------
constexpr int kLoopVecs = 4;   // 4-position groups a thread: R <= 16384
__global__ void __launch_bounds__(kBlockThreads)
gather_loop_kernel(const float* __restrict__ tabT,
                   const int32_t* __restrict__ idxT,
                   float* __restrict__ outT, int pitch, int iters) {
  extern __shared__ __align__(16) float col[];
  float* a = col;
  float* b = col + pitch;
  const long long base = static_cast<long long>(blockIdx.x) * pitch;
  const int groups = pitch / 4;
  wait_prior_grid();
  int4 ix[kLoopVecs];
#pragma unroll
  for (int m = 0; m < kLoopVecs; ++m) {
    const int g = threadIdx.x + m * kBlockThreads;
    if (g < groups) {
      ix[m] = __ldg(reinterpret_cast<const int4*>(idxT + base) + g);
      reinterpret_cast<float4*>(a)[g] =
          __ldg(reinterpret_cast<const float4*>(tabT + base) + g);
    }
  }
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    float4 v[kLoopVecs];
#pragma unroll
    for (int m = 0; m < kLoopVecs; ++m)
      if (threadIdx.x + m * kBlockThreads < groups)
        v[m] = make_float4(a[ix[m].x], a[ix[m].y], a[ix[m].z], a[ix[m].w]);
#pragma unroll
    for (int m = 0; m < kLoopVecs; ++m) {
      const int g = threadIdx.x + m * kBlockThreads;
      if (g < groups) reinterpret_cast<float4*>(b)[g] = v[m];
    }
    // every read of a in this iteration is done before the next one
    // writes into it
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
#pragma unroll
  for (int m = 0; m < kLoopVecs; ++m) {
    const int g = threadIdx.x + m * kBlockThreads;
    if (g < groups)
      reinterpret_cast<float4*>(outT + base)[g] =
          reinterpret_cast<const float4*>(a)[g];
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
// Bound: on chip (shared memory: 8 B a value an iteration, a read and a
// write).  A block owns 32 rows, lane t of every warp row r0 + t, and its
// kLaneWarps warps split the 128 positions (warp w: 16 w .. 16 w + 15).
// The rows live in shared memory position-major, (position p, row t) at
// word 32 p + t, twice (ping-pong, 32 KB): every read A[32 idx + t] and
// every write B[32 p + t] of lane t lands in bank t whatever the index,
// one wavefront a warp instruction, no shuffle.  An iteration reads all of
// a thread's gathered values, then adds 1 and writes them (the Pallas
// body's order: exact), then one __syncthreads().  The source offsets are
// loop-invariant registers, and the loop runs two iterations a trip so
// that both buffers are at fixed addresses.  Rows enter and leave by
// 16-byte accesses through a staging buffer of pitch 129 over the same
// shared memory (8 lanes to a 128-byte row: its writes and the transposed
// reads both cross 32 banks).  R / 32 blocks; rows past R (the last
// block's) are read as zeros and not written.  The caller passes the
// launch shape (micro3.lane_gather_loop_tiling).
// ---------------------------------------------------------------------------
constexpr int kLaneWarps = 8;
constexpr int kLaneThreads = 32 * kLaneWarps;
constexpr int kLanePos = kLanes / kLaneWarps;        // positions a warp
constexpr int kLaneRows = 32;                        // rows a block
constexpr int kLaneBuf = kLanes * kLaneRows;         // floats a buffer
constexpr int kStagePitch = kLanes + 1;
constexpr size_t kLaneSmem = 2 * kLaneBuf * sizeof(float);      // 32,768
constexpr int kLaneLoads = kLaneRows * kLanes / 4 / kLaneThreads;
static_assert(kLaneRows * kStagePitch <= 2 * kLaneBuf, "staging fits");

// Load i of a thread covers rows 4 c .. 4 c + 3 and 16-byte columns
// 8 d .. 8 d + 7 of the block, c = g / 4, d = g % 4, g = w + kLaneWarps i:
// its row and 16-byte column.
__device__ __forceinline__ int lane_load_row(int g, int j) {
  return 4 * (g >> 2) + (j >> 3);
}
__device__ __forceinline__ int lane_load_col4(int g, int j) {
  return 8 * (g & 3) + (j & 7);
}

__device__ __forceinline__ void lane_loop_pass(const float* src, float* dst,
                                               const int (&off)[kLanePos],
                                               int at) {
  float v[kLanePos];
#pragma unroll
  for (int i = 0; i < kLanePos; ++i)
    v[i] = *reinterpret_cast<const float*>(
        reinterpret_cast<const char*>(src) + off[i]);
#pragma unroll
  for (int i = 0; i < kLanePos; ++i) dst[at + 32 * i] = v[i] + 1.0f;
}

__global__ void __launch_bounds__(kLaneThreads)
lane_gather_loop_kernel(const float* __restrict__ x,
                        const int32_t* __restrict__ idx,
                        float* __restrict__ out, long long rows, int iters) {
  extern __shared__ __align__(16) float lg[];
  float* A = lg;
  float* B = lg + kLaneBuf;
  float* S = lg;                       // staging, pitch kStagePitch
  const int t = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int p0 = w * kLanePos;
  const long long r0 = static_cast<long long>(blockIdx.x) * kLaneRows;
  const long long left = rows - r0;
  const int nrows = left < kLaneRows ? static_cast<int>(left) : kLaneRows;
  float4 xv[kLaneLoads];
  int4 iv[kLaneLoads];
#pragma unroll
  for (int i = 0; i < kLaneLoads; ++i) {
    const int g = w + kLaneWarps * i;
    const int r = lane_load_row(g, t), q = lane_load_col4(g, t);
    xv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    iv[i] = make_int4(0, 0, 0, 0);
    if (r < nrows) {
      const long long e = (r0 + r) * kLanes + 4 * q;
      xv[i] = __ldg(reinterpret_cast<const float4*>(x + e));
      iv[i] = __ldg(reinterpret_cast<const int4*>(idx + e));
    }
  }
  // indices: staged, then each thread takes its row's positions as byte
  // offsets of its source words, 4 (32 idx + t)
  int* Si = reinterpret_cast<int*>(S);
#pragma unroll
  for (int i = 0; i < kLaneLoads; ++i) {
    const int g = w + kLaneWarps * i;
    int* d =
        Si + lane_load_row(g, t) * kStagePitch + 4 * lane_load_col4(g, t);
    d[0] = iv[i].x;
    d[1] = iv[i].y;
    d[2] = iv[i].z;
    d[3] = iv[i].w;
  }
  __syncthreads();
  int off[kLanePos];
#pragma unroll
  for (int i = 0; i < kLanePos; ++i)
    off[i] = 4 * (32 * Si[t * kStagePitch + p0 + i] + t);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLaneLoads; ++i) {
    const int g = w + kLaneWarps * i;
    float* d =
        S + lane_load_row(g, t) * kStagePitch + 4 * lane_load_col4(g, t);
    d[0] = xv[i].x;
    d[1] = xv[i].y;
    d[2] = xv[i].z;
    d[3] = xv[i].w;
  }
  __syncthreads();
  float v[kLanePos];
#pragma unroll
  for (int i = 0; i < kLanePos; ++i) v[i] = S[t * kStagePitch + p0 + i];
  __syncthreads();
  const int at = 32 * p0 + t;          // word of (p0, t)
#pragma unroll
  for (int i = 0; i < kLanePos; ++i) A[at + 32 * i] = v[i];
  __syncthreads();
  int it = 0;
  for (; it + 1 < iters; it += 2) {
    lane_loop_pass(A, B, off, at);
    // every read of a buffer is done before the next pass writes into it
    __syncthreads();
    lane_loop_pass(B, A, off, at);
    __syncthreads();
  }
  const float* F = A;
  if (it < iters) {
    lane_loop_pass(A, B, off, at);
    __syncthreads();
    F = B;
  }
#pragma unroll
  for (int i = 0; i < kLanePos; ++i) v[i] = F[at + 32 * i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLanePos; ++i) S[t * kStagePitch + p0 + i] = v[i];
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kLaneLoads; ++i) {
    const int g = w + kLaneWarps * i;
    const int r = lane_load_row(g, t), q = lane_load_col4(g, t);
    if (r < nrows) {
      const float* s = S + r * kStagePitch + 4 * q;
      *reinterpret_cast<float4*>(out + (r0 + r) * kLanes + 4 * q) =
          make_float4(s[0], s[1], s[2], s[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// transpose_loop <- benchmarks/pallas_micro3.py:84 (bench_transpose_loop)
//   iters x  (every 128 x 128 tile) acc <- acc^T + 1
// Bound: on chip (shared memory: 8 B a value an iteration).  The transpose
// maps the 64 x 64 quadrants {Q00, Q11} and {Q01, Q10} of a tile onto
// themselves, so a tile splits into two blocks that never meet: block 2t
// owns Q00 and Q11 of tile t, block 2t + 1 owns Q01 and Q10 (R / 64
// blocks, 128 at R = 8192).  A block's two regions live in shared memory
// twice (ping-pong, 64 x 65 floats each: row reads and transposed writes
// both on 32 banks), and each iteration is one pass with one barrier:
// new region g = (old region g, or 1 - g off the diagonal)^T + 1, written
// back into region g's own slot, so the regions are where they belong
// after any iteration count.  Loaded and stored with 16-byte accesses.
// The caller passes the launch shape (micro3.transpose_loop_tiling).
// ---------------------------------------------------------------------------
constexpr int kQuad = 64;                         // quadrant edge
constexpr int kQPad = kQuad + 1;                  // padded quadrant row
constexpr int kRegion = kQuad * kQPad;            // floats of one region
constexpr int kPairPerThread = 2 * kQuad * kQuad / kBlockThreads;   // 8
constexpr size_t kTransposeSmem = 2 * 2 * kRegion * sizeof(float);  // 66,560

__global__ void __launch_bounds__(kBlockThreads)
transpose_loop_kernel(const float* __restrict__ x, float* __restrict__ out,
                      int iters) {
  extern __shared__ __align__(16) float q[];
  const long long base = static_cast<long long>(blockIdx.x >> 1) * kTileElems;
  const int off = blockIdx.x & 1;                 // 1: the {Q01, Q10} pair
  // region g sits at rows 64 g and columns 64 g (diagonal) or 64 (1 - g)
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int f = threadIdx.x + k * kBlockThreads;    // float4 of the pair
    const int g = f >> 10, row = (f >> 4) & (kQuad - 1), c4 = (f & 15) * 4;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
        x + base + (kQuad * g + row) * kTile + kQuad * (g ^ off) + c4));
    float* d = q + g * kRegion + row * kQPad + c4;
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  }
  __syncthreads();
  // thread t writes rows i + 16 m of both regions at column j, reading
  // column i + 16 m of the source region at row j
  const int i = threadIdx.x >> 6, j = threadIdx.x & (kQuad - 1);
  const int src0 = off * kRegion, src1 = (1 - off) * kRegion;
  int cur = 0, nxt = 2 * kRegion;
  for (int it = 0; it < iters; ++it) {
    float r[kPairPerThread];
#pragma unroll
    for (int k = 0; k < kPairPerThread; ++k) {
      const int src = (k < 4 ? src0 : src1) + cur;
      r[k] = q[src + j * kQPad + i + 16 * (k & 3)];
    }
#pragma unroll
    for (int k = 0; k < kPairPerThread; ++k)
      q[nxt + (k >> 2) * kRegion + (i + 16 * (k & 3)) * kQPad + j] =
          r[k] + 1.0f;
    // the reads of cur are done before the next pass writes into it
    __syncthreads();
    const int t = cur;
    cur = nxt;
    nxt = t;
  }
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int f = threadIdx.x + k * kBlockThreads;
    const int g = f >> 10, row = (f >> 4) & (kQuad - 1), c4 = (f & 15) * 4;
    const float* s = q + cur + g * kRegion + row * kQPad + c4;
    *reinterpret_cast<float4*>(out + base + (kQuad * g + row) * kTile +
                               kQuad * (g ^ off) + c4) =
        make_float4(s[0], s[1], s[2], s[3]);
  }
}

// The byte k of a register of packed indices (each < 128).
__device__ __forceinline__ int byte_of(unsigned w, int k) {
  return static_cast<int>((w >> (8 * k)) & 0xffu);
}

// ---------------------------------------------------------------------------
// sandwich <- benchmarks/pallas_micro3.py:124 (bench_sandwich)
//   iters x  [lane-gather s1, transpose, lane-gather s2, transpose,
//             lane-gather s3] on every 128 x 128 tile
// Bound: on chip (shared memory).  A gather followed by a transpose is one
// round trip: read cur[i][s[i][j]], write nxt[j][i].  So an iteration is
// three round trips (gather s1 + transpose X -> Y, gather s2 + transpose
// Y -> Z, gather s3 Z -> X): 24 B a value, every value still moved by all
// five primitives.  One block of 1024 threads a tile (R / 128 blocks, 32
// at R = 4096), the tile in three 128 x 129-float buffers.  Rows to warps:
// warp w owns rows 4 w .. 4 w + 3, lane l columns l + 32 m, so the third
// gather reads and writes only its warp's rows and needs a warp barrier,
// the two transposing passes a block barrier each.  Each thread's
// positions are fixed for the launch, so are its indices: packed 4 to a
// register (12 registers for 48 indices).  Transposed writes are free of
// bank conflicts (pitch 129); the random in-row reads keep an expected
// ~3.5-way conflict.  A tile split over a cluster of 4 blocks (rows
// pushed to their owner through distributed shared memory) measured
// slower on an H100: each of a launch's 400 exchanges waits on a cluster
// barrier or a remote mbarrier, and distributed shared memory carries a
// small fraction of the local rate (PERF.md).  The caller passes the
// launch shape (micro3.sandwich_tiling).
// ---------------------------------------------------------------------------
constexpr int kSwRows = kTile / (kBlockThreads / 32);     // 4 rows a warp
constexpr size_t kSandwichSmem = 3 * kTile * kPad * sizeof(float);  // 198,144

__global__ void __launch_bounds__(kBlockThreads)
sandwich_kernel(const float* __restrict__ x, const int32_t* __restrict__ s1,
                const int32_t* __restrict__ s2,
                const int32_t* __restrict__ s3, float* __restrict__ out,
                int iters) {
  extern __shared__ __align__(16) float sw[];
  float* X = sw;
  float* Y = sw + kTile * kPad;
  float* Z = sw + 2 * kTile * kPad;
  const int l = threadIdx.x & 31;
  const int row0 = kSwRows * (threadIdx.x >> 5);
  const long long base = static_cast<long long>(blockIdx.x) * kTileElems;
  unsigned p1[kSwRows], p2[kSwRows], p3[kSwRows];
#pragma unroll
  for (int a = 0; a < kSwRows; ++a) {
    p1[a] = p2[a] = p3[a] = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int e = (row0 + a) * kTile + l + 32 * m;
      X[(row0 + a) * kPad + l + 32 * m] = __ldg(x + base + e);
      p1[a] |= static_cast<unsigned>(__ldg(s1 + base + e)) << (8 * m);
      p2[a] |= static_cast<unsigned>(__ldg(s2 + base + e)) << (8 * m);
      p3[a] |= static_cast<unsigned>(__ldg(s3 + base + e)) << (8 * m);
    }
  }
  __syncwarp();
  for (int it = 0; it < iters; ++it) {
    // gather s1 + transpose: row i of X to column i of Y
#pragma unroll
    for (int a = 0; a < kSwRows; ++a) {
      float t[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        t[m] = X[(row0 + a) * kPad + byte_of(p1[a], m)];
#pragma unroll
      for (int m = 0; m < 4; ++m) Y[(l + 32 * m) * kPad + row0 + a] = t[m];
    }
    __syncthreads();
    // gather s2 + transpose: Y to Z
#pragma unroll
    for (int a = 0; a < kSwRows; ++a) {
      float t[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        t[m] = Y[(row0 + a) * kPad + byte_of(p2[a], m)];
#pragma unroll
      for (int m = 0; m < 4; ++m) Z[(l + 32 * m) * kPad + row0 + a] = t[m];
    }
    __syncthreads();
    // gather s3: the warp's own rows of Z to X
#pragma unroll
    for (int a = 0; a < kSwRows; ++a) {
      float t[4];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        t[m] = Z[(row0 + a) * kPad + byte_of(p3[a], m)];
#pragma unroll
      for (int m = 0; m < 4; ++m) X[(row0 + a) * kPad + l + 32 * m] = t[m];
    }
    __syncwarp();
  }
#pragma unroll
  for (int a = 0; a < kSwRows; ++a)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      out[base + (row0 + a) * kTile + l + 32 * m] =
          X[(row0 + a) * kPad + l + 32 * m];
}

// ---------------------------------------------------------------------------
// big_matmul <- benchmarks/pallas_micro3.py:156 (bench_big_matmul)
//   acc = 0;  iters x  acc <- acc + A @ B     (A M x K, B K x N, f32)
// Bound: operations (2 M N K a product in f32 FMA; no TF32 and no tensor
// cores: the reference is full f32).  The TPU kernel keeps A and B whole
// in VMEM for all iterations; here they are split over the blocks' shared
// memory.  A block owns a T x T tile of the output and a K-slice of ks: it
// loads A[tile, slice] (transposed, k-major) and B[slice, tile] once and
// runs all iters products from shared memory, so the loop reads nothing
// from L2 or device memory.  A thread computes a TT x TT sub-tile as
// outer products (8 x 8 on the 128 x 128 tile: 4 float4 shared loads per
// 64 FMAs, so the FMA pipe and not the shared-load pipe is the limit), its
// rows and columns in TT / 4 groups of 4, T / (TT / 4) apart; a warp is
// 4 thread rows x 8 thread columns, so each of its loads touches 64 or 128
// contiguous bytes.  Each iteration's product p is summed apart and then
// added to acc, as the Pallas body does.  A compiler memory barrier at the
// top of each iteration makes it reload A and B from shared memory, so the
// loop-invariant product cannot be hoisted out of the iteration loop.
// Split K: each block writes its slice's acc into part[slice], and
// split_sum_kernel adds the slices in index order (no atomics: the answer
// does not depend on the order the blocks run in).  The caller chooses T,
// ks and so the split (benchmarks/micro3.py:big_matmul_tiling).
// ---------------------------------------------------------------------------
template <int T, int TT>
__global__ void __launch_bounds__((T / TT) * (T / TT))
big_matmul_kernel(const float* __restrict__ A, const float* __restrict__ B,
                  float* __restrict__ part, int K, int N, int ks,
                  int iters) {
  constexpr int kEdge = T / TT;                // threads along a tile edge
  constexpr int kThreads = kEdge * kEdge;
  constexpr int kGroups = TT / 4;              // float4 groups a thread
  constexpr int kGroupStride = T / kGroups;
  static_assert(TT % 4 == 0 && kEdge % 8 == 0, "tile shape");
  extern __shared__ __align__(16) float smem[];
  float* As = smem;               // As[k * T + m] = A[m0 + m, k0 + k]
  float* Bs = smem + ks * T;      // Bs[k * T + n] = B[k0 + k, n0 + n]
  const int m0 = blockIdx.y * T;
  const int n0 = blockIdx.x * T;
  const long long k0 = static_cast<long long>(blockIdx.z) * ks;
  // A: 4 k of one row a thread, stored k-major; neighbouring threads take
  // neighbouring rows, so the shared stores are free of bank conflicts
  for (int e = threadIdx.x; e < T * (ks / 4); e += kThreads) {
    const int m = e % T, kq = e / T;
    const float4 v = __ldg(reinterpret_cast<const float4*>(
                               A + static_cast<long long>(m0 + m) * K + k0) +
                           kq);
    float* d = As + 4 * kq * T + m;
    d[0] = v.x;
    d[T] = v.y;
    d[2 * T] = v.z;
    d[3 * T] = v.w;
  }
  for (int e = threadIdx.x; e < ks * (T / 4); e += kThreads) {
    const int k = e / (T / 4), nq = e % (T / 4);
    reinterpret_cast<float4*>(Bs + k * T)[nq] = __ldg(
        reinterpret_cast<const float4*>(B + (k0 + k) * N + n0) + nq);
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = (warp % (kEdge / 8)) * 8 + (lane & 7);
  const int ty = (warp / (kEdge / 8)) * 4 + (lane >> 3);
  const float* a_at = As + ty * 4;
  const float* b_at = Bs + tx * 4;
  float acc[TT][TT];
#pragma unroll
  for (int i = 0; i < TT; ++i)
#pragma unroll
    for (int j = 0; j < TT; ++j) acc[i][j] = 0.0f;
  for (int it = 0; it < iters; ++it) {
    // A and B may have changed for all the compiler knows: every iteration
    // reloads them and recomputes its product
    asm volatile("" ::: "memory");
    float p[TT][TT];
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < TT; ++j) p[i][j] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < ks; ++k) {
      float a[TT], b[TT];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 av = *reinterpret_cast<const float4*>(
            a_at + k * T + g * kGroupStride);
        const float4 bv = *reinterpret_cast<const float4*>(
            b_at + k * T + g * kGroupStride);
        a[4 * g] = av.x;
        a[4 * g + 1] = av.y;
        a[4 * g + 2] = av.z;
        a[4 * g + 3] = av.w;
        b[4 * g] = bv.x;
        b[4 * g + 1] = bv.y;
        b[4 * g + 2] = bv.z;
        b[4 * g + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < TT; ++i)
#pragma unroll
        for (int j = 0; j < TT; ++j) p[i][j] = fmaf(a[i], b[j], p[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TT; ++i)
#pragma unroll
      for (int j = 0; j < TT; ++j) acc[i][j] += p[i][j];
  }
  float* o = part + static_cast<long long>(blockIdx.z) * gridDim.y * T * N;
#pragma unroll
  for (int i = 0; i < TT; ++i) {
    const long long row =
        m0 + (i / 4) * kGroupStride + ty * 4 + (i % 4);
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
      *reinterpret_cast<float4*>(o + row * N + n0 + g * kGroupStride +
                                 tx * 4) =
          make_float4(acc[i][4 * g], acc[i][4 * g + 1], acc[i][4 * g + 2],
                      acc[i][4 * g + 3]);
  }
}

// out = part[0] + part[1] + ... + part[splits - 1], in that order.
__global__ void split_sum_kernel(const float4* __restrict__ part,
                                 float4* __restrict__ out, long long n4,
                                 int splits) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n4; i += stride) {
    float4 s = part[i];
    for (int q = 1; q < splits; ++q) {
      const float4 v = part[q * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[i] = s;
  }
}

// Launches kernel after the grid before it on the stream, its blocks
// starting while that grid drains (programmatic dependent launch): the
// kernel calls wait_prior_grid() before it reads what that grid wrote.
template <typename... Params, typename... Args>
cudaError_t launch_after(void (*kernel)(Params...), dim3 grid, int threads,
                         size_t smem, cudaStream_t s, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

cudaError_t allow_smem(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int T, int TT>
cudaError_t launch_big_matmul(dim3 grid, size_t smem, cudaStream_t stream,
                              const float* A, const float* B, float* part,
                              int K, int N, int ks, int iters) {
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(big_matmul_kernel<T, TT>), smem);
  if (err != cudaSuccess) return err;
  big_matmul_kernel<T, TT><<<grid, (T / TT) * (T / TT), smem, stream>>>(
      A, B, part, K, N, ks, iters);
  return cudaGetLastError();
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

// iters chained column gathers of (rows, 128), 1 <= rows <= 16384.  The
// launch shape (micro.gather_loop_tiling) must be the kernels': pitch =
// rows rounded up to 32, 128 loop blocks of 1024 threads with 2 x pitch
// floats of shared memory; scratch holds 3 x 128 x pitch floats (tab, idx
// and the result, column-major).  Three launches: tab and idx transposed
// into scratch, the loop, the result transposed into out; the last two by
// programmatic dependent launch.
int micro_gather_loop(const void* tab, const void* idx, void* out,
                      void* scratch, int rows, int iters, int blocks,
                      int threads, long long smem, int pitch, void* stream) {
  const int max_rows = kLoopVecs * 4 * kBlockThreads;
  if (rows < 1 || rows > max_rows || iters < 0 || blocks != kLanes ||
      threads != kBlockThreads || pitch != (rows + kTT - 1) / kTT * kTT ||
      smem != 2 * static_cast<long long>(sizeof(float)) * pitch ||
      scratch == nullptr)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(gather_loop_kernel), smem);
  if (err != cudaSuccess) return err;
  const long long plane = static_cast<long long>(kLanes) * pitch;
  uint32_t* tabT = static_cast<uint32_t*>(scratch);
  uint32_t* idxT = tabT + plane;
  uint32_t* outT = idxT + plane;
  tile_transpose_kernel<<<dim3(kLanes / kTT, pitch / kTT, 2), kTTThreads, 0,
                          s>>>(static_cast<const uint32_t*>(tab), tabT,
                               static_cast<const uint32_t*>(idx), idxT, rows,
                               kLanes, kLanes, pitch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = launch_after(gather_loop_kernel, dim3(kLanes), kBlockThreads, smem, s,
                     reinterpret_cast<const float*>(tabT),
                     reinterpret_cast<const int32_t*>(idxT),
                     reinterpret_cast<float*>(outT), pitch, iters);
  if (err != cudaSuccess) return err;
  return launch_after(tile_transpose_kernel,
                      dim3(pitch / kTT, kLanes / kTT, 1), kTTThreads, 0, s,
                      static_cast<const uint32_t*>(outT),
                      static_cast<uint32_t*>(out),
                      static_cast<const uint32_t*>(nullptr),
                      static_cast<uint32_t*>(nullptr), kLanes,
                      pitch, rows, kLanes);
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

// iters x (lane gather, + 1) over (rows, 128).  The launch shape
// (micro3.lane_gather_loop_tiling) must be the kernel's: a block of
// kLaneWarps warps for each 32 rows, 32,768 bytes of shared memory.
int micro_lane_gather_loop(const void* x, const void* idx, void* out,
                           long long rows, int iters, long long blocks,
                           int threads, long long smem, void* stream) {
  if (rows < 1 || iters < 0 ||
      blocks != (rows + kLaneRows - 1) / kLaneRows ||
      threads != kLaneThreads || smem != static_cast<long long>(kLaneSmem))
    return cudaErrorInvalidValue;
  lane_gather_loop_kernel<<<static_cast<unsigned>(blocks), kLaneThreads,
                            kLaneSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(idx),
      static_cast<float*>(out), rows, iters);
  return cudaGetLastError();
}

// iters x (transpose every 128 x 128 tile, + 1); rows % 128 == 0.  The
// launch shape (micro3.transpose_loop_tiling) must be the kernel's: two
// blocks a tile of 1024 threads, 66,560 bytes of shared memory each.
int micro_transpose_loop(const void* x, void* out, long long rows, int iters,
                         long long blocks, int threads, long long smem,
                         void* stream) {
  if (rows < kTile || rows % kTile != 0 || iters < 0 ||
      blocks != 2 * (rows / kTile) || threads != kBlockThreads ||
      smem != static_cast<long long>(kTransposeSmem))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_smem(
      reinterpret_cast<const void*>(transpose_loop_kernel), kTransposeSmem);
  if (err != cudaSuccess) return err;
  transpose_loop_kernel<<<static_cast<unsigned>(blocks), kBlockThreads,
                          kTransposeSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), iters);
  return cudaGetLastError();
}

// iters x the 5-pass sandwich on every tile; rows % 128 == 0.  The launch
// shape (micro3.sandwich_tiling) must be the kernel's: a block of 1024
// threads a tile, 198,144 bytes of shared memory each.
int micro_sandwich(const void* x, const void* s1, const void* s2,
                   const void* s3, void* out, long long rows, int iters,
                   long long blocks, int cluster, int threads,
                   long long smem, void* stream) {
  if (rows < kTile || rows % kTile != 0 || iters < 0 ||
      blocks != rows / kTile || cluster != 1 || threads != kBlockThreads ||
      smem != static_cast<long long>(kSandwichSmem))
    return cudaErrorInvalidValue;
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(sandwich_kernel), kSandwichSmem);
  if (err != cudaSuccess) return err;
  sandwich_kernel<<<static_cast<unsigned>(blocks), kBlockThreads,
                    kSandwichSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(s1),
      static_cast<const int32_t*>(s2), static_cast<const int32_t*>(s3),
      static_cast<float*>(out), iters);
  return cudaGetLastError();
}

// C = iters x (+ A @ B) from zero; A (M, K), B (K, N).  Block tile
// tile x tile (128, 64 or 32, dividing M and N), K-slice ks (a multiple of
// 32 dividing K, 8 * ks * tile bytes of shared memory at most 227 KB); part
// holds (K / ks) x M x N floats where K / ks > 1, and is not read otherwise.
int micro_big_matmul(const void* A, const void* B, void* C, void* part,
                     int M, int K, int N, int iters, int tile, int ks,
                     void* stream) {
  if ((tile != 32 && tile != 64 && tile != 128) || M < tile || N < tile ||
      M % tile || N % tile || ks < 32 || ks % 32 || K % ks || iters < 0)
    return cudaErrorInvalidValue;
  const int splits = K / ks;
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(ks) * tile;
  if (smem > kMaxBlockSmem || (splits > 1 && part == nullptr))
    return cudaErrorInvalidValue;
  float* dst = static_cast<float*>(splits > 1 ? part : C);
  const dim3 grid(N / tile, M / tile, splits);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* b = static_cast<const float*>(B);
  cudaError_t err;
  switch (tile) {
    case 128:
      err = launch_big_matmul<128, 8>(grid, smem, s, a, b, dst, K, N, ks,
                                      iters);
      break;
    case 64:
      err = launch_big_matmul<64, 4>(grid, smem, s, a, b, dst, K, N, ks,
                                     iters);
      break;
    case 32:
      err = launch_big_matmul<32, 4>(grid, smem, s, a, b, dst, K, N, ks,
                                     iters);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = static_cast<long long>(M) * N / 4;
  split_sum_kernel<<<grid_for(n4, 256), 256, 0, s>>>(
      static_cast<const float4*>(part), static_cast<float4*>(C), n4, splits);
  return cudaGetLastError();
}

const char* micro_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
