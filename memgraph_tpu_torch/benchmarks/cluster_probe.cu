// Probes of a thread-block cluster of 4 on Hopper (sm_90a): what a tile
// kernel split over a cluster pays to synchronise and to move values
// between the blocks' shared memories.  Plain C interface for ctypes
// (benchmarks/cluster_probe.py); each entry point launches on the given
// stream and returns the launch's CUDA error.
//   barrier: n rounds of barrier.cluster arrive (release) + wait (acquire)
//   push:    n rounds of one 16-byte st.shared::cluster a thread to the
//            block `shift` ranks on (0: its own block through the
//            cluster window), one cluster barrier at the end
//   bulk:    n rounds of an all-to-all exchange: thread 0 sends `bytes`
//            to each of the 3 other blocks by cp.async.bulk, signalling
//            the receiver's mbarrier, and the block waits for its own 3
//            (mbarriers double-buffered by round parity)

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kCluster = 4;

__device__ __forceinline__ unsigned rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned map_rank(unsigned local, unsigned r) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(local), "r"(r));
  return out;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__global__ void barrier_kernel(int n, float* out) {
  for (int i = 0; i < n; ++i) cluster_sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = static_cast<float>(n);
}

__global__ void push_kernel(int n, int shift, float* out) {
  extern __shared__ __align__(16) float sm[];
  const unsigned to =
      map_rank(smem_addr(sm + 4 * threadIdx.x), (rank() + shift) % kCluster);
  float v = static_cast<float>(threadIdx.x);
  cluster_sync();
  for (int i = 0; i < n; ++i) {
    asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %1, %1, %1};" ::"r"(
                     to + 16 * blockDim.x * (i & 1)), "f"(v)
                 : "memory");
    v += 1.0f;
  }
  cluster_sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = sm[4 * threadIdx.x];
}

// shared memory: the source (bytes), 2 x 3 receive slots, 2 mbarriers
__global__ void bulk_kernel(int n, int bytes, float* out) {
  extern __shared__ __align__(128) unsigned char sb[];
  const unsigned r = rank();
  const unsigned base = smem_addr(sb);
  const unsigned bars = base + 7 * bytes;
  if (threadIdx.x == 0) {
    for (int k = 0; k < 2; ++k)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bars + 8 * k)
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();
  for (int i = 0; i < n; ++i) {
    const unsigned b = i & 1, bar = bars + 8 * b;
    if (threadIdx.x == 0) {
      for (int k = 1; k < kCluster; ++k) {
        const unsigned o = (r + k) % kCluster;
        // this sender's slot at the receiver: (r - o - 1) mod 4, in 0..2
        const unsigned slot = (r + kCluster - o - 1) % kCluster;
        asm volatile(
            "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];" ::"r"(
                map_rank(base + bytes * (1 + 3 * b + slot), o)),
            "r"(base), "r"(bytes), "r"(map_rank(bar, o))
            : "memory");
      }
      asm volatile(
          "{\n\t.reg .b64 st;\n\t"
          "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
              bar), "r"(3 * bytes)
          : "memory");
    }
    // bounded: a fault traps instead of hanging the card
    unsigned done = 0;
    for (long long spin = 0; !done && spin < (1ll << 26); ++spin)
      asm volatile(
          "{\n\t.reg .pred P;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, P;\n\t}"
          : "=r"(done) : "r"(bar), "r"((i >> 1) & 1) : "memory");
    if (!done) __trap();
  }
  cluster_sync();
  out[blockIdx.x * blockDim.x + threadIdx.x] = sb[threadIdx.x];
}

template <typename... Args>
int launch(void (*kernel)(Args...), int blocks, int threads, size_t smem,
           void* stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

extern "C" {

// out holds blocks x threads floats; blocks a multiple of 4.
int probe_barrier(int blocks, int threads, int n, void* out, void* stream) {
  return launch(barrier_kernel, blocks, threads, 0, stream, n,
                static_cast<float*>(out));
}

int probe_push(int blocks, int threads, int n, int shift, void* out,
               void* stream) {
  return launch(push_kernel, blocks, threads, 32 * threads, stream, n, shift,
                static_cast<float*>(out));
}

// bytes a multiple of 16
int probe_bulk(int blocks, int threads, int n, int bytes, void* out,
               void* stream) {
  if (bytes < 16 || bytes % 16) return cudaErrorInvalidValue;
  return launch(bulk_kernel, blocks, threads, 7 * bytes + 16, stream, n,
                bytes, static_cast<float*>(out));
}

}  // extern "C"
