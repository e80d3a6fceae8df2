// Barrier probe: the cost of one barrier across the blocks of an auction
// solve, measured as an empty persistent loop of `rounds` barriers.
//
//   - `soft_barrier_kernel`: the software grid barrier the auction loop used
//     up to its cluster design (kept here only, for this measurement): a
//     __syncthreads, a __threadfence and one atomicAdd a block on a global
//     counter, a spin on a volatile generation word with __nanosleep(32), a
//     __threadfence and a __syncthreads, under a cooperative launch of
//     `blocks` blocks of 256 threads;
//   - `cluster_barrier_kernel`: the hardware barrier of one thread-block
//     cluster (barrier.cluster.arrive.release / barrier.cluster.wait.acquire),
//     one cluster of `cluster` blocks of `threads` threads, launched with
//     cudaLaunchKernelEx and a cluster-dimension attribute.
//
// Neither replaces a TPU kernel: it is a measurement tool of
// same_tpu_torch/microbench.py, and no solve path runs it.

#include <cuda_runtime.h>

namespace {

constexpr int kSoftThreads = 256;

__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      unsigned int spins = 0;
      while (*gen == g) {
        __nanosleep(32);
        if (++spins == (1u << 28)) __trap();
      }
    }
    __threadfence();
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kSoftThreads)
soft_barrier_kernel(unsigned int* bar, int rounds) {
  for (int r = 0; r < rounds; ++r) grid_barrier(bar, gridDim.x);
}

__global__ void cluster_barrier_kernel(int rounds) {
  for (int r = 0; r < rounds; ++r) {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
}

cudaLaunchConfig_t cluster_config(int cluster, int threads, cudaStream_t st,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int allow_large_clusters() {
  return static_cast<int>(cudaFuncSetAttribute(
      cluster_barrier_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
}

}  // namespace

// `rounds` software grid barriers over `blocks` co-resident blocks; `bar` is
// two zeroed unsigned ints of device memory.
extern "C" int same_probe_soft(int blocks, int rounds, unsigned int* bar,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&bar, &rounds};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(soft_barrier_kernel),
                                  dim3(blocks), dim3(kSoftThreads), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// Clusters of `cluster` blocks of `threads` threads the device holds at once
// (0 when it holds none).
extern "C" int same_probe_max_clusters(int cluster, int threads, int* out) {
  *out = 0;
  int err = allow_large_clusters();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(cluster, threads, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      out, reinterpret_cast<void*>(cluster_barrier_kernel), &cfg));
}

// `rounds` cluster barriers in one cluster of `cluster` x `threads`.
extern "C" int same_probe_cluster(int cluster, int threads, int rounds,
                                  void* stream) {
  int err = allow_large_clusters();
  if (err != 0) return err;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(
      cluster, threads, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, cluster_barrier_kernel, rounds);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
