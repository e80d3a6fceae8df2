// K4 `sinkhorn_sparse`: log-domain Sinkhorn over padded [n, K] candidates
// with a no-match sink.
//
// Replaces same_tpu/ops/sinkhorn.py:56-99 (`sinkhorn_sparse`, XLA). Each
// iteration is two passes:
//   - the row pass, one thread per aligned row: gather the ref duals g of
//     its K candidates, form the masked logits (g - cost) / eps and the
//     sink's -nm / eps, take the row's logsumexp (maximum first, then the
//     sum over columns 0..K in that order) and write the row of the plan,
//     exp(logit - logsumexp), with 0 in the invalid columns;
//   - the ref pass, one thread per ref: sum the mass its candidates send,
//     then g = min(g - eps * log(max(mass, 1e-9)), 0).
// After the last iteration one more row pass writes the final plan. One call
// of `same_sinkhorn_sparse` enqueues the whole chain (2 * n_iters + 1
// launches) on the caller's stream, so the host is not in the loop.
//
// The XLA version gets the mass by a scatter-add with duplicate indices. A
// float atomicAdd would make the sum's order, and so g, vary from run to
// run. Here the wrapper builds once per problem the list of plan entries of
// each ref (sorted by row, then column), and the ref pass gathers and sums
// them in that order: the result repeats, and equals the plain PyTorch
// version's, which adds in the same order.
//
// What bounds it on the H100: operations, barely; the work is tiny. Per
// iteration about 8 f32 operations (two of them exp) for each valid
// candidate and each sink, ~0.3 M entries at the LUAD window; the ~4 MB of
// inputs and plan stay in L2 across the chain. In practice the ~200 launches
// of a few microseconds each set the time. Two launches an iteration were
// chosen over one cooperative launch with a grid barrier: a barrier costs
// about what a launch costs here, and plain launches need no co-residency,
// which two windows in flight on two host threads could not promise.
//
// Exactness: every step is rounded to f32 in the plain version's order
// (__fsub_rn / __fdiv_rn / __fadd_rn / __fmul_rn; built with --fmad=false);
// expf and logf are CUDA's, the ones PyTorch's exp and log use on the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ float logit(float g, float cost, float eps) {
  return __fdiv_rn(__fsub_rn(g, cost), eps);
}

__global__ void row_pass_kernel(const float* __restrict__ costs,
                                const int* __restrict__ ref,
                                const uint8_t* __restrict__ valid,
                                const float* __restrict__ nm,
                                const float* __restrict__ g, float eps, int n,
                                int K, int n_ref, float* __restrict__ plan) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(i) * K;
  float* out = plan + static_cast<size_t>(i) * (K + 1);
  const float sink = logit(0.0f, nm[i], eps);
  float mx = sink;
  for (int k = 0; k < K; ++k) {
    if (valid[row + k]) {
      int r = min(max(ref[row + k], 0), n_ref - 1);
      mx = fmaxf(mx, logit(g[r], costs[row + k], eps));
    }
  }
  float s = 0.0f;
  for (int k = 0; k < K; ++k) {
    if (valid[row + k]) {
      int r = min(max(ref[row + k], 0), n_ref - 1);
      s = __fadd_rn(s, expf(__fsub_rn(logit(g[r], costs[row + k], eps), mx)));
    }
  }
  s = __fadd_rn(s, expf(__fsub_rn(sink, mx)));
  const float lse = __fadd_rn(logf(s), mx);
  for (int k = 0; k < K; ++k) {
    float p = 0.0f;
    if (valid[row + k]) {
      int r = min(max(ref[row + k], 0), n_ref - 1);
      p = expf(__fsub_rn(logit(g[r], costs[row + k], eps), lse));
    }
    out[k] = p;
  }
  out[K] = expf(__fsub_rn(sink, lse));
}

__global__ void ref_pass_kernel(const float* __restrict__ plan,
                                const int* __restrict__ ptr,
                                const int* __restrict__ ent, float eps,
                                int n_ref, float* __restrict__ g) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_ref) return;
  float mass = 0.0f;
  for (int e = ptr[r]; e < ptr[r + 1]; ++e) {
    mass = __fadd_rn(mass, plan[ent[e]]);
  }
  float gn = __fsub_rn(g[r], __fmul_rn(eps, logf(fmaxf(mass, 1e-9f))));
  g[r] = fminf(gn, 0.0f);
}

}  // namespace

// g [n_ref] comes in as the start duals (zeros) and leaves as the result;
// plan [n, K + 1] is scratch during the iterations and the final plan after.
extern "C" int same_sinkhorn_sparse(const float* costs, const int* ref,
                                    const uint8_t* valid, const float* nm,
                                    const int* ptr, const int* ent, int n,
                                    int K, int n_ref, float eps, int n_iters,
                                    float* g, float* plan, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int row_grid = (n + kThreads - 1) / kThreads;
  const int ref_grid = (n_ref + kThreads - 1) / kThreads;
  for (int it = 0; it <= n_iters; ++it) {
    row_pass_kernel<<<row_grid, kThreads, 0, st>>>(costs, ref, valid, nm, g,
                                                   eps, n, K, n_ref, plan);
    if (it < n_iters) {
      ref_pass_kernel<<<ref_grid, kThreads, 0, st>>>(plan, ptr, ent, eps,
                                                     n_ref, g);
    }
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
