// K10 `sinkhorn_dense`: log-domain Sinkhorn on a dense [n, m] cost matrix.
//
// Replaces same_tpu/ops/sinkhorn.py:27-53 (`sinkhorn_dense`, XLA). Each
// iteration:
//   f_i = eps * log(a_i) - eps * logsumexp_j((g_j - cost_ij) / eps)
//   g_j = eps * log(b_j) - eps * logsumexp_i((f_i - cost_ij) / eps)
// with the max-shifted logsumexp of torch and jax (max first, a max of
// +-inf taken as 0, then log(sum(exp(z - max))) + max); after the last one
// plan_ij = exp((f_i + g_j - cost_ij) / eps).
//
// Layout: one call of `same_sinkhorn_dense` enqueues the whole chain on the
// caller's stream: a transpose of the cost into a [m, n] scratch (so that
// the column logsumexp of the g-update reads rows as well), then two row
// passes an iteration (one block of 256 threads a row: the row's maximum,
// then the sum of exponentials, each reduced in the block by a fixed tree),
// then the plan. 2 * n_iters + 2 launches (and two memsets).
//
// Precision: the duals are carried in float64 between iterations, and each
// logit z, its shift z - max and the sum of exponentials are taken in
// float64; the exponentials themselves are float32 (expf of the shifted
// logit, whose rounding weighs little: a term's error is its weight times
// 2^-24 |z - max|). Inputs and outputs are float32. Sinkhorn's duals
// have a gauge direction, (f + k, g - k) leaves every update unchanged, on
// which the rounding of each iteration adds up without decaying: over 200
// iterations in float32 (the plain version, the JAX package) the duals
// drift by several ulp, by a random amount. Holding the duals and logits in
// float64 keeps that drift out, so the kernel's error against a float64 run
// is about the final rounding to float32, below the float32 version's.
//
// What bounds it on the H100: operations, by the count of the function's
// float32 work (about 12 an entry and iteration, 16.8 M entries, 200
// iterations: 40 GFLOP, 0.6 ms at 67 TFLOP/s); the bytes of the inputs and
// outputs read and written once are 134 MB, 0.04 ms. The cost does not fit
// in the 50 MB L2, so each iteration reads it twice from device memory (cost
// and its transpose, 134 MB, 40 us at 3.35 TB/s): about 8 ms for 200
// iterations is the practical floor of this layout. The float64 adds and
// multiplies, about six an entry and iteration, run at half the float32
// rate.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;

// out [cols, rows] = in [rows, cols]^T by 32 x 32 tiles; the row tiles are
// taken in a grid-stride loop over gridDim.y (any number of rows).
__global__ void transpose_kernel(const float* __restrict__ in, int rows,
                                 int cols, float* __restrict__ out) {
  __shared__ float tile[kTile][kTile + 1];
  const int c0 = blockIdx.x * kTile;
  for (int r0 = blockIdx.y * kTile; r0 < rows; r0 += gridDim.y * kTile) {
    for (int k = threadIdx.y; k < kTile; k += blockDim.y) {
      const int r = r0 + k, c = c0 + threadIdx.x;
      if (r < rows && c < cols) tile[k][threadIdx.x] = in[static_cast<size_t>(r) * cols + c];
    }
    __syncthreads();
    for (int k = threadIdx.y; k < kTile; k += blockDim.y) {
      const int c = c0 + k, r = r0 + threadIdx.x;
      if (r < rows && c < cols) out[static_cast<size_t>(c) * rows + r] = tile[threadIdx.x][k];
    }
    __syncthreads();  // the tile is refilled for the next row tile
  }
}

// Block-wide reductions in a fixed pattern; every thread gets the result.
__device__ double block_max(double x, double* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = fmax(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
  const double r = sh[0];
  __syncthreads();
  return r;
}

__device__ double block_sum(double x, double* sh) {
  sh[threadIdx.x] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = sh[threadIdx.x] + sh[threadIdx.x + s];
    __syncthreads();
  }
  const double r = sh[0];
  __syncthreads();
  return r;
}

// out_i = eps * log(marg_i) - eps * logsumexp_j((dual_j - cost_ij) / eps),
// row i = blockIdx.x of cost [rows, cols].
__global__ void __launch_bounds__(kThreads) dual_update_kernel(
    const float* __restrict__ cost, const double* __restrict__ dual,
    const float* __restrict__ marg, double eps, int cols,
    double* __restrict__ out) {
  __shared__ double shd[kThreads];
  const int i = blockIdx.x;
  const float* row = cost + static_cast<size_t>(i) * cols;
  const double inv = 1.0 / eps;
  double mx = -INFINITY;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    mx = fmax(mx, (dual[j] - static_cast<double>(row[j])) * inv);
  }
  mx = block_max(mx, shd);
  if (isinf(mx)) mx = 0.0;
  double s = 0.0;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const double z = (dual[j] - static_cast<double>(row[j])) * inv;
    s += static_cast<double>(expf(static_cast<float>(z - mx)));
  }
  s = block_sum(s, shd);
  if (threadIdx.x == 0) {
    const double lse = log(s) + mx;
    out[i] = eps * log(static_cast<double>(marg[i])) - eps * lse;
  }
}

// One thread an entry of the [n, m] plan, in a grid-stride loop (any n, m).
__global__ void plan_kernel(const float* __restrict__ cost,
                            const double* __restrict__ f,
                            const double* __restrict__ g, double eps, int n,
                            int m, float* __restrict__ plan,
                            float* __restrict__ f32, float* __restrict__ g32) {
  const size_t total = static_cast<size_t>(n) * m;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t at = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       at < total; at += stride) {
    const int i = static_cast<int>(at / m), j = static_cast<int>(at % m);
    plan[at] = static_cast<float>(exp((f[i] + g[j] - static_cast<double>(cost[at])) / eps));
    if (j == 0) f32[i] = static_cast<float>(f[i]);
    if (i == 0) g32[j] = static_cast<float>(g[j]);
  }
}

}  // namespace

// cost [n, m], a [n], b [m] float32; cost_t [m, n] float32 and f64, g64
// ([n], [m] float64) are scratch; writes plan [n, m], f [n] and g [m].
extern "C" int same_sinkhorn_dense(const float* cost, const float* a,
                                   const float* b, int n, int m, float eps,
                                   int n_iters, float* cost_t, double* f64,
                                   double* g64, float* plan, float* f,
                                   float* g, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const double e = static_cast<double>(eps);
  const int row_tiles = (n + kTile - 1) / kTile;
  transpose_kernel<<<dim3((m + kTile - 1) / kTile, row_tiles < 65535 ? row_tiles : 65535),
                     dim3(kTile, 8), 0, st>>>(cost, n, m, cost_t);
  cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) err = cudaMemsetAsync(f64, 0, sizeof(double) * n, st);
  if (err == cudaSuccess) err = cudaMemsetAsync(g64, 0, sizeof(double) * m, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int it = 0; it < n_iters; ++it) {
    dual_update_kernel<<<n, kThreads, 0, st>>>(cost, g64, a, e, m, f64);
    dual_update_kernel<<<m, kThreads, 0, st>>>(cost_t, f64, b, e, n, g64);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const size_t blocks = (static_cast<size_t>(n) * m + kThreads - 1) / kThreads;
  plan_kernel<<<static_cast<unsigned int>(blocks < (1u << 20) ? blocks : (1u << 20)),
                kThreads, 0, st>>>(cost, f64, g64, e, n, m, plan, f, g);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
