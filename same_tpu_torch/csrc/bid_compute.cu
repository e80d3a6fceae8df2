// K9 `bid_compute`: the compute-only step of an auction bidding round, with
// the slot prices already gathered.
//
// Replaces examples/bench_pallas.py:98-139 (`main.kernel`, the repo's one
// Pallas kernel, called through pl.pallas_call at :122) and the expression
// of its XLA twin `compute_xla` (:80-88). For each row:
//   - values v_k = valid ? -(costs + p_slot) : NEG over the C columns, with
//     NEG = -3e38 (the Pallas sentinel, not -inf);
//   - a top-2 unrolled over the C columns and then the no-match column
//     -nm, with a strict `>` so that a tie goes to the lower index;
//   - choice = the best column (C for no-match) and incr = best - (second >
//     NEG ? second : best - 1) + 1 (eps = 1).
//
// The Pallas kernel works on 1,024-row tiles that the TPU walks in order;
// here one thread takes one row and the blocks run side by side. Nothing
// carries over between rows, so no tile order is needed.
//
// What bounds it on the H100: bytes. It reads 9 bytes an entry plus 4 a row
// and writes 8 a row: at the microbenchmark's [12288, 8] about 1.0 MB, 0.3 us
// at 3.35 TB/s, far below a launch. Each thread reads its row's C values
// from three arrays; the rows of a warp are contiguous, so the warp's loads
// fall in a few cache lines.
//
// Exactness: __fadd_rn / __fsub_rn, and the file is built with --fmad=false;
// the plain PyTorch version gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNeg = -3.0e38f;

__global__ void bid_compute_kernel(const float* __restrict__ costs,
                                   const float* __restrict__ p_slot,
                                   const uint8_t* __restrict__ valid,
                                   const float* __restrict__ nm, int n, int C,
                                   int* __restrict__ choice,
                                   float* __restrict__ incr) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const size_t row = static_cast<size_t>(i) * C;
  float best = kNeg, second = kNeg;
  int bidx = 0;
  for (int k = 0; k < C; ++k) {
    const float vk = valid[row + k] ? -__fadd_rn(costs[row + k], p_slot[row + k]) : kNeg;
    const bool better = vk > best;
    second = better ? best : fmaxf(second, vk);
    bidx = better ? k : bidx;
    best = better ? vk : best;
  }
  const float vnm = -nm[i];
  const bool better = vnm > best;
  second = better ? best : fmaxf(second, vnm);
  bidx = better ? C : bidx;
  best = better ? vnm : best;
  const float alt = second > kNeg ? second : __fsub_rn(best, 1.0f);
  choice[i] = bidx;
  incr[i] = __fadd_rn(__fsub_rn(best, alt), 1.0f);
}

}  // namespace

extern "C" int same_bid_compute(const float* costs, const float* p_slot,
                                const uint8_t* valid, const float* nm, int n,
                                int C, int* choice, float* incr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (n + kThreads - 1) / kThreads;
  bid_compute_kernel<<<grid, kThreads, 0, st>>>(costs, p_slot, valid, nm, n, C,
                                                 choice, incr);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
