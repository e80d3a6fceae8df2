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
// The Pallas kernel works on 1,024-row tiles that the TPU walks in order.
// Nothing carries over between rows, so here the rows run side by side.
//
// What bounds it on the H100: bytes. It reads 9 bytes an entry plus 4 a row
// and writes 8 a row: at the microbenchmark's [12288, 8] about 1.0 MB, 0.3 us
// at 3.35 TB/s, and 2.8 MB, 0.84 us, at [12288, 24], below what one launch
// costs. So the design keeps every load in flight at once and the card full:
//   - a row is split over a group of G lanes, each lane a contiguous run of K
//     columns. At C = 8 (G = 2) and C = 24 (G = 6, five rows a warp) a lane's
//     run is one 16-byte load of costs, one of prices and a 4-byte load of
//     flags, neighbouring lanes on neighbouring words, so a warp's loads are
//     whole contiguous lines; any other C takes G = 4 with scalar loads,
//     issued a chunk of 4 columns at a time before any arithmetic;
//   - 128-thread blocks: 192 blocks at [12288, 8], 615 at [12288, 24], on
//     132 SMs;
//   - each lane runs the sequential chain over its own columns, then the
//     group merges its lanes' (best, second, col) with shuffles in column
//     order, left before right:
//       right.best > left.best: (right.best, max(left.best, right.second),
//                                right.col),
//       otherwise:              (left.best, max(left.second, right.best),
//                                left.col).
//     Over the multiset of a row's values, best is the largest with its first
//     column and second the next, exactly as the chain leaves them; only a
//     zero's sign in `second` may differ, and it cannot change incr.
//
// Exactness: __fadd_rn / __fsub_rn, and the file is built with --fmad=false;
// the plain PyTorch version gives the same bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 128;
constexpr float kNeg = -3.0e38f;

struct Best {
  float best, second;
  int col;
};

// One column of the chain: strict '>' keeps the lower column on ties. A
// value of NEG (or any value not above NEG) changes nothing.
__device__ __forceinline__ void step(Best& t, float v, int k) {
  const bool better = v > t.best;
  t.second = better ? t.best : fmaxf(t.second, v);
  t.col = better ? k : t.col;
  t.best = better ? v : t.best;
}

// The chain over the columns of l and then those of r.
__device__ __forceinline__ Best merge(const Best& l, const Best& r) {
  return r.best > l.best ? Best{r.best, fmaxf(l.best, r.second), r.col}
                         : Best{l.best, fmaxf(l.second, r.best), l.col};
}

// Rows of width C split over groups of G lanes; with K4, each lane's run is
// 4 columns read by vector loads (C = 4 G, rows 16-byte aligned), else
// ceil(C / G) columns by scalar loads.
template <int G, bool K4>
__global__ void __launch_bounds__(kBlock) bid_compute_kernel(
    const float* __restrict__ costs, const float* __restrict__ p_slot,
    const uint8_t* __restrict__ valid, const float* __restrict__ nm, int n, int C,
    int* __restrict__ choice, float* __restrict__ incr) {
  constexpr int kRows = 32 / G;  // rows a warp; lanes past kRows * G idle
  const int lane = static_cast<int>(threadIdx.x) & 31;
  const int warp = (static_cast<int>(blockIdx.x) * kBlock + static_cast<int>(threadIdx.x)) >> 5;
  const int g = lane / G, rank = lane - g * G;
  const int i = warp * kRows + g;
  const bool live = g < kRows && i < n;
  const int K = K4 ? 4 : (C + G - 1) / G;
  const int k_first = rank * K;
  Best t{kNeg, kNeg, k_first};
  float vnm = 0.0f;
  if (live) {
    const size_t row = static_cast<size_t>(i) * C;
    if (rank == 0) vnm = -nm[i];
    if constexpr (K4) {
      const float4 c = *reinterpret_cast<const float4*>(costs + row + k_first);
      const float4 p = *reinterpret_cast<const float4*>(p_slot + row + k_first);
      const unsigned int ok = *reinterpret_cast<const unsigned int*>(valid + row + k_first);
      const float cs[4] = {c.x, c.y, c.z, c.w};
      const float ps[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = -__fadd_rn(cs[j], ps[j]);
        step(t, ((ok >> (8 * j)) & 0xffu) ? v : kNeg, k_first + j);
      }
    } else {
      const int k_end = min(k_first + K, C);
      for (int k0 = k_first; k0 < k_end; k0 += 4) {
        float cs[4], ps[4];
        bool ok[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const size_t idx = row + min(k0 + j, C - 1);
          cs[j] = costs[idx];
          ps[j] = p_slot[idx];
          ok[j] = valid[idx] != 0 && k0 + j < k_end;
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float v = -__fadd_rn(cs[j], ps[j]);
          step(t, ok[j] ? v : kNeg, k0 + j);
        }
      }
    }
  }
  // Lane r of a group takes in lane r + off's summary where r is a multiple
  // of 2 off: a tree over the group's runs in column order. Every lane of
  // the warp shuffles; only a group's own lanes are read.
#pragma unroll
  for (int off = 1; off < G; off <<= 1) {
    Best r;
    r.best = __shfl_down_sync(0xffffffffu, t.best, off);
    r.second = __shfl_down_sync(0xffffffffu, t.second, off);
    r.col = __shfl_down_sync(0xffffffffu, t.col, off);
    if ((rank & (2 * off - 1)) == 0 && rank + off < G) t = merge(t, r);
  }
  if (live && rank == 0) {
    step(t, vnm, C);
    const float alt = t.second > kNeg ? t.second : __fsub_rn(t.best, 1.0f);
    choice[i] = t.col;
    incr[i] = __fadd_rn(__fsub_rn(t.best, alt), 1.0f);
  }
}

template <int G, bool K4>
cudaError_t launch(const float* costs, const float* p_slot, const uint8_t* valid,
                   const float* nm, int n, int C, int* choice, float* incr,
                   cudaStream_t st) {
  constexpr int kRows = 32 / G;
  const long long warps = (static_cast<long long>(n) + kRows - 1) / kRows;
  const long long blocks = (warps * 32 + kBlock - 1) / kBlock;
  bid_compute_kernel<G, K4><<<static_cast<unsigned int>(blocks), kBlock, 0, st>>>(
      costs, p_slot, valid, nm, n, C, choice, incr);
  return cudaGetLastError();
}

}  // namespace

// One launch; choice and incr of every row. Rows of width 8 or 24 take the
// vector loads where costs and p_slot are 16-byte aligned and valid 4-byte
// aligned, any other width or alignment the scalar loads.
extern "C" int same_bid_compute(const float* costs, const float* p_slot,
                                const uint8_t* valid, const float* nm, int n,
                                int C, int* choice, float* incr, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = ((reinterpret_cast<uintptr_t>(costs) | reinterpret_cast<uintptr_t>(p_slot)) &
                    15u) == 0 && (reinterpret_cast<uintptr_t>(valid) & 3u) == 0;
  cudaError_t e;
  if (vec && C == 8) {
    e = launch<2, true>(costs, p_slot, valid, nm, n, C, choice, incr, st);
  } else if (vec && C == 24) {
    e = launch<6, true>(costs, p_slot, valid, nm, n, C, choice, incr, st);
  } else {
    e = launch<4, false>(costs, p_slot, valid, nm, n, C, choice, incr, st);
  }
  return static_cast<int>(e);
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
