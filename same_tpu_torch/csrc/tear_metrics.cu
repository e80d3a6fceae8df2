// K2 `tear_metrics`: the per-tear-round flip test and cheapest-to-move vertex;
// K6 `tear_metrics_batch`: the same for every window of a batch of
// same-bucket windows ([B, T_pad] padded triangles, [B, n, C] rows, [B, m, 2]
// ref coordinates), in the same two launches. K2 is K6 with B = 1: one body.
//
// Replaces
//   - same_tpu/solver/tearing.py:72-104 (`_tear_metrics`, XLA);
//   - same_tpu/solver/tearing_device.py:124-126 (the flip test) and :233-243
//     (the regret and `vmove` of the surcharge) inside the fused loop;
//   - same_tpu/ops/orient.py:52-86 (`matched_triangle_flips`) as used there;
//   - K6: the same vmapped over the window batch of
//     same_tpu/solver/tearing_device.py:514-811 (run_tearing_device_batch).
//     Per window it is K2's body on the window's own rows, so it gives K2's
//     bits on the unpadded triangles; padded triangles carry tri_mask 0 and
//     src 0 and come out unchecked.
//
// Two steps, launched one after the other on the caller's stream by one C
// call, as JAX computes it (the regret once a row, then gathered):
//   1. The row regret, one warp a row of the B x n stacked rows. Lane k reads
//      column k (striding by 32 where C > 32): the rows of costs, extra,
//      slots, pair_idx and valid are read coalesced and every lane issues its
//      prices[slot] gather at once, with no branch before the loads. The
//      held value comes from lane `col` by shuffle, the best alternative
//      outside the held pair from a shuffle-max tree (max is exact and
//      independent of order, so it gives a serial loop's bits). The row's
//      regret and matched ref go to an 8-byte scratch entry.
//   2. The triangles, one thread each of the B x T: three 8-byte gathers of
//      (regret, match_ref), the orientation of the image, `checked`,
//      `flipped` and the first argmin of the three regrets, as jnp.argmin.
//
// What bounds it on the H100: bytes, 6.64 MB at the LUAD window (each input
// read once, each output written once) in 2 us at 3.35 TB/s, and in practice
// the latency of two dependent launches. The design reads each row once (a
// vertex lies in about 6 triangles), with no serial walk over the columns
// (a thread that walked its 3 vertices' C columns would wait on about 72
// dependent L2 round trips), and spreads the rows over the card: 1,536
// blocks at LUAD, where one thread a triangle fills 28.
//
// Exactness: the values are -(costs + extra + price) with __fadd_rn in that
// order and the regret held - alt with __fsub_rn, as tearing.py computes
// them; the cross product uses __fmul_rn / __fsub_rn (and the file is built
// with --fmad=false). An FMA-contracted cross product takes another sign than
// XLA and torch on near-degenerate triangles; exact sign parity is the point
// of this kernel.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;  // 8 rows, one a warp, a block
constexpr int kTriThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// One row's result of step 1, gathered by step 2 in one load a vertex.
struct __align__(8) RowOut {
  float regret;  // held value minus the best alternative outside the held pair
  int ref;       // matched ref, or -1
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Step 1: row r of the [rows = B * n] stack (tearing.py:92-101); prices of
// window r / n.
__global__ void __launch_bounds__(kRowThreads) tear_metrics_rows_kernel(
    const int* __restrict__ choice, const int* __restrict__ cand_ref,
    const int* __restrict__ pair_idx, const float* __restrict__ costs,
    const float* __restrict__ extra, const int* __restrict__ slots,
    const uint8_t* __restrict__ valid, const float* __restrict__ nm,
    const float* __restrict__ prices, int rows, int n, int C, int S1,
    RowOut* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long r =
      static_cast<long long>(blockIdx.x) * (kRowThreads / 32) + (threadIdx.x >> 5);
  if (r >= rows) return;  // uniform over the warp
  const float* p = prices + (r / n) * S1;
  const size_t row = static_cast<size_t>(r) * C;
  const int ch = choice[r];
  const bool is_match = ch < C;
  const int col = min(max(ch, 0), C - 1);
  const int mp = is_match ? pair_idx[row + col] : -1;
  const float neg_nm = -nm[r];
  float held = neg_nm;
  float alt = neg_inf();
  for (int k0 = 0; k0 < C; k0 += 32) {  // uniform over the warp
    const int k = k0 + lane;
    float val = neg_inf();
    if (k < C) {
      const size_t i = row + k;
      const bool ok = valid[i] != 0;
      const int pk = pair_idx[i];
      const int s = min(max(slots[i], 0), S1 - 1);
      const float v = -__fadd_rn(__fadd_rn(costs[i], extra[i]), p[s]);
      val = ok ? v : neg_inf();
      if (ok && pk != mp) alt = fmaxf(alt, val);
    }
    const float at_col = __shfl_sync(kFull, val, col & 31);
    if (is_match && (col >> 5) == (k0 >> 5)) held = at_col;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    alt = fmaxf(alt, __shfl_xor_sync(kFull, alt, off));
  }
  if (lane == 0) {
    RowOut o;
    o.regret = __fsub_rn(held, fmaxf(alt, neg_nm));
    o.ref = is_match ? cand_ref[row + col] : -1;
    out[r] = o;
  }
}

// Step 2: triangle t of the [total = B * T] stack, of window t / T.
__global__ void __launch_bounds__(kTriThreads) tear_metrics_tris_kernel(
    const RowOut* __restrict__ row_out, const int* __restrict__ tris,
    const uint8_t* __restrict__ tri_mask, const int* __restrict__ src,
    const float* __restrict__ ref_xy, int n, int m, int T, long long total,
    uint8_t* __restrict__ checked, uint8_t* __restrict__ flipped,
    int8_t* __restrict__ vmove) {
  const long long t = static_cast<long long>(blockIdx.x) * kTriThreads + threadIdx.x;
  if (t >= total) return;
  const long long w = t / T;
  const RowOut* ro = row_out + w * n;
  const float* xy = ref_xy + w * 2 * m;
  int ref[3];
  bool all_matched = tri_mask[t] != 0;
  float reg_min = 0.0f;
  int arg = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int v = min(max(tris[3 * t + i], 0), n - 1);
    const RowOut o = ro[v];
    all_matched = all_matched && (o.ref >= 0);
    ref[i] = min(max(o.ref, 0), m - 1);
    if (i == 0 || o.regret < reg_min) {  // first minimum, like jnp.argmin
      reg_min = o.regret;
      arg = i;
    }
  }
  const float ax = xy[2 * ref[0]], ay = xy[2 * ref[0] + 1];
  const float bx = xy[2 * ref[1]], by = xy[2 * ref[1] + 1];
  const float cx = xy[2 * ref[2]], cy = xy[2 * ref[2] + 1];
  const float cross = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                                __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
  const int sign = (cross > 0.0f) - (cross < 0.0f);
  const int s = src[t];
  const bool ck = all_matched && s != 0 && sign != 0;
  checked[t] = ck;
  flipped[t] = ck && sign != s;
  vmove[t] = static_cast<int8_t>(arg);
}

// Both steps for a [B, ...] stack; `scratch` holds B * n RowOut entries (8
// bytes each), allocated by the wrapper.
int launch(const int* choice, const int* cand_ref, const int* pair_idx,
           const float* costs, const float* extra, const int* slots,
           const uint8_t* valid, const float* nm, const float* prices,
           const int* tris, const uint8_t* tri_mask, const int* src,
           const float* ref_xy, int B, int n, int C, int S1, int m, int T,
           void* scratch, uint8_t* checked, uint8_t* flipped, int8_t* vmove,
           void* stream) {
  const long long total = static_cast<long long>(B) * T;
  if (total == 0) return 0;
  if (n < 1 || C < 1 || S1 < 1 || m < 1 ||
      static_cast<long long>(B) * n >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  RowOut* ro = static_cast<RowOut*>(scratch);
  const int rows = B * n;
  const int rows_per_block = kRowThreads / 32;
  tear_metrics_rows_kernel<<<(rows + rows_per_block - 1) / rows_per_block,
                             kRowThreads, 0, st>>>(
      choice, cand_ref, pair_idx, costs, extra, slots, valid, nm, prices, rows,
      n, C, S1, ro);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (total + kTriThreads - 1) / kTriThreads;
  tear_metrics_tris_kernel<<<static_cast<unsigned>(grid), kTriThreads, 0, st>>>(
      ro, tris, tri_mask, src, ref_xy, n, m, T, total, checked, flipped, vmove);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int same_tear_metrics(
    const int* choice, const int* cand_ref, const int* pair_idx,
    const float* costs, const float* extra, const int* slots,
    const uint8_t* valid, const float* nm, const float* prices,
    const int* tris, const uint8_t* tri_mask, const int* src,
    const float* ref_xy, int n, int C, int S1, int m, int T, void* scratch,
    uint8_t* checked, uint8_t* flipped, int8_t* vmove, void* stream) {
  return launch(choice, cand_ref, pair_idx, costs, extra, slots, valid, nm,
                prices, tris, tri_mask, src, ref_xy, 1, n, C, S1, m, T, scratch,
                checked, flipped, vmove, stream);
}

// K6: the same for each window of a [B, ...] stack, in the same two launches.
extern "C" int same_tear_metrics_batch(
    const int* choice, const int* cand_ref, const int* pair_idx,
    const float* costs, const float* extra, const int* slots,
    const uint8_t* valid, const float* nm, const float* prices,
    const int* tris, const uint8_t* tri_mask, const int* src,
    const float* ref_xy, int B, int n, int C, int S1, int m, int T,
    void* scratch, uint8_t* checked, uint8_t* flipped, int8_t* vmove,
    void* stream) {
  return launch(choice, cand_ref, pair_idx, costs, extra, slots, valid, nm,
                prices, tris, tri_mask, src, ref_xy, B, n, C, S1, m, T, scratch,
                checked, flipped, vmove, stream);
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
