// K2 `tear_metrics`: the per-tear-round flip test and cheapest-to-move vertex;
// K6 `tear_metrics_batch`: the same for every window of a batch of
// same-bucket windows ([B, T_pad] padded triangles, [B, n, C] rows, [B, m, 2]
// ref coordinates), in one launch with blockIdx.y = window.
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
// One thread per triangle:
//   - gathers match_ref / match_pair of its 3 vertices from choice, cand_ref
//     and pair_idx;
//   - takes the image orientation, the sign of (b-a)x(c-a) on the f32 ref
//     coordinates, and sets `checked` / `flipped` exactly as
//     matched_triangle_flips does;
//   - computes each vertex's auction regret inline: held value minus the best
//     alternative outside the held pair, over the C columns plus no-match, at
//     costs + extra and the current prices;
//   - writes vmove = the first argmin of the 3 regrets.
//
// What bounds it on the H100: bytes. Per triangle it reads 3 vertex rows of
// [C] costs, extra, slots, valid and pair_idx (17 bytes an entry) plus the
// price gathers: at the LUAD window (T ~ 2n, C = 24) about 3.4 MB from a few
// hundred KB of distinct rows, so the working set sits in the 50 MB L2 and
// one launch replaces the ~30 XLA ops of the tear round. A vertex lies in
// about 6 triangles, so the regret is recomputed ~6x; that costs L2 reads
// only and saves an [n] round trip through device memory and a second launch.
//
// Exactness: the cross product and the sums use __fmul_rn / __fsub_rn /
// __fadd_rn (and the file is built with --fmad=false). An FMA-contracted
// cross product takes another sign than XLA and torch on near-degenerate
// triangles; exact sign parity is the point of this kernel.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Held value minus best alternative of aligned vertex v (tearing.py:92-101).
__device__ float vertex_regret(int v, const int* __restrict__ choice,
                               const int* __restrict__ pair_idx,
                               const float* __restrict__ costs,
                               const float* __restrict__ extra,
                               const int* __restrict__ slots,
                               const uint8_t* __restrict__ valid,
                               const float* __restrict__ nm,
                               const float* __restrict__ prices, int C) {
  const size_t row = static_cast<size_t>(v) * C;
  int ch = choice[v];
  bool is_match = ch < C;
  int col = min(max(ch, 0), C - 1);
  int mp = is_match ? pair_idx[row + col] : -1;
  float held;
  if (is_match) {
    held = valid[row + col]
               ? -__fadd_rn(__fadd_rn(costs[row + col], extra[row + col]),
                            prices[slots[row + col]])
               : neg_inf();
  } else {
    held = -nm[v];
  }
  float alt = neg_inf();
  for (int k = 0; k < C; ++k) {
    if (valid[row + k] && pair_idx[row + k] != mp) {
      float val = -__fadd_rn(__fadd_rn(costs[row + k], extra[row + k]),
                             prices[slots[row + k]]);
      alt = fmaxf(alt, val);
    }
  }
  alt = fmaxf(alt, -nm[v]);
  return __fsub_rn(held, alt);
}

// Triangle t of one window: flip test and vmove (the body of K2 and K6).
__device__ __forceinline__ void triangle_metrics(
    int t, const int* __restrict__ choice, const int* __restrict__ cand_ref,
    const int* __restrict__ pair_idx, const float* __restrict__ costs,
    const float* __restrict__ extra, const int* __restrict__ slots,
    const uint8_t* __restrict__ valid, const float* __restrict__ nm,
    const float* __restrict__ prices, const int* __restrict__ tris,
    const uint8_t* __restrict__ tri_mask, const int* __restrict__ src,
    const float* __restrict__ ref_xy, int n, int C, int m,
    uint8_t* __restrict__ checked, uint8_t* __restrict__ flipped,
    int8_t* __restrict__ vmove) {
  int ref[3];
  bool all_matched = tri_mask[t] != 0;
  float reg_min = 0.0f;
  int arg = 0;
  for (int i = 0; i < 3; ++i) {
    int v = min(max(tris[3 * t + i], 0), n - 1);
    int ch = choice[v];
    int col = min(max(ch, 0), C - 1);
    int r = ch < C ? cand_ref[static_cast<size_t>(v) * C + col] : -1;
    all_matched = all_matched && (r >= 0);
    ref[i] = min(max(r, 0), m - 1);
    float reg = vertex_regret(v, choice, pair_idx, costs, extra, slots, valid,
                              nm, prices, C);
    if (i == 0 || reg < reg_min) {  // first minimum, like jnp.argmin
      reg_min = reg;
      arg = i;
    }
  }
  float ax = ref_xy[2 * ref[0]], ay = ref_xy[2 * ref[0] + 1];
  float bx = ref_xy[2 * ref[1]], by = ref_xy[2 * ref[1] + 1];
  float cx = ref_xy[2 * ref[2]], cy = ref_xy[2 * ref[2] + 1];
  float cross = __fsub_rn(__fmul_rn(__fsub_rn(bx, ax), __fsub_rn(cy, ay)),
                          __fmul_rn(__fsub_rn(by, ay), __fsub_rn(cx, ax)));
  int sign = (cross > 0.0f) - (cross < 0.0f);
  int s = src[t];
  bool ck = all_matched && s != 0 && sign != 0;
  checked[t] = ck;
  flipped[t] = ck && sign != s;
  vmove[t] = static_cast<int8_t>(arg);
}

__global__ void tear_metrics_kernel(
    const int* __restrict__ choice, const int* __restrict__ cand_ref,
    const int* __restrict__ pair_idx, const float* __restrict__ costs,
    const float* __restrict__ extra, const int* __restrict__ slots,
    const uint8_t* __restrict__ valid, const float* __restrict__ nm,
    const float* __restrict__ prices, const int* __restrict__ tris,
    const uint8_t* __restrict__ tri_mask, const int* __restrict__ src,
    const float* __restrict__ ref_xy, int n, int C, int m, int T,
    uint8_t* __restrict__ checked, uint8_t* __restrict__ flipped,
    int8_t* __restrict__ vmove) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  triangle_metrics(t, choice, cand_ref, pair_idx, costs, extra, slots, valid,
                   nm, prices, tris, tri_mask, src, ref_xy, n, C, m, checked,
                   flipped, vmove);
}

// K6: window blockIdx.y of a [B, ...] stack, T triangles (padded) a window.
__global__ void tear_metrics_batch_kernel(
    const int* __restrict__ choice, const int* __restrict__ cand_ref,
    const int* __restrict__ pair_idx, const float* __restrict__ costs,
    const float* __restrict__ extra, const int* __restrict__ slots,
    const uint8_t* __restrict__ valid, const float* __restrict__ nm,
    const float* __restrict__ prices, const int* __restrict__ tris,
    const uint8_t* __restrict__ tri_mask, const int* __restrict__ src,
    const float* __restrict__ ref_xy, int n, int C, int S1, int m, int T,
    uint8_t* __restrict__ checked, uint8_t* __restrict__ flipped,
    int8_t* __restrict__ vmove) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  const size_t w = blockIdx.y;
  const size_t nC = static_cast<size_t>(n) * C;
  triangle_metrics(t, choice + w * n, cand_ref + w * nC, pair_idx + w * nC,
                   costs + w * nC, extra + w * nC, slots + w * nC,
                   valid + w * nC, nm + w * n, prices + w * S1,
                   tris + w * 3 * T, tri_mask + w * T, src + w * T,
                   ref_xy + w * 2 * m, n, C, m, checked + w * T,
                   flipped + w * T, vmove + w * T);
}

}  // namespace

extern "C" int same_tear_metrics(
    const int* choice, const int* cand_ref, const int* pair_idx,
    const float* costs, const float* extra, const int* slots,
    const uint8_t* valid, const float* nm, const float* prices,
    const int* tris, const uint8_t* tri_mask, const int* src,
    const float* ref_xy, int n, int C, int m, int T, uint8_t* checked,
    uint8_t* flipped, int8_t* vmove, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int grid = (T + kThreads - 1) / kThreads;
  tear_metrics_kernel<<<grid, kThreads, 0, st>>>(
      choice, cand_ref, pair_idx, costs, extra, slots, valid, nm, prices, tris,
      tri_mask, src, ref_xy, n, C, m, T, checked, flipped, vmove);
  return static_cast<int>(cudaGetLastError());
}

// K6: the same for each window of a [B, ...] stack, one launch, grid.y = B.
extern "C" int same_tear_metrics_batch(
    const int* choice, const int* cand_ref, const int* pair_idx,
    const float* costs, const float* extra, const int* slots,
    const uint8_t* valid, const float* nm, const float* prices,
    const int* tris, const uint8_t* tri_mask, const int* src,
    const float* ref_xy, int B, int n, int C, int S1, int m, int T,
    uint8_t* checked, uint8_t* flipped, int8_t* vmove, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((T + kThreads - 1) / kThreads, B);
  tear_metrics_batch_kernel<<<grid, kThreads, 0, st>>>(
      choice, cand_ref, pair_idx, costs, extra, slots, valid, nm, prices, tris,
      tri_mask, src, ref_xy, n, C, S1, m, T, checked, flipped, vmove);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
