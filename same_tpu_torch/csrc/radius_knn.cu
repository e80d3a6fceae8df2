// K3 `radius_knn`: for each query point the k nearest refs within a radius.
//
// Replaces same_tpu/ops/pairwise.py:19-67 (`radius_knn_tpu`, XLA): a tiled
// brute-force sweep of squared distances by the f32 expansion
// |q|^2 + |r|^2 - 2 q.r, clamped at 0, tested against radius^2, then a stable
// top-k per query (ascending distance, ties to the lower ref index).
//
// One thread per query. The refs stream through shared memory in tiles of
// kTile points (x, y and |r|^2, computed once per tile); every thread of the
// block walks the tile in ascending ref order and keeps its KMAX best in a
// sorted list by insertion on the key (d2, ref index). A candidate enters
// only if its d2 is strictly below the list's last entry, so among equal
// distances the earlier, lower ref index stays ahead: the order a stable
// top-k gives. The insertion is fully unrolled, so the list lives in
// registers for the small KMAX; k is rounded up to the next instantiated KMAX
// and the first k entries are written.
//
// k > 64 takes ceil(k / 64) launches of the KMAX = 64 kernel, one a pass of
// 64 columns. Pass p admits only the refs that come after the last entry of
// pass p - 1 in (d2, ref index) order: that entry's d2 is recomputed from its
// ref index by the same expression (the same bits), and a ref is admitted if
// its d2 is larger, or equal with a larger index. A query whose previous pass
// ended short has nothing left and writes padding. Each pass re-reads the
// refs, so the time grows with ceil(k / 64).
//
// What bounds it on the H100: operations. n * m distance evaluations of
// about 8 f32 operations each (10,681 x 11,418 at the LUAD window: ~1 GFLOP)
// against ~1 MB of coordinates in and lists out. Nothing but the lists ever
// reaches device memory; the [n, m] distance matrix of the XLA version is
// never formed.
//
// Exactness: the expansion is evaluated in the order of the plain PyTorch
// version (`radius_knn_plain`): (qx*qx + qy*qy) + (rx*rx + ry*ry)
// - 2 * (qx*rx + qy*ry), every step rounded to f32 (__fmul_rn / __fadd_rn /
// __fsub_rn; the file is also built with --fmad=false), so membership at the
// radius' edge and the order of near-ties follow the same rounded values.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 1024;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

template <int KMAX>
__global__ void radius_knn_kernel(const float* __restrict__ q_xy,
                                  const float* __restrict__ r_xy, int n, int m,
                                  float r2, int k, int col0,
                                  int* __restrict__ out_idx,
                                  float* __restrict__ out_dist,
                                  uint8_t* __restrict__ out_mask) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ float ss[kTile];

  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool live = q < n;
  const float qx = live ? q_xy[2 * q] : 0.0f;
  const float qy = live ? q_xy[2 * q + 1] : 0.0f;
  const float qsq = __fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy));

  float bd[KMAX];
  int bi[KMAX];
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    bd[j] = pos_inf();
    bi[j] = -1;
  }
  // Pass col0 / KMAX > 0: the last entry the previous pass wrote.
  int lo_i = -1;
  float lo_d = 0.0f;
  bool more = true;
  if (col0 > 0 && live) {
    lo_i = out_idx[static_cast<size_t>(q) * k + col0 - 1];
    more = lo_i >= 0;
    if (more) {
      float rx = r_xy[2 * lo_i];
      float ry = r_xy[2 * lo_i + 1];
      float rsq = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
      float inner = __fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry));
      lo_d = fmaxf(__fsub_rn(__fadd_rn(qsq, rsq), __fmul_rn(2.0f, inner)), 0.0f);
    }
  }

  for (int base = 0; base < m; base += kTile) {
    const int len = min(kTile, m - base);
    __syncthreads();
    for (int t = threadIdx.x; t < len; t += kThreads) {
      float rx = r_xy[2 * (base + t)];
      float ry = r_xy[2 * (base + t) + 1];
      sx[t] = rx;
      sy[t] = ry;
      ss[t] = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
    }
    __syncthreads();
    if (!live || !more) continue;
    for (int t = 0; t < len; ++t) {
      float inner = __fadd_rn(__fmul_rn(qx, sx[t]), __fmul_rn(qy, sy[t]));
      float d2 = __fsub_rn(__fadd_rn(qsq, ss[t]), __fmul_rn(2.0f, inner));
      d2 = fmaxf(d2, 0.0f);
      const int r = base + t;
      const bool after = lo_i < 0 || d2 > lo_d || (d2 == lo_d && r > lo_i);
      if (d2 <= r2 && d2 < bd[KMAX - 1] && after) {
        // Sorted insertion from the top down: entries above the insertion
        // point move up one, the candidate lands behind every entry whose
        // distance is not larger (strict <).
#pragma unroll
        for (int j = KMAX - 1; j > 0; --j) {
          if (d2 < bd[j - 1]) {
            bd[j] = bd[j - 1];
            bi[j] = bi[j - 1];
          } else if (d2 < bd[j]) {
            bd[j] = d2;
            bi[j] = r;
          }
        }
        if (d2 < bd[0]) {
          bd[0] = d2;
          bi[0] = r;
        }
      }
    }
  }

  if (!live) return;
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (col0 + j < k) {
      const bool ok = bi[j] >= 0;
      const size_t o = static_cast<size_t>(q) * k + col0 + j;
      out_idx[o] = ok ? bi[j] : -1;
      out_dist[o] = ok ? __fsqrt_rn(bd[j]) : pos_inf();
      out_mask[o] = ok;
    }
  }
}

template <int KMAX>
int launch(const float* q_xy, const float* r_xy, int n, int m, float r2, int k,
           int col0, int* idx, float* dist, uint8_t* mask, cudaStream_t st) {
  int grid = (n + kThreads - 1) / kThreads;
  radius_knn_kernel<KMAX><<<grid, kThreads, 0, st>>>(q_xy, r_xy, n, m, r2, k,
                                                     col0, idx, dist, mask);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// *launches gets the number of kernel launches: 1 for k <= 64, else one a
// pass of 64 columns.
extern "C" int same_radius_knn(const float* q_xy, const float* r_xy, int n,
                               int m, float r2, int k, int* idx, float* dist,
                               uint8_t* mask, void* stream, int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  int err = 0;
  if (k <= 4) {
    err = launch<4>(q_xy, r_xy, n, m, r2, k, 0, idx, dist, mask, st);
  } else if (k <= 8) {
    err = launch<8>(q_xy, r_xy, n, m, r2, k, 0, idx, dist, mask, st);
  } else if (k <= 16) {
    err = launch<16>(q_xy, r_xy, n, m, r2, k, 0, idx, dist, mask, st);
  } else if (k <= 32) {
    err = launch<32>(q_xy, r_xy, n, m, r2, k, 0, idx, dist, mask, st);
  } else {
    for (int col0 = 0; col0 < k && err == 0; col0 += 64) {
      err = launch<64>(q_xy, r_xy, n, m, r2, k, col0, idx, dist, mask, st);
      ++*launches;
    }
    return err;
  }
  if (err == 0) *launches = 1;
  return err;
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
