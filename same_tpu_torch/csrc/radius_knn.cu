// K3 `radius_knn`: for each query point the k nearest refs within a radius.
//
// Replaces same_tpu/ops/pairwise.py:19-67 (`radius_knn_tpu`, XLA): a tiled
// brute-force sweep of squared distances by the f32 expansion
// |q|^2 + |r|^2 - 2 q.r, clamped at 0, tested against radius^2, then a stable
// top-k per query (ascending distance, ties to the lower ref index).
//
// Design for the H100. The wrapper (kernels/radius_knn.py::knn_grid) reads
// the two sets' bounds (`bounds_kernel`, one read to the host), chooses a
// uniform grid of square cells there, and bins the refs by cell id with a
// counting sort (`cell_count_kernel`, `scan_kernel`, `scatter_kernel`: one
// C call, three launches and a memset), ordering the queries by cell the
// same way. One warp takes one query (in cell order, so a block's eight warps
// read neighbouring cells through L1): it visits the cells that overlap the
// square of half-side `reach` around the query, each row of cells one
// contiguous run of binned refs, its 32 lanes on 32 refs at a time. `reach`
// covers the radius plus a bound on the expansion's rounding, so every ref
// the expansion admits is visited. With no cells (radius inf, or one cell
// covering the refs) the run is all m refs in their own order, four steps of
// 32 at a time with each lane's four loads issued together.
//
// The warp keeps its best 64 as a sorted list in registers, lane l holding
// positions l and 32 + l. A lane whose ref is in range and whose key
// (d2, ref index) is below the list's k-th key raises its ballot bit; the
// warp then inserts the raised refs one at a time: the count of smaller
// entries (two ballots) is the position, and the entries above it move up by
// one with a shuffle. The comparison is lexicographic on (d2, ref index), so
// the list is the stable order's whatever the visiting order: the binned
// order does not rise by index.
//
// k > 64 takes ceil(k / 64) launches, one a pass of 64 columns. Pass p admits
// only the refs that come after the last entry of pass p - 1 in (d2, ref
// index) order: that entry's d2 is recomputed from its ref index by the same
// expression (the same bits). A query whose previous pass ended short has
// nothing left and writes padding.
//
// What bounds it on the H100: with cells, the bytes (the inputs read once,
// the lists written once) and the pairs in the visited cells, about nine
// cells of side `reach` a query; without, operations: n * m distance
// evaluations of about 8 f32 operations each.
//
// Exactness: the expansion is evaluated in the order of the plain PyTorch
// version (`radius_knn_plain`): (qx*qx + qy*qy) + (rx*rx + ry*ry)
// - 2 * (qx*rx + qy*ry), every step rounded to f32 (__fmul_rn / __fadd_rn /
// __fsub_rn; the file is also built with --fmad=false), so membership at the
// radius' edge and the order of near-ties follow the same rounded values.
// A query's cells come from the same f32 steps as `visited_cells` there.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// (d2, index) keys, lexicographic.
__device__ __forceinline__ bool key_less(float ad, int ai, float bd, int bi) {
  return ad < bd || (ad == bd && ai < bi);
}

__device__ __forceinline__ float expansion(float qx, float qy, float qsq, float rx,
                                           float ry) {
  const float rsq = __fadd_rn(__fmul_rn(rx, rx), __fmul_rn(ry, ry));
  const float inner = __fadd_rn(__fmul_rn(qx, rx), __fmul_rn(qy, ry));
  return fmaxf(__fsub_rn(__fadd_rn(qsq, rsq), __fmul_rn(2.0f, inner)), 0.0f);
}

struct Grid {
  float x0, y0, inv, reach;
  int gx, gy;
};

// floor(((v -+ reach) - origin) * inv), as visited_cells computes it.
__device__ __forceinline__ float cell_lo(float v, const Grid& g, float origin) {
  return floorf(__fmul_rn(__fsub_rn(__fsub_rn(v, g.reach), origin), g.inv));
}
__device__ __forceinline__ float cell_hi(float v, const Grid& g, float origin) {
  return floorf(__fmul_rn(__fsub_rn(__fadd_rn(v, g.reach), origin), g.inv));
}

// A sorted list of the 32 * SLOTS best keys, lane l holding positions
// 32 * s + l; empty entries are (inf, INT_MAX).
template <int SLOTS>
struct List {
  float d[SLOTS];
  int i[SLOTS];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      d[s] = pos_inf();
      i[s] = INT_MAX;
    }
  }

  // The key at position p (the same in every lane).
  __device__ __forceinline__ void at(int p, float& kd, int& ki) const {
    const int s = p >> 5, l = p & 31;
    float vd = d[0];
    int vi = i[0];
#pragma unroll
    for (int t = 1; t < SLOTS; ++t) {
      if (s == t) {
        vd = d[t];
        vi = i[t];
      }
    }
    kd = __shfl_sync(kFull, vd, l);
    ki = __shfl_sync(kFull, vi, l);
  }

  // Insert (cd, ci), the same in every lane; the last entry falls off.
  __device__ __forceinline__ void insert(float cd, int ci, int lane) {
    int p = 0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      p += __popc(__ballot_sync(kFull, key_less(d[s], i[s], cd, ci)));
    }
    float up_d[SLOTS], carry_d[SLOTS];
    int up_i[SLOTS], carry_i[SLOTS];
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      up_d[s] = __shfl_up_sync(kFull, d[s], 1);
      up_i[s] = __shfl_up_sync(kFull, i[s], 1);
      carry_d[s] = __shfl_sync(kFull, d[s], 31);
      carry_i[s] = __shfl_sync(kFull, i[s], 31);
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int pos = 32 * s + lane;
      const int prev = s > 0 ? s - 1 : 0;
      if (pos > p) {
        // Position pos takes position pos - 1's entry: lane 0 of slot s the
        // last lane's of slot s - 1 (lane 0 of slot 0 is never above p).
        d[s] = lane != 0 ? up_d[s] : carry_d[prev];
        i[s] = lane != 0 ? up_i[s] : carry_i[prev];
      } else if (pos == p) {
        d[s] = cd;
        i[s] = ci;
      }
    }
  }
};

// A warp a query. CELLS: the refs come binned (b_idx their original indices)
// and the query visits its cells' runs, one 32-ref step at a time (a run
// holds a dozen refs at LUAD density); else one run of all m refs, four
// steps at a time, each lane's four loads issued together.
template <int SLOTS, bool CELLS>
__global__ void __launch_bounds__(kThreads) radius_knn_kernel(
    const float* __restrict__ q_xy, int n, const float* __restrict__ r_xy,
    int m, const float2* __restrict__ b_xy, const int* __restrict__ b_idx,
    const int* __restrict__ cell_start, const int* __restrict__ q_order,
    Grid grid, float r2, int k, int col0, int* __restrict__ out_idx,
    float* __restrict__ out_dist, uint8_t* __restrict__ out_mask) {
  constexpr int U = CELLS ? 1 : 4;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= n) return;  // the whole warp
  const int q = CELLS ? q_order[w] : w;
  const float qx = q_xy[2 * q];
  const float qy = q_xy[2 * q + 1];
  const float qsq = __fadd_rn(__fmul_rn(qx, qx), __fmul_rn(qy, qy));
  const int klim = min(32 * SLOTS, k - col0);

  // Pass col0 / 64 > 0: the last entry the previous pass wrote.
  int lo_i = -1;
  float lo_d = 0.0f;
  bool more = true;
  if (col0 > 0) {
    lo_i = out_idx[static_cast<size_t>(q) * k + col0 - 1];
    more = lo_i >= 0;
    if (more) lo_d = expansion(qx, qy, qsq, r_xy[2 * lo_i], r_xy[2 * lo_i + 1]);
  }

  // The rows of cells to visit, each one run [cell_start[row * gx + xlo],
  // cell_start[row * gx + xhi + 1]); with no cells one run of all m refs.
  int xlo = 0, xhi = 0, ylo = 0, yhi = more ? 0 : -1;
  if (CELLS && more) {
    const float fxl = cell_lo(qx, grid, grid.x0), fxh = cell_hi(qx, grid, grid.x0);
    const float fyl = cell_lo(qy, grid, grid.y0), fyh = cell_hi(qy, grid, grid.y0);
    const float gx1 = static_cast<float>(grid.gx - 1), gy1 = static_cast<float>(grid.gy - 1);
    if (fxh >= 0.0f && fxl <= gx1 && fyh >= 0.0f && fyl <= gy1) {
      xlo = static_cast<int>(fmaxf(fxl, 0.0f));
      xhi = static_cast<int>(fminf(fxh, gx1));
      ylo = static_cast<int>(fmaxf(fyl, 0.0f));
      yhi = static_cast<int>(fminf(fyh, gy1));
    } else {
      yhi = -1;
    }
  }

  List<SLOTS> list;
  list.init();
  float th_d = pos_inf();
  int th_i = INT_MAX;
  for (int row = ylo; row <= yhi; ++row) {
    int beg = 0, end = m;
    if (CELLS) {
      beg = cell_start[row * grid.gx + xlo];
      end = cell_start[row * grid.gx + xhi + 1];
    }
    for (int base = beg; base < end; base += 32 * U) {
      float2 p[U];
      int rid[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int tc = min(base + 32 * u + lane, end - 1);
        p[u] = b_xy[tc];
        rid[u] = CELLS ? b_idx[tc] : tc;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float d2 = expansion(qx, qy, qsq, p[u].x, p[u].y);
        const int r = rid[u];
        const bool after = lo_i < 0 || d2 > lo_d || (d2 == lo_d && r > lo_i);
        const bool ok = base + 32 * u + lane < end && d2 <= r2 && d2 < pos_inf() && after &&
                        key_less(d2, r, th_d, th_i);
        unsigned raised = __ballot_sync(kFull, ok);
        while (raised != 0u) {
          const int src = __ffs(raised) - 1;
          raised &= raised - 1u;
          const float cd = __shfl_sync(kFull, d2, src);
          const int ci = __shfl_sync(kFull, r, src);
          if (key_less(cd, ci, th_d, th_i)) {
            list.insert(cd, ci, lane);
            list.at(klim - 1, th_d, th_i);
          }
        }
      }
    }
  }

#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int pos = 32 * s + lane;
    if (pos < klim) {
      const bool ok = list.i[s] != INT_MAX;
      const size_t o = static_cast<size_t>(q) * k + col0 + pos;
      out_idx[o] = ok ? list.i[s] : -1;
      out_dist[o] = ok ? __fsqrt_rn(list.d[s]) : pos_inf();
      out_mask[o] = ok;
    }
  }
}

// ---------------------------------------------------------------------------
// The binning (knn_grid on the card)
// ---------------------------------------------------------------------------

// A float's key in an unsigned order that follows the float order.
__device__ __forceinline__ unsigned int order_key(float f) {
  const unsigned int b = __float_as_uint(f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// keys[0..3]: the least keys of qx, qy, rx, ry; keys[4..7] the largest;
// keys[8] the count of points with a coordinate that is not finite.
__global__ void bounds_kernel(const float* __restrict__ q, int n, const float* __restrict__ r,
                              int m, unsigned int* __restrict__ keys) {
  unsigned int lo[4] = {0xffffffffu, 0xffffffffu, 0xffffffffu, 0xffffffffu};
  unsigned int hi[4] = {0u, 0u, 0u, 0u};
  unsigned int bad = 0;
  const int total = n + m;
  for (int t = blockIdx.x * blockDim.x + threadIdx.x; t < total; t += gridDim.x * blockDim.x) {
    const bool isq = t < n;
    const float* pt = isq ? q + 2 * t : r + 2 * (t - n);
    const float x = pt[0], y = pt[1];
    if (!isfinite(x) || !isfinite(y)) {
      ++bad;
      continue;
    }
    const unsigned int kx = order_key(x), ky = order_key(y);
    const int o = isq ? 0 : 2;
    lo[o] = min(lo[o], kx);
    hi[o] = max(hi[o], kx);
    lo[o + 1] = min(lo[o + 1], ky);
    hi[o + 1] = max(hi[o + 1], ky);
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    lo[c] = __reduce_min_sync(kFull, lo[c]);
    hi[c] = __reduce_max_sync(kFull, hi[c]);
  }
  bad = __reduce_add_sync(kFull, bad);
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      atomicMin(keys + c, lo[c]);
      atomicMax(keys + 4 + c, hi[c]);
    }
    if (bad) atomicAdd(keys + 8, bad);
  }
}

// A point's cell, as point_cells computes it: floor((v - origin) * inv),
// clamped into the grid.
__device__ __forceinline__ int point_cell(float x, float y, const Grid& g) {
  const float cx = fminf(fmaxf(floorf(__fmul_rn(__fsub_rn(x, g.x0), g.inv)), 0.0f),
                         static_cast<float>(g.gx - 1));
  const float cy = fminf(fmaxf(floorf(__fmul_rn(__fsub_rn(y, g.y0), g.inv)), 0.0f),
                         static_cast<float>(g.gy - 1));
  return static_cast<int>(cy) * g.gx + static_cast<int>(cx);
}

// Points t < m are refs, the rest queries: each one's cell, and its rank in
// its cell from the cell's counter (refs and queries count apart).
__global__ void cell_count_kernel(const float* __restrict__ r, int m,
                                  const float* __restrict__ q, int n, Grid g,
                                  int* __restrict__ cell, int* __restrict__ rank,
                                  int* __restrict__ counts_r, int* __restrict__ counts_q) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m + n) return;
  const float* pt = t < m ? r + 2 * t : q + 2 * (t - m);
  const int c = point_cell(pt[0], pt[1], g);
  cell[t] = c;
  rank[t] = atomicAdd((t < m ? counts_r : counts_q) + c, 1);
}

// Block 0: the exclusive scan of counts_r into starts_r [cells + 1]; block
// 1: of counts_q into starts_q. Each thread sums a contiguous run.
__global__ void __launch_bounds__(1024) scan_kernel(const int* __restrict__ counts_r,
                                                    const int* __restrict__ counts_q, int cells,
                                                    int* __restrict__ starts_r,
                                                    int* __restrict__ starts_q) {
  __shared__ int warp_sums[32];
  const int* counts = blockIdx.x == 0 ? counts_r : counts_q;
  int* starts = blockIdx.x == 0 ? starts_r : starts_q;
  const int tid = threadIdx.x;
  const int per = (cells + 1023) / 1024;
  const int c0 = min(tid * per, cells), c1 = min(c0 + per, cells);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += counts[c];
  const int lane = tid & 31, warp = tid >> 5;
  int incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = warp_sums[lane];
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(kFull, w, off);
      if (lane >= off) w += v;
    }
    warp_sums[lane] = w;
  }
  __syncthreads();
  int run = incl - sum + (warp > 0 ? warp_sums[warp - 1] : 0);
  for (int c = c0; c < c1; ++c) {
    starts[c] = run;
    run += counts[c];
  }
  if (tid == 1023) starts[cells] = run;
}

// Refs to their slots (coordinates and original index), queries to theirs.
__global__ void scatter_kernel(const float2* __restrict__ r, int m, int n,
                               const int* __restrict__ cell, const int* __restrict__ rank,
                               const int* __restrict__ starts_r, const int* __restrict__ starts_q,
                               float2* __restrict__ b_xy, int* __restrict__ b_idx,
                               int* __restrict__ q_order) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m + n) return;
  if (t < m) {
    const int at = starts_r[cell[t]] + rank[t];
    b_xy[at] = r[t];
    b_idx[at] = t;
  } else {
    q_order[starts_q[cell[t]] + rank[t]] = t - m;
  }
}

}  // namespace

// Bounds of the queries q_xy [n, 2] and refs r_xy [m, 2], read to the host:
// out[0..3] the least keys (order_key) of qx, qy, rx, ry, out[4..7] the
// largest, out[8] the points with a coordinate that is not finite. keys is
// 9 words of device scratch. Waits for the stream.
extern "C" int same_knn_bounds(const float* q_xy, int n, const float* r_xy, int m,
                               unsigned int* keys, unsigned int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(keys, 0xff, 4 * sizeof(unsigned int), st);
  if (e == cudaSuccess) e = cudaMemsetAsync(keys + 4, 0, 5 * sizeof(unsigned int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int total = n + m;
  int blocks = (total + 255) / 256;
  blocks = blocks < 264 ? (blocks > 0 ? blocks : 1) : 264;
  bounds_kernel<<<blocks, 256, 0, st>>>(q_xy, n, r_xy, m, keys);
  e = cudaGetLastError();
  if (e == cudaSuccess) {
    e = cudaMemcpyAsync(out, keys, 9 * sizeof(unsigned int), cudaMemcpyDeviceToHost, st);
  }
  if (e == cudaSuccess) e = cudaStreamSynchronize(st);
  return static_cast<int>(e);
}

// Bins the refs r_xy [m, 2] and orders the queries q_xy [n, 2] by cell on
// the grid (x0, y0, inv, gx, gy): b_xy [m, 2] and b_idx [m] the refs in
// ascending cell id with their original indices (in a cell, in the order of
// the counters' atomics: the lists do not depend on it), cell_start
// [gx * gy + 1], q_order [n]. scratch: 3 * gx * gy + 1 + 2 * (m + n) ints.
extern "C" int same_knn_bin(const float* q_xy, int n, const float* r_xy, int m, float x0,
                            float y0, float inv, int gx, int gy, int* scratch, float* b_xy,
                            int* b_idx, int* cell_start, int* q_order, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cells = gx * gy;
  int* counts_r = scratch;
  int* counts_q = counts_r + cells;
  int* starts_q = counts_q + cells;
  int* cell = starts_q + cells + 1;
  int* rank = cell + m + n;
  const Grid grid{x0, y0, inv, 0.0f, gx, gy};
  cudaError_t e = cudaMemsetAsync(counts_r, 0, 2 * sizeof(int) * cells, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int blocks = (m + n + 255) / 256;
  cell_count_kernel<<<blocks, 256, 0, st>>>(r_xy, m, q_xy, n, grid, cell, rank, counts_r,
                                            counts_q);
  scan_kernel<<<2, 1024, 0, st>>>(counts_r, counts_q, cells, cell_start, starts_q);
  scatter_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const float2*>(r_xy), m, n, cell,
                                         rank, cell_start, starts_q,
                                         reinterpret_cast<float2*>(b_xy), b_idx, q_order);
  return static_cast<int>(cudaGetLastError());
}

// Queries q_xy [n, 2] and refs r_xy [m, 2]; b_xy [m, 2] the refs in cell
// order with their original indices b_idx, cell_start [gx * gy + 1] and the
// queries in cell order q_order (same_knn_bin), or b_xy = r_xy and the three
// pointers null for one cell. Writes idx, dist, mask [n, k]. *launches gets
// the number of kernel launches: one a pass of 64 columns.
extern "C" int same_radius_knn(const float* q_xy, int n, const float* r_xy,
                               int m, const float* b_xy, const int* b_idx,
                               const int* cell_start, const int* q_order,
                               float x0, float y0, float inv, float reach,
                               int gx, int gy, float r2, int k, int* idx,
                               float* dist, uint8_t* mask, void* stream,
                               int* launches) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  *launches = 0;
  if (k < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Grid grid{x0, y0, inv, reach, gx, gy};
  const float2* b2 = reinterpret_cast<const float2*>(b_xy);
  const bool cells = cell_start != nullptr;
  const int blocks = (n + kWarps - 1) / kWarps;
  for (int col0 = 0; col0 < k; col0 += 64) {
    const bool one = k - col0 <= 32;
#define SAME_KNN_LAUNCH(SLOTS, CELLS)                                                    \
  radius_knn_kernel<SLOTS, CELLS><<<blocks, kThreads, 0, st>>>(                          \
      q_xy, n, r_xy, m, b2, b_idx, cell_start, q_order, grid, r2, k, col0, idx, dist, mask)
    if (one && cells) {
      SAME_KNN_LAUNCH(1, true);
    } else if (one) {
      SAME_KNN_LAUNCH(1, false);
    } else if (cells) {
      SAME_KNN_LAUNCH(2, true);
    } else {
      SAME_KNN_LAUNCH(2, false);
    }
#undef SAME_KNN_LAUNCH
    ++*launches;
    const int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  return 0;
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
