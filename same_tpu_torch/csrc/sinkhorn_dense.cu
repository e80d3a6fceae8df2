// K10 `sinkhorn_dense`: log-domain Sinkhorn on a dense [n, m] cost matrix.
//
// Replaces same_tpu/ops/sinkhorn.py:27-53 (`sinkhorn_dense`, XLA). Each
// iteration:
//   f_i = eps * log(a_i) - eps * logsumexp_j((g_j - cost_ij) / eps)
//   g_j = eps * log(b_j) - eps * logsumexp_i((f_i - cost_ij) / eps)
// and after the last one plan_ij = exp((f_i + g_j - cost_ij) / eps).
//
// Design for the H100: ONE cooperative launch a call, one block of 1,024
// threads on each SM, the half-iterations separated by a software grid
// barrier (an atomic counter and a generation word). Block b < P (P = min(SMs,
// n)) owns a contiguous run of rows and keeps as many of them as fit in its
// shared memory (up to 227 KB: 13-14 rows of 4,096) as kappa = cost * log2(e)
// / eps, read from device memory once a call; the rest of its rows stream
// from L2 each half-iteration (ld.global.cg, so they do not evict L1). Both
// updates read the same row-major rows, so there is no transpose:
//
//   A1  a warp a row (a row split between 2-32 warps where the block has
//       fewer rows than warps): its f_i from a single read of the row, each
//       lane an online logsumexp over its columns in chunks of 8 (the
//       chunk's max first, so a rescale costs one exponential a chunk, not
//       one an entry), the lanes merged by a fixed xor tree;
//   A2  a thread a column (four where m % 4 == 0): the block's partial (max,
//       sum) of the column over its rows, the same chunked online
//       logsumexp, written to part[b][j];
//   --  grid barrier
//   B   the block's slice of columns 32 at a time, a lane a column (the
//       partials read coalesced), the P partials split between the 32 warps
//       and merged warp by warp in order into g_j;
//   --  grid barrier
//
// so 2 * n_iters + 1 barriers and no other launch. Every merge runs in a
// fixed order, so two calls give the same bits.
//
// Every load of a chunk is issued unconditionally at a clamped index and
// masked after, so the chunk's loads are in flight together: a load behind a
// branch waits for the one before it. Where m % 4 == 0 and the cost is
// 16-byte aligned, a load takes four entries (row_pair4, column_pair4).
//
// Precision: the duals are float64 between half-iterations and each
// logsumexp ends in float64 (max + log2(sum), times ln 2). Each entry's
// exponent z = (g_j - cost_ij) / eps is taken in float32 in log2 units, as
// gp_j - kappa_ij: gp_j is g_j * log2(e) / eps rounded once from float64, and
// kappa_ij = cost_ij * hi + cost_ij * lo with hi + lo the float64 factor
// log2(e) / eps split into two floats, so that no rounding of the factor
// scales every cost alike. The exponentials are the SFU's ex2.approx (about
// 2^-22 relative); the sums run in float32 by pairwise trees over chunks,
// and merge in float32 with each partial's own max. What dominates the
// error is the float32 rounding of gp_j and of z, up to half an ulp of |z|
// (~150 at eps 0.05 and costs in [0, 5]): it changes every iteration, and
// the duals' gauge direction (f + k, g - k) gathers it as a random walk
// without decay. chip_smoke.py measures it on the H100 at 4096^2, 200
// iterations: 6.9e-7 on f and g against float64, where the float32 plain
// version is off by 1.07e-6 and a design with float64 exponents by 4e-8.
// The duals themselves are never rounded to float32 between iterations.
//
// What bounds it on the H100: operations. Per entry and half-iteration one
// exponential (MUFU, 16 a clock an SM) and about five float32 instructions;
// 2 * 200 * 16.8 M entries at 4096^2 is 1.6 ms of exponentials alone at
// 1.98 GHz, beside 401 grid barriers of ~2.2 us and the streamed rows. The
// function's count (about 12 float32 operations an entry and iteration, 40
// GFLOP at 4096^2 and 200 iterations) at 67 TFLOP/s is 0.6 ms; its bytes
// read and written once, 134 MB, 0.04 ms.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 8;
constexpr unsigned kFull = 0xffffffffu;
constexpr double kLn2 = 0.6931471805599453;
constexpr double kLog2e = 1.4426950408889634;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

struct Args {
  const float* cost;
  const float* a;
  const float* b;
  int n, m, iters;
  int P;    // blocks that own rows
  int res;  // rows a block keeps in shared memory
  double eps;
  double inv2;  // log2(e) / eps
  float hi, lo;  // inv2 = hi + lo
  double* f64;
  double* g64;
  double* la;  // eps * log(a_i), [n]
  double* lb;  // eps * log(b_j), [m]
  float* fp;  // f_i * inv2, float32, [n]
  float* gp;  // g_j * inv2, float32, [m]
  float2* part;  // [P, m] column partials (max, sum), log2 units
  unsigned int* bar;
  float* plan;
  float* f32;
  float* g32;
};

__device__ __forceinline__ void grid_barrier(unsigned int* bar, unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
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

__device__ __forceinline__ float kappa(float c, const Args& A) {
  return __fadd_rn(__fmul_rn(c, A.hi), __fmul_rn(c, A.lo));
}

// 2^x by the SFU's ex2.approx.ftz: relative error about 2^-22, and results
// below 2^-126 flushed to 0 (a term that small against its sum's largest is
// below a float32 rounding of the sum).
__device__ __forceinline__ float exp2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (m, s) <- the logsumexp pair of (m, s) and (m2, s2): sum of 2^(z - m) over
// both; symmetric in its two pairs, so both lanes of a xor step agree.
__device__ __forceinline__ void lse_merge(float& m, float& s, float m2, float s2) {
  if (m2 == neg_inf()) return;
  if (m == neg_inf()) {
    m = m2;
    s = s2;
    return;
  }
  const float mx = fmaxf(m, m2);
  s = __fadd_rn(__fmul_rn(s, exp2_sfu(__fsub_rn(m, mx))),
                __fmul_rn(s2, exp2_sfu(__fsub_rn(m2, mx))));
  m = mx;
}

// Adds a chunk of N exponents z (N a power of two) to the running pair (m,
// s): the chunk's max and its sum of exponentials by pairwise trees.
template <int N>
__device__ __forceinline__ void lse_chunk(float& m, float& s, float (&z)[N]) {
  float t[N];
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = z[i];
#pragma unroll
  for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
    for (int i = 0; i < w; ++i) t[i] = fmaxf(t[i], t[i + w]);
  }
  if (t[0] > m) {
    s = __fmul_rn(s, exp2_sfu(__fsub_rn(m, t[0])));
    m = t[0];
  }
  if (m != neg_inf()) {
#pragma unroll
    for (int i = 0; i < N; ++i) t[i] = exp2_sfu(__fsub_rn(z[i], m));
#pragma unroll
    for (int w = N / 2; w > 0; w /= 2) {
#pragma unroll
      for (int i = 0; i < w; ++i) t[i] = __fadd_rn(t[i], t[i + w]);
    }
    s = __fadd_rn(s, t[0]);
  }
}

__device__ __forceinline__ void warp_merge(float& m, float& s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float m2 = __shfl_xor_sync(kFull, m, off);
    const float s2 = __shfl_xor_sync(kFull, s, off);
    lse_merge(m, s, m2, s2);
  }
}

// The float64 dual eps * log(marginal) - eps * logsumexp from a logsumexp
// pair in log2 units.
__device__ __forceinline__ double dual(double eps, double eps_log_marg, float m, float s) {
  const double lse = (static_cast<double>(m) + log2(static_cast<double>(s))) * kLn2;
  return eps_log_marg - eps * lse;
}

// A1 for one row: this lane's pair over the columns j = j0 + lane + step * t
// (j0 from `first`), gp_j - kappa_ij, kappa from shared memory (SHARED) or
// from the cost in L2. Every load is issued unconditionally at a clamped
// column, then masked, so a chunk's loads are in flight together.
template <bool SHARED>
__device__ __forceinline__ void row_pair(const Args& A, const float* krow, const float* crow,
                                         int first, int step, float& mx, float& s) {
  const int m = A.m;
  for (int j0 = first; j0 < m; j0 += step * kChunk) {
    float z[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int j = j0 + step * t;
      const int jc = min(j, m - 1);
      const float kv = SHARED ? krow[jc] : kappa(__ldcg(crow + jc), A);
      z[t] = __fsub_rn(A.gp[jc], kv);
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (j0 + step * t >= m) z[t] = neg_inf();
    }
    lse_chunk(mx, s, z);
  }
}

// A2 for one column j over the block's rows [l0, l1) (local indices), kappa
// from shared memory (SHARED) or from the cost in L2; loads unconditional.
template <bool SHARED>
__device__ __forceinline__ void column_pair(const Args& A, const float* kap, int r0, int l0,
                                            int l1, int j, float& mx, float& s) {
  const int m = A.m;
  for (int b = l0; b < l1; b += kChunk) {
    float z[kChunk];
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      const int li = min(b + t, l1 - 1);
      const float kv = SHARED ? kap[static_cast<size_t>(li) * m + j]
                              : kappa(__ldcg(A.cost + static_cast<size_t>(r0 + li) * m + j), A);
      z[t] = __fsub_rn(A.fp[r0 + li], kv);
    }
#pragma unroll
    for (int t = 0; t < kChunk; ++t) {
      if (b + t >= l1) z[t] = neg_inf();
    }
    lse_chunk(mx, s, z);
  }
}

__device__ __forceinline__ float4 kappa4(float4 c, const Args& A) {
  return make_float4(kappa(c.x, A), kappa(c.y, A), kappa(c.z, A), kappa(c.w, A));
}

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

// row_pair with m % 4 == 0: the lane's columns in runs of 4 (j = first +
// step * t, j a multiple of 4), one 16-byte load of kappa (or the cost) and
// one of gp a run, two runs a chunk; only the row's last chunk clamps.
template <bool SHARED>
__device__ __forceinline__ void row_pair4(const Args& A, const float* krow, const float* crow,
                                          int first, int step, float& mx, float& s) {
  const int m = A.m;
  for (int j0 = first; j0 < m; j0 += 2 * step) {
    float4 kv[2], gv[2];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int j = min(j0 + step * t, m - 4);
      kv[t] = SHARED ? *reinterpret_cast<const float4*>(krow + j)
                     : kappa4(__ldcg(reinterpret_cast<const float4*>(crow + j)), A);
      gv[t] = *reinterpret_cast<const float4*>(A.gp + j);
    }
    float z[8];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const bool live = j0 + step * t < m;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        z[4 * t + c] = live ? __fsub_rn(comp(gv[t], c), comp(kv[t], c)) : neg_inf();
      }
    }
    lse_chunk(mx, s, z);
  }
}

// column_pair with m % 4 == 0 for the four columns j..j+3 (j a multiple of
// 4): one 16-byte load a row, chunks of 4 rows, a pair a column.
template <bool SHARED>
__device__ __forceinline__ void column_pair4(const Args& A, const float* kap, int r0, int l0,
                                             int l1, int j, float (&mx)[4], float (&s)[4]) {
  const int m = A.m;
  for (int b = l0; b < l1; b += 4) {
    float4 v[4];
    float f[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int li = min(b + t, l1 - 1);
      v[t] = SHARED ? *reinterpret_cast<const float4*>(kap + static_cast<size_t>(li) * m + j)
                    : kappa4(__ldcg(reinterpret_cast<const float4*>(
                                 A.cost + static_cast<size_t>(r0 + li) * m + j)), A);
      f[t] = A.fp[r0 + li];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float z[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        z[t] = b + t < l1 ? __fsub_rn(f[t], comp(v[t], c)) : neg_inf();
      }
      lse_chunk(mx[c], s[c], z);
    }
  }
}

// A1's pair for the block's row li: (first, step) as row_pair's.
template <bool VEC>
__device__ __forceinline__ void row_pass(const Args& A, const float* kap, int r0, int nres,
                                         int li, int first, int step, float& mx, float& s) {
  const float* crow = A.cost + static_cast<size_t>(r0 + li) * A.m;
  const float* krow = kap + static_cast<size_t>(li) * A.m;
  if (VEC) {
    if (li < nres) {
      row_pair4<true>(A, krow, crow, 4 * first, 4 * step, mx, s);
    } else {
      row_pair4<false>(A, krow, crow, 4 * first, 4 * step, mx, s);
    }
  } else if (li < nres) {
    row_pair<true>(A, krow, crow, first, step, mx, s);
  } else {
    row_pair<false>(A, krow, crow, first, step, mx, s);
  }
}

// VEC: m % 4 == 0 and the cost 16-byte aligned (16-byte loads).
template <bool VEC>
__global__ void __launch_bounds__(kThreads, 1) sinkhorn_dense_kernel(Args A) {
  extern __shared__ float4 kap4[];  // [res, m] floats
  float* kap = reinterpret_cast<float*>(kap4);
  __shared__ float2 pairs[kWarps][32];
  const int blk = blockIdx.x, G = gridDim.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = A.n, m = A.m;
  int r0 = 0, r1 = 0;
  if (blk < A.P) {
    r0 = static_cast<int>(static_cast<long long>(blk) * n / A.P);
    r1 = static_cast<int>(static_cast<long long>(blk + 1) * n / A.P);
  }
  const int rows = r1 - r0;
  const int nres = min(A.res, rows);
  const int c0 = static_cast<int>(static_cast<long long>(blk) * m / G);
  const int c1 = static_cast<int>(static_cast<long long>(blk + 1) * m / G);
  // A1's warps a row: with fewer rows than warps, a row is split between
  // wpr warps (a power of two), warp w taking row w / wpr and the columns of
  // slice w % wpr.
  int wpr = 1;
  while (rows > 0 && wpr * 2 * rows <= kWarps) wpr *= 2;

  const size_t resident = static_cast<size_t>(nres) * m;
  for (size_t e = threadIdx.x; e < resident; e += kThreads) {
    kap[e] = kappa(A.cost[static_cast<size_t>(r0) * m + e], A);
  }
  for (int j = c0 + threadIdx.x; j < c1; j += kThreads) {
    A.g64[j] = 0.0;
    A.gp[j] = 0.0f;
    A.lb[j] = A.eps * log(static_cast<double>(A.b[j]));
  }
  for (int i = r0 + threadIdx.x; i < r1; i += kThreads) {
    A.f64[i] = 0.0;
    A.la[i] = A.eps * log(static_cast<double>(A.a[i]));
  }
  grid_barrier(A.bar, G);

  for (int it = 0; it < A.iters; ++it) {
    // A1: f_i of the block's rows.
    if (wpr == 1) {
      for (int li = warp; li < rows; li += kWarps) {
        float mx = neg_inf(), s = 0.0f;
        row_pass<VEC>(A, kap, r0, nres, li, lane, 32, mx, s);
        warp_merge(mx, s);
        if (lane == 0) {
          const double f = dual(A.eps, A.la[r0 + li], mx, s);
          A.f64[r0 + li] = f;
          A.fp[r0 + li] = static_cast<float>(f * A.inv2);
        }
      }
    } else {
      const int li = warp / wpr, slice = warp % wpr;
      float mx = neg_inf(), s = 0.0f;
      if (li < rows) row_pass<VEC>(A, kap, r0, nres, li, 32 * slice + lane, 32 * wpr, mx, s);
      warp_merge(mx, s);
      if (lane == 0) pairs[warp][0] = make_float2(mx, s);
      __syncthreads();
      if (li < rows && slice == 0 && lane == 0) {
        // The row's slices in order.
        for (int w = warp + 1; w < warp + wpr; ++w) lse_merge(mx, s, pairs[w][0].x, pairs[w][0].y);
        const double f = dual(A.eps, A.la[r0 + li], mx, s);
        A.f64[r0 + li] = f;
        A.fp[r0 + li] = static_cast<float>(f * A.inv2);
      }
    }
    __syncthreads();
    // A2: the block's column partials over its rows, a thread a column.
    if (rows > 0) {
      if (VEC) {
        for (int j = 4 * threadIdx.x; j < m; j += 4 * kThreads) {
          float mx[4] = {neg_inf(), neg_inf(), neg_inf(), neg_inf()};
          float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          column_pair4<true>(A, kap, r0, 0, nres, j, mx, s);
          column_pair4<false>(A, kap, r0, nres, rows, j, mx, s);
          float4* out = reinterpret_cast<float4*>(A.part + static_cast<size_t>(blk) * m + j);
          out[0] = make_float4(mx[0], s[0], mx[1], s[1]);
          out[1] = make_float4(mx[2], s[2], mx[3], s[3]);
        }
      } else {
        for (int j = threadIdx.x; j < m; j += kThreads) {
          float mx = neg_inf(), s = 0.0f;
          column_pair<true>(A, kap, r0, 0, nres, j, mx, s);
          column_pair<false>(A, kap, r0, nres, rows, j, mx, s);
          A.part[static_cast<size_t>(blk) * m + j] = make_float2(mx, s);
        }
      }
    }
    grid_barrier(A.bar, G);
    // B: g_j for the block's columns, 32 at a time (a lane a column, read
    // coalesced), the P partials split between the warps (warp w taking
    // w, w + 32, ...), then merged warp by warp in order.
    for (int g0 = c0; g0 < c1; g0 += 32) {
      const int j = g0 + lane, jc = min(j, c1 - 1);
      float mx = neg_inf(), s = 0.0f;
      for (int p0 = warp; p0 < A.P; p0 += 8 * kWarps) {
        float2 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int p = min(p0 + u * kWarps, A.P - 1);
          v[u] = __ldcg(A.part + static_cast<size_t>(p) * m + jc);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (p0 + u * kWarps < A.P) lse_merge(mx, s, v[u].x, v[u].y);
        }
      }
      // The warps' pairs by a fixed tree: warp w takes warp w + h's.
      pairs[warp][lane] = make_float2(mx, s);
      __syncthreads();
      for (int h = kWarps / 2; h > 0; h /= 2) {
        if (warp < h) {
          lse_merge(mx, s, pairs[warp + h][lane].x, pairs[warp + h][lane].y);
          pairs[warp][lane] = make_float2(mx, s);
        }
        __syncthreads();
      }
      if (warp == 0) {
        if (j < c1) {
          const double g = dual(A.eps, A.lb[j], mx, s);
          A.g64[j] = g;
          A.gp[j] = static_cast<float>(g * A.inv2);
        }
      }
      __syncthreads();
    }
    grid_barrier(A.bar, G);
  }

  // The plan and the float32 duals: a block a row at a time.
  for (int i = blk; i < n; i += G) {
    const double fi = A.f64[i];
    const size_t row = static_cast<size_t>(i) * m;
    for (int j = threadIdx.x; j < m; j += kThreads) {
      A.plan[row + j] = static_cast<float>(
          exp((fi + A.g64[j] - static_cast<double>(A.cost[row + j])) / A.eps));
    }
    if (threadIdx.x == 0) A.f32[i] = static_cast<float>(fi);
  }
  for (int j = blk * kThreads + threadIdx.x; j < m; j += G * kThreads) {
    A.g32[j] = static_cast<float>(A.g64[j]);
  }
}

// Blocks of the launch (one an SM), and the rows a block keeps in shared
// memory for an [n, m] cost: the launch's shape, fixed by the card.
int launch_shape(int n, int m, int* blocks, int* res, int* smem) {
  int dev = 0, sms = 0, cap = 0, coop = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  const int p = n < sms ? n : sms;
  const int rows_max = (n + p - 1) / p;
  const long long row_bytes = 4LL * m;
  // Room for the kernel's static shared memory (8 KB) and a margin.
  long long fit = (cap - 16384) / row_bytes;
  if (fit < 0) fit = 0;
  *blocks = sms;
  *res = static_cast<int>(fit < rows_max ? fit : rows_max);
  *smem = static_cast<int>(*res * row_bytes);
  return 0;
}

}  // namespace

// cost [n, m], a [n], b [m] float32. Scratch: f64 [n], g64 [m], la [n], lb
// [m] float64; fp [n], gp [m] float32; part [part_rows, m] float2, with
// part_rows at least min(SMs, n); bar two unsigned ints. Writes plan [n, m],
// f [n] and g [m], and shape[0..1] the launch's blocks and the rows a block
// kept in shared memory.
extern "C" int same_sinkhorn_dense(const float* cost, const float* a, const float* b,
                                   int n, int m, float eps, int n_iters, double* f64,
                                   double* g64, double* la, double* lb, float* fp, float* gp,
                                   float2* part, int part_rows, unsigned int* bar, float* plan,
                                   float* f, float* g, void* stream, int* shape) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int blocks = 0, res = 0, smem = 0;
  int err = launch_shape(n, m, &blocks, &res, &smem);
  if (err != 0) return err;
  if ((n < blocks ? n : blocks) > part_rows) return static_cast<int>(cudaErrorInvalidValue);
  shape[0] = blocks;
  shape[1] = res;
  Args A;
  A.cost = cost;
  A.a = a;
  A.b = b;
  A.n = n;
  A.m = m;
  A.iters = n_iters;
  A.P = n < blocks ? n : blocks;
  A.res = res;
  A.eps = static_cast<double>(eps);
  A.inv2 = kLog2e / A.eps;
  A.hi = static_cast<float>(A.inv2);
  A.lo = static_cast<float>(A.inv2 - static_cast<double>(A.hi));
  A.f64 = f64;
  A.g64 = g64;
  A.la = la;
  A.lb = lb;
  A.fp = fp;
  A.gp = gp;
  A.part = part;
  A.bar = bar;
  A.plan = plan;
  A.f32 = f;
  A.g32 = g;
  // 16-byte loads where every row starts 16-byte aligned.
  const bool vec = m % 4 == 0 && reinterpret_cast<uintptr_t>(cost) % 16 == 0;
  const void* kernel = vec ? reinterpret_cast<const void*>(sinkhorn_dense_kernel<true>)
                           : reinterpret_cast<const void*>(sinkhorn_dense_kernel<false>);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int per_sm = 0;
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  if (e == cudaSuccess) e = cudaMemsetAsync(bar, 0, 2 * sizeof(unsigned int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&A};
  e = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, smem, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
