// K4 `sinkhorn_sparse`: log-domain Sinkhorn over padded [n, K] candidates
// with a no-match sink, every iteration in one launch of one thread-block
// cluster.
//
// Replaces same_tpu/ops/sinkhorn.py:56-99 (`sinkhorn_sparse`, XLA). Each
// iteration is two passes:
//   - the row pass: gather the ref duals g of each row's K candidates, form
//     the masked logits (g - cost) / eps and the sink's -nm / eps, take the
//     row's logsumexp (maximum first, then the sum over columns 0..K in that
//     order) and write the row of the plan, exp(logit - logsumexp), with 0 in
//     the invalid columns;
//   - the ref pass: sum the mass each ref's candidates send, then
//     g = min(g - eps * log(max(mass, 1e-9)), 0).
// After the last iteration one more row pass writes the final plan.
//
// One cluster of kClusterBlocks blocks of kThreads threads runs the whole
// call, its passes separated by the cluster's hardware barrier
// (barrier.cluster.arrive.release / wait.acquire: 0.77 us on the H100
// against 1.9 us for a software grid barrier, the barrier probe of
// csrc/barrier_probe.cu), so a call is one launch. The hardware schedules a
// cluster's blocks together, so the barrier needs no promise of
// co-residency from the caller, and two calls in flight on two host threads
// are two clusters (32 of 132 SMs) that the hardware schedules as they fit.
// Rows and refs beyond the cluster's threads are taken by striding.
//
// Where g fits in shared memory beside the tiles (at K = 24, up to 29,440
// refs), every block keeps a copy: loaded once, then kept current
// by the ref passes, which store each new value into all 16 copies through
// the cluster's distributed shared memory (a warp's 32 refs in one store a
// block), so the row pass gathers g[ref] from its own block's memory.
// The row pass gives a warp a tile of 32 rows (tile t to warp t / 16 of block
// t % 16, so that the rows spread over the cluster) and runs three steps
// through the tile in shared memory (32 rows of `stride` floats):
//   A. lanes over columns: kBatch rows' costs, refs and valid flags loaded
//      coalesced and unconditionally (the sink's lane reads nm through its
//      cost address, the padding lanes column K - 1), so that no load waits
//      behind a branch; then their g[ref], gathered once each; then the
//      logits into the tile, -inf in the invalid columns and the padding;
//   B. a lane a row: the maximum, the exps added in column order 0..K (the
//      plain version's order, kernels/sinkhorn_sparse.py::_row_pass_plain),
//      the logsumexp and the plan row back into the tile, read as float4
//      (the stride is 4 mod 8 floats, so a quarter-warp's loads hit distinct
//      banks);
//   C. lanes over columns: the plan rows written out coalesced.
// The ref pass gives a warp 32 consecutive refs, whose entries are one
// contiguous run of the list: the run's `ent` loaded coalesced and its plan
// values gathered kWindow at a time (kWindow / 32 loads a lane in flight)
// into the tile memory, then each lane adds its ref's values from there in
// list order (by row, then column). A ref with a long list costs adds, not a
// chain of round trips through L2, and does not hold its block at the
// barrier.
//
// The XLA version gets the mass by a scatter-add with duplicate indices. A
// float atomicAdd would make the sum's order, and so g, vary from run to
// run. Here the wrapper builds once per problem the list of plan entries of
// each ref (sorted by row, then column), and the ref pass gathers and sums
// them in that order: the result repeats, and equals the plain PyTorch
// version's, which adds in the same order.
//
// What bounds it on the H100: operations, about 8 f32 operations (two of them
// exp) for each valid candidate and each sink a pass, 0.16 GFLOP at the LUAD
// window's 100 iterations, 2.4 us at the card's 67 TFLOP/s; the ~4 MB of
// inputs and plan stay in L2. In practice one cluster is one GPC of 16 SMs,
// and that sets the pace: each pass moves its bytes (the row pass ~4 MB of
// inputs, plan and g copies at LUAD; the ref pass its list and a 32-byte
// sector for each gathered plan value) through that GPC's share of the L2
// bandwidth, and the row pass's two exps an entry run on 16 SMs' special
// function units. A launch a pass would spread the same work over the whole
// card but pay a launch for each of the 2 x n_iters + 1 passes.
//
// Memory order: plan and g are written by one pass and read by other blocks
// in the next, across a cluster barrier (release / acquire at cluster scope,
// which covers the blocks' shared memory too); from global memory they are
// read with __ldcg (L1 bypassed) and never through a const __restrict__
// pointer. Only the thread that owns a ref reads or writes its g during a
// ref pass. Remote stores come after the first barrier (every block has
// started) and before the last (none has exited). Every thread reaches every
// barrier: the loops around them depend only on n_iters.
//
// Exactness: every step is rounded to f32 in the plain version's order
// (__fsub_rn / __fdiv_rn / __fadd_rn / __fmul_rn; built with --fmad=false);
// expf and logf are CUDA's, the ones PyTorch's exp and log use on the card.
// Where eps is a power of two, x / eps and x * (1 / eps) are the same real
// number rounded once, so the multiply gives the division's bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kClusterBlocks = 16;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 32;
constexpr int kBatch = 8;    // rows a warp loads at once in the row pass
constexpr int kWindow = 512; // entries a warp stages at once in the ref pass

struct Args {
  const float* costs;   // [n, K]
  const int* ref;       // [n, K]
  const uint8_t* valid; // [n, K]
  const float* nm;      // [n]
  const int* ptr;       // [n_ref + 1]
  const int* ent;       // [ptr[n_ref]]
  int n, K, n_ref, n_iters;
  float eps, inv_eps;
  int eps_pow2;         // eps a power of two: multiply by inv_eps
  int stride;           // floats a tile row: >= K + 1, 4 mod 8
  int row_warps;        // warps a block in the row pass
  int g_shared;         // g kept in every block's shared memory
  float* g;             // [n_ref] in: start duals; out: result
  float* plan;          // [n, K + 1]
};

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// Stores v at `local` in block `rank`'s shared memory.
__device__ __forceinline__ void st_cluster(const void* local, unsigned rank, float v) {
  unsigned raddr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(raddr)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;" ::"r"(raddr), "f"(v) : "memory");
}

// The hardware barrier of the cluster: every thread of its blocks arrives.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ float logit(float g, float cost, const Args& a) {
  const float d = __fsub_rn(g, cost);
  return a.eps_pow2 ? __fmul_rn(d, a.inv_eps) : __fdiv_rn(d, a.eps);
}

// One row pass over the rows of the warps of block `rank`. Tile t of 32 rows
// goes to warp t / kClusterBlocks of block t % kClusterBlocks, so the rows
// spread over all the cluster's SMs.
__device__ void row_pass(const Args& a, const float* gs, float* tiles, int rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp >= a.row_warps) return;
  const int K = a.K, K1 = K + 1, S = a.stride;
  float* tile = tiles + static_cast<size_t>(warp) * kTileRows * S;
  const int step = a.row_warps * kClusterBlocks * kTileRows;
  for (int r0 = (warp * kClusterBlocks + rank) * kTileRows; r0 < a.n; r0 += step) {
    const int rows = min(kTileRows, a.n - r0);
    // A: the logits into the tile, lanes over columns (one sweep where
    // K + 1 <= 32), kBatch rows' unconditional loads at a time.
    for (int k = lane; k < S; k += 32) {
      const int kc = min(k, K - 1);
      for (int j0 = 0; j0 < rows; j0 += kBatch) {
        uint8_t ok[kBatch];
        float c[kBatch], g[kBatch];
        int rf[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = r0 + min(j0 + u, rows - 1);
          const size_t e = static_cast<size_t>(i) * K + kc;
          ok[u] = __ldg(a.valid + e);
          c[u] = __ldg(k < K ? a.costs + e : a.nm + i);
          rf[u] = __ldg(a.ref + e);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int r = min(max(rf[u], 0), a.n_ref - 1);
          g[u] = gs != nullptr ? gs[r] : __ldcg(a.g + r);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const float x = logit(k < K ? g[u] : 0.0f, c[u], a);
          const bool live = k < K ? ok[u] != 0 : k == K;
          if (j0 + u < rows) tile[(j0 + u) * S + k] = live ? x : neg_inf();
        }
      }
    }
    __syncwarp();
    // B: lane j takes row r0 + j.
    if (lane < rows) {
      float4* t = reinterpret_cast<float4*>(tile + lane * S);
      const int q_end = S >> 2;
      float mx = neg_inf();
#pragma unroll 8
      for (int q = 0; q < q_end; ++q) {
        const float4 v = t[q];
        mx = fmaxf(mx, fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w)));
      }
      float s = 0.0f;  // exp(-inf - mx) = 0 past column K adds nothing
#pragma unroll 8
      for (int q = 0; q < q_end; ++q) {
        const float4 v = t[q];
        s = __fadd_rn(s, expf(__fsub_rn(v.x, mx)));
        s = __fadd_rn(s, expf(__fsub_rn(v.y, mx)));
        s = __fadd_rn(s, expf(__fsub_rn(v.z, mx)));
        s = __fadd_rn(s, expf(__fsub_rn(v.w, mx)));
      }
      const float lse = __fadd_rn(logf(s), mx);
#pragma unroll 8
      for (int q = 0; q < q_end; ++q) {
        float4 v = t[q];
        v.x = expf(__fsub_rn(v.x, lse));
        v.y = expf(__fsub_rn(v.y, lse));
        v.z = expf(__fsub_rn(v.z, lse));
        v.w = expf(__fsub_rn(v.w, lse));
        t[q] = v;
      }
    }
    __syncwarp();
    // C: the plan rows out, lanes over columns.
    float* out = a.plan + static_cast<size_t>(r0) * K1;
    for (int k = lane; k < K1; k += 32) {
#pragma unroll 4
      for (int j = 0; j < rows; ++j) out[static_cast<size_t>(j) * K1 + k] = tile[j * S + k];
    }
    __syncwarp();
  }
}

// One ref pass: warp w of block `rank` takes 32 consecutive refs at a time,
// stages their run's plan values in `tiles`, kWindow at a time, and lane l
// adds ref r0 + l's values in list order.
__device__ void ref_pass(const Args& a, const float* gs, float* tiles, int rank) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* win = tiles + warp * kWindow;
  for (int r0 = (warp * kClusterBlocks + rank) * 32; r0 < a.n_ref;
       r0 += kWarps * kClusterBlocks * 32) {
    const int r = r0 + lane;
    const bool has = r < a.n_ref;
    const int beg = has ? __ldg(a.ptr + r) : 0, end = has ? __ldg(a.ptr + r + 1) : 0;
    const int run_beg = __ldg(a.ptr + r0), run_end = __ldg(a.ptr + min(r0 + 32, a.n_ref));
    float mass = 0.0f;
    for (int w0 = run_beg; w0 < run_end; w0 += kWindow) {  // uniform over the warp
      int idx[kWindow / 32];
      float v[kWindow / 32];
#pragma unroll
      for (int j = 0; j < kWindow / 32; ++j) {
        const int e = w0 + j * 32 + lane;
        idx[j] = e < run_end ? __ldg(a.ent + e) : -1;
      }
#pragma unroll
      for (int j = 0; j < kWindow / 32; ++j) v[j] = idx[j] >= 0 ? __ldcg(a.plan + idx[j]) : 0.0f;
#pragma unroll
      for (int j = 0; j < kWindow / 32; ++j) win[j * 32 + lane] = v[j];
      __syncwarp();
      const int hi = min(end, w0 + kWindow);
      for (int e = max(beg, w0); e < hi; ++e) mass = __fadd_rn(mass, win[e - w0]);
      __syncwarp();
    }
    if (has) {
      const float g = gs != nullptr ? gs[r] : __ldcg(a.g + r);
      const float gn = fminf(__fsub_rn(g, __fmul_rn(a.eps, logf(fmaxf(mass, 1e-9f)))), 0.0f);
      a.g[r] = gn;
      if (gs != nullptr) {  // into every block's copy of g, for the next row pass
        for (int b = 0; b < kClusterBlocks; ++b) st_cluster(gs + r, b, gn);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 1) sinkhorn_sparse_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* gs = a.g_shared ? smem : nullptr;
  float* tiles = smem + (a.g_shared ? ((a.n_ref + 3) & ~3) : 0);
  const int rank = static_cast<int>(blockIdx.x);  // one cluster a launch
  if (gs != nullptr) {  // the block's copy of g, then kept current by the ref passes
    for (int r = threadIdx.x; r < a.n_ref; r += kThreads) gs[r] = __ldcg(a.g + r);
    __syncthreads();
  }
  for (int it = 0; it <= a.n_iters; ++it) {
    row_pass(a, gs, tiles, rank);
    if (it == a.n_iters) break;
    cluster_sync();
    ref_pass(a, gs, tiles, rank);
    cluster_sync();
  }
}

}  // namespace

// g [n_ref] comes in as the start duals (zeros) and leaves as the result;
// plan [n, K + 1] is scratch during the iterations and the final plan after.
// shape[0] gets 1 where g was kept in shared memory, shape[1] the warps a
// block that ran the row pass.
extern "C" int same_sinkhorn_sparse(const float* costs, const int* ref,
                                    const uint8_t* valid, const float* nm,
                                    const int* ptr, const int* ent, int n,
                                    int K, int n_ref, float eps, int n_iters,
                                    float* g, float* plan, int* shape,
                                    void* stream) {
  int dev = 0, cap = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&cap, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  Args a;
  a.costs = costs; a.ref = ref; a.valid = valid; a.nm = nm;
  a.ptr = ptr; a.ent = ent;
  a.n = n; a.K = K; a.n_ref = n_ref; a.n_iters = n_iters;
  a.eps = eps;
  int e2 = 0;
  const float mant = frexpf(eps, &e2);
  a.eps_pow2 = mant == 0.5f && e2 > -124 && e2 < 126;  // 1 / eps a normal float
  a.inv_eps = a.eps_pow2 ? ldexpf(1.0f, 1 - e2) : 0.0f;
  if (K < 1) return static_cast<int>(cudaErrorInvalidValue);
  a.stride = (K + 1 + 3) & ~3;
  if (a.stride % 8 == 0) a.stride += 4;
  a.g = g; a.plan = plan;
  // Shared memory: a tile for each warp that fits (all of a block's, unless K
  // is large), then g where it fits beside them.
  const long long tile_bytes = 4LL * kTileRows * a.stride;
  const long long g_bytes = 4LL * ((n_ref + 3) & ~3);
  const long long warps = cap / tile_bytes;
  a.row_warps = static_cast<int>(warps < kWarps ? warps : kWarps);
  if (a.row_warps < 1) return static_cast<int>(cudaErrorInvalidValue);
  // The ref pass's windows reuse the tiles' memory.
  long long tiles = a.row_warps * tile_bytes;
  if (tiles < 4LL * kWarps * kWindow) tiles = 4LL * kWarps * kWindow;
  a.g_shared = g_bytes + tiles <= cap;
  const size_t smem = static_cast<size_t>((a.g_shared ? g_bytes : 0) + tiles);
  shape[0] = a.g_shared;
  shape[1] = a.row_warps;

  err = cudaFuncSetAttribute(sinkhorn_sparse_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) {
    // The device's largest, a constant: calls on other host threads with
    // other sizes do not race on it.
    err = cudaFuncSetAttribute(sinkhorn_sparse_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, cap);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kClusterBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kClusterBlocks;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sinkhorn_sparse_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
