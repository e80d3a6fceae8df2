// K7 `tear_scalars` and K8 `register_cuts`: the rest of a tear round, after
// the auction (auction_loop / K5) and the flip test (K2 / K6), for a stack of
// b windows ([b, n, C] rows, [b, T] triangles, one block a window).
//
// Replaces
//   - K7: same_tpu/solver/tearing_device.py:146-160 (XLA), the six values
//     the stop rule reads: the base cost sum(where(is_match, costs[row, col],
//     nm)), the congestion overflow sum(max(u_ref - 1, 0)) of the per-ref
//     match counts, the flipped weight, the checkable weight, and the
//     checked and flipped counts;
//   - K8: same_tpu/solver/tearing_device.py:209-254 (XLA), cut registration
//     and the regret-directed surcharge: a flipped triangle whose three
//     vertices are matched becomes a cut unless its pair triple is already
//     in its dedup memory cut_mem[t, :K] or the memory is full; the
//     per-round and total caps are taken in triangle-index order (a cumsum
//     rank); each cut's triple is stored at cut_mem[t, cut_cnt[t]]; and each
//     cut adds its surcharge to extra[v, clamp(blk + s, 0, C - 1)] for s in
//     [0, L), v = tris[t, vmove[t]], blk = (clamp(choice[v]) / L) * L.
//   Both also replace the same code vmapped over a window batch
//   (run_tearing_device_batch, tearing_device.py:514-811).
//
// What bounds them on the H100: latency, not bytes. At the LUAD window's
// first round (n = 12,288, T = 7,128, K = 6, 1,862 triangles flipped, 1,000
// cuts) the data needs ~0.22 MB of K7 and ~0.12 MB of K8, under 0.1 us of
// memory time; what costs is each chain of loads that waits on the one
// before (a gather behind a gather behind a flag), each barrier of the
// block, and the launch, all on the one SM that runs the window. The design
// keeps the chains short and few. What is left (an H100 at 700 W, see
// PERF.md): K7 takes ~16 us there, ~9 us of it with no row matched, the
// rest one SM's gathers of costs and refs; K8 ~37 us, ~2.5 us of it with no
// triangle flipped, the rest the flipped triangles' gathers. A stack's
// windows run side by side, one block on each SM.
//
// K7, one block of 1,024 threads a window. The three float sums are taken
// in one fixed order that depends on nothing but the element index: element
// i goes to partial i % 256, the partials' elements in index order, then the
// 256 partials are added in a fixed halving tree (the last five steps as
// warp shuffles in the same pairing). So a sum does not depend on the batch
// size, on the launch grid, or on the zero padding of the batched loop's
// triangles: a window's sums are the same solo and in a batch (ROADMAP C6:
// the stop rule compares f32 sums at large magnitude). The plain version
// adds in this same order. The rows (then the triangles) go a tile of 4,096
// at a time: every thread loads four of them, choices first and then the
// gathers, all in flight together, and stages each value at its index in
// shared memory; then threads 0-255 each add their partial's elements of
// the tile. With 32 warps loading, the gathers of one SM overlap; the adds
// are shared-memory reads. The ref bitmap lies in shared memory and is set
// with atomicOr whose result no thread reads; the distinct refs hit are
// the bitmap's popcount once it is complete, so no row waits on an atomic.
// A window with more refs than kSumSharedWords * 32 takes the same code on
// a global bitmap. The counts are warp reductions (__reduce_add_sync) of
// exact integers; the congestion overflow is matched rows minus distinct
// refs hit.
//
// K8, one block of 1,024 threads a window:
//   1. registration in one sweep over the triangles (T <= 32,768; sweeps
//      of 32 triangles a thread otherwise): thread j takes a contiguous run
//      of ceil(T / 1,024) triangles, loads their flipped flags together,
//      and decides for each flipped one whether it is a new cut (matched
//      triple not in memory, memory not full), four at a time, each step's
//      loads (vertices and counts, then choices, then pairs, then the
//      memories) issued for all four before any is used;
//   2. one block-wide exclusive scan of the per-thread counts (warp
//      shuffles, then one warp over the 32 warp totals) ranks the new cuts
//      in triangle order; the first min(max_per_round, max_total -
//      cuts_added) ranks are kept, stored in the memory, and entered in a
//      compacted list at their rank: a key (vertex << 32 | rank) and the
//      surcharge, 12 bytes a cut, in dynamic shared memory (up to
//      kCutSharedEntries cuts; beyond it the same code on a global list);
//   3. a bitonic sort of the keys (shared-memory steps for partners 32 or
//      more apart, warp shuffles below) groups each vertex's cuts into one
//      segment in triangle order;
//   4. the surcharge, in JAX's order: s outer, the cuts in triangle order
//      inner. All cuts on one vertex v share its column block (choice[v]
//      sets it), and cuts on different vertices touch different rows of
//      extra, so the only updates that can meet are those of one vertex.
//      The first thread of each segment applies that vertex's updates in
//      exactly the sequential order, one __fadd_rn at a time, including
//      where the clamp at C - 1 makes two values of s land on one column.
//      No atomics: the f32 result does not depend on timing (the sum of dp x
//      weights is not exact in f32 unless dp is dyadic).
// It writes added[w], the cuts kept, so that one host read replaces a
// nonzero and a sum. The work is O(T / 1,024) loads a thread, one scan and
// O(log^2 n_added) sort steps, where the earlier design walked the list of
// cuts once per cut and scanned the triangles 1,024 at a time.
//
// Exactness: __fadd_rn throughout, integer atomics only, and the file is
// built with --fmad=false.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 1024;
constexpr int kSumChains = 256;  // K7's partial sums: element i goes to partial i % 256
constexpr int kSumRows = 4;      // rows (triangles) a K7 thread loads into a tile
constexpr int kSumTile = kSumThreads * kSumRows;
constexpr int kSumSharedWords = 8192;  // K7's shared bitmap: 262,144 refs
constexpr int kCutThreads = 1024;
constexpr int kCutWarps = kCutThreads / 32;
constexpr int kCutGroup = 4;    // flipped triangles whose loads a K8 thread issues together
constexpr int kCutRun = 32;     // most triangles a K8 thread takes in one sweep
constexpr int kCutSharedEntries = 8192;  // K8's shared list: 96 KB
constexpr unsigned int kFull = 0xffffffffu;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

template <bool kGlobal>
__global__ void __launch_bounds__(kSumThreads) tear_scalars_kernel(
    const float* __restrict__ costs, const float* __restrict__ nm,
    const int* __restrict__ choice, const int* __restrict__ cand_ref,
    const int* __restrict__ m_ref, const uint8_t* __restrict__ flipped,
    const uint8_t* __restrict__ checked, const float* __restrict__ tw,
    const uint8_t* __restrict__ tri_mask, const int* __restrict__ src,
    const int* __restrict__ windows, int n, int C, int T, int words,
    unsigned int* __restrict__ gseen, float* __restrict__ out) {
  // Block k sums window windows[k] (every window when windows is null) into
  // out[k]; its bitmap is the dynamic shared array, or gseen[k] (kGlobal).
  extern __shared__ unsigned int sseen[];
  __shared__ float stage[2][kSumTile];  // a tile's values, by element
  __shared__ float sums[3][kSumChains];
  __shared__ int counts[4][kSumThreads / 32];  // matched, distinct, checked, flipped
  const size_t k = blockIdx.x;
  const size_t w = windows ? static_cast<size_t>(windows[k]) : k;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t nC = static_cast<size_t>(n) * C;
  costs += w * nC;
  cand_ref += w * nC;
  nm += w * n;
  choice += w * n;
  flipped += w * T;
  checked += w * T;
  tw += w * T;
  tri_mask += w * T;
  src += w * T;
  unsigned int* seen = kGlobal ? gseen + k * words : sseen;
  const int m = m_ref[w];
  for (int i = tid; i < words; i += kSumThreads) seen[i] = 0u;
  __syncthreads();

  // Rows, a tile at a time: every thread loads kSumRows of the tile's rows
  // (choices first, then the gathers) and stages each row's value at its
  // index; then thread k < 256 adds the tile's elements k, k + 256, ... to
  // its partial, so partial k gets the window's elements k, k + 256, ... in
  // index order.
  float base = 0.0f, flip_w = 0.0f, check_w = 0.0f;
  int matched = 0;
  for (int i0 = 0; i0 < n; i0 += kSumTile) {
    int ch[kSumRows], ref[kSumRows];
    float val[kSumRows];
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      const int i = i0 + tid + u * kSumThreads;
      ch[u] = i < n ? choice[i] : C;
    }
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      const int i = i0 + tid + u * kSumThreads;
      ref[u] = 0;
      val[u] = 0.0f;
      if (i < n) {
        const size_t at = static_cast<size_t>(i) * C + clampi(ch[u], 0, C - 1);
        if (ch[u] < C) {
          val[u] = costs[at];
          ref[u] = cand_ref[at];
        } else {
          val[u] = nm[i];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      if (i0 + tid + u * kSumThreads < n) {
        stage[0][tid + u * kSumThreads] = val[u];
        if (ch[u] < C) {
          const int r = clampi(ref[u], 0, m - 1);
          atomicOr(&seen[r >> 5], 1u << (r & 31));
          matched += 1;
        }
      }
    }
    __syncthreads();
    if (tid < kSumChains) {
      const int len = min(kSumTile, n - i0);
      for (int q = tid; q < len; q += kSumChains) base = __fadd_rn(base, stage[0][q]);
    }
    __syncthreads();  // the next tile rewrites stage
  }
  // Triangles, the same way: the flipped and the checkable weight.
  int n_checked = 0, n_flipped = 0;
  for (int t0 = 0; t0 < T; t0 += kSumTile) {
    uint8_t fl[kSumRows], ck[kSumRows], mk[kSumRows];
    int sg[kSumRows];
    float wt[kSumRows];
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      const int t = t0 + tid + u * kSumThreads;
      const bool in = t < T;
      fl[u] = in ? flipped[t] : 0;
      ck[u] = in ? checked[t] : 0;
      mk[u] = in ? tri_mask[t] : 0;
      sg[u] = in ? src[t] : 0;
      wt[u] = in ? tw[t] : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kSumRows; ++u) {
      if (t0 + tid + u * kSumThreads < T) {
        stage[0][tid + u * kSumThreads] = fl[u] ? wt[u] : 0.0f;
        stage[1][tid + u * kSumThreads] = (mk[u] && sg[u] != 0) ? wt[u] : 0.0f;
        n_checked += ck[u] ? 1 : 0;
        n_flipped += fl[u] ? 1 : 0;
      }
    }
    __syncthreads();
    if (tid < kSumChains) {
      const int len = min(kSumTile, T - t0);
      for (int q = tid; q < len; q += kSumChains) {
        flip_w = __fadd_rn(flip_w, stage[0][q]);
        check_w = __fadd_rn(check_w, stage[1][q]);
      }
    }
    __syncthreads();
  }
  // The bitmap is complete (the barrier after the last tile, or after the
  // zeroing when there is none).
  int distinct = 0;
  for (int i = tid; i < words; i += kSumThreads) {
    if constexpr (kGlobal) {
      distinct += __popc(__ldcg(seen + i));  // the atomics' values, from L2
    } else {
      distinct += __popc(seen[i]);
    }
  }
  const int mine[4] = {matched, distinct, n_checked, n_flipped};
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int x = __reduce_add_sync(kFull, mine[c]);
    if (lane == 0) counts[c][warp] = x;
  }
  if (tid < kSumChains) {
    sums[0][tid] = base;
    sums[1][tid] = flip_w;
    sums[2][tid] = check_w;
  }
  __syncthreads();
  // The halving tree: sh[t] += sh[t + s] for s = 128, ..., 1.
  for (int s = kSumChains / 2; s >= 32; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int c = 0; c < 3; ++c) sums[c][tid] = __fadd_rn(sums[c][tid], sums[c][tid + s]);
    }
    __syncthreads();
  }
  if (warp == 0) {
    float x[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) x[c] = sums[c][lane];
    for (int s = 16; s > 0; s >>= 1) {
#pragma unroll
      for (int c = 0; c < 3; ++c) x[c] = __fadd_rn(x[c], __shfl_down_sync(kFull, x[c], s));
    }
    if (lane == 0) {
      int tot[4] = {0, 0, 0, 0};
      for (int c = 0; c < 4; ++c) {
        for (int j = 0; j < kSumThreads / 32; ++j) tot[c] += counts[c][j];
      }
      float* o = out + 6 * k;
      o[0] = x[0];
      o[1] = static_cast<float>(tot[0] - tot[1]);
      o[2] = x[1];
      o[3] = x[2];
      o[4] = static_cast<float>(tot[2]);
      o[5] = static_cast<float>(tot[3]);
    }
  }
}

// Exclusive scan of x over the block's 1,024 threads, in thread order; the
// block's total goes to *total. warp_sums holds 33 ints.
__device__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int own = warp_sums[lane];
    int acc = own;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, acc, d);
      if (lane >= d) acc += y;
    }
    warp_sums[lane] = acc - own;
    if (lane == 31) warp_sums[32] = acc;
  }
  __syncthreads();
  const int before = warp_sums[warp] + incl - x;
  *total = warp_sums[32];
  __syncthreads();  // warp_sums is rewritten by the next scan
  return before;
}

// Sorts keys[0, p) ascending, p a power of two; every thread of the block
// calls it. Partners 32 or more apart meet in memory, one barrier a step;
// closer ones are in one warp and meet in registers.
__device__ void bitonic_sort(unsigned long long* keys, int p) {
  const int tid = threadIdx.x;
  for (int k = 2; k <= p; k <<= 1) {
    int j = k >> 1;
    for (; j >= 32; j >>= 1) {
      for (int i = tid; i < p; i += kCutThreads) {
        const int ixj = i ^ j;
        if (ixj > i) {
          const unsigned long long a = keys[i], b = keys[ixj];
          if ((a > b) == ((i & k) == 0)) {
            keys[i] = b;
            keys[ixj] = a;
          }
        }
      }
      __syncthreads();
    }
    for (int at = 0; at < p; at += kCutThreads) {  // the same trip count in every thread
      const int i = at + tid;
      const bool in = i < p;
      unsigned long long x = in ? keys[i] : ~0ull;
      for (int jj = j; jj > 0; jj >>= 1) {
        const unsigned long long y = __shfl_xor_sync(kFull, x, jj);
        const bool keep_min = ((i & k) == 0) == ((i & jj) == 0);
        x = keep_min ? min(x, y) : max(x, y);
      }
      if (in) keys[i] = x;
    }
    __syncthreads();
  }
}

// ctl[w] = {register, cuts_added}; with ctl null (one window) reg0 and done0
// are window 0's. The list (keys, vals) is the dynamic shared array, or
// window w's rows of gkeys and gvals (key_cap entries each; kGlobal).
template <bool kGlobal>
__global__ void __launch_bounds__(kCutThreads) register_cuts_kernel(
    const int* __restrict__ tris, const float* __restrict__ surcharge,
    const int* __restrict__ choice, const int* __restrict__ pair_idx,
    const uint8_t* __restrict__ flipped, const int8_t* __restrict__ vmove,
    const long long* __restrict__ ctl, int reg0, long long done0, int n, int C,
    int T, int L, int K, int max_per_round, long long max_total, int* cut_mem,
    int* cut_cnt, float* extra, unsigned long long* gkeys, float* gvals, int key_cap,
    int* added) {
  extern __shared__ unsigned long long slist[];
  __shared__ int warp_sums[kCutWarps + 1];
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x;
  const long long reg = ctl ? ctl[2 * w] : reg0;
  const long long done = ctl ? ctl[2 * w + 1] : done0;
  if (reg == 0) {
    if (tid == 0) added[w] = 0;
    return;
  }
  const size_t nC = static_cast<size_t>(n) * C;
  tris += w * 3 * T;
  surcharge += w * T;
  choice += w * n;
  pair_idx += w * nC;
  flipped += w * T;
  vmove += w * T;
  cut_mem += w * static_cast<size_t>(T) * K * 3;
  cut_cnt += w * T;
  extra += w * nC;
  unsigned long long* keys = kGlobal ? gkeys + w * key_cap : slist;
  float* vals = kGlobal ? gvals + w * key_cap : reinterpret_cast<float*>(slist + key_cap);
  const long long room = max_total - done;
  const int limit = static_cast<int>(
      max(0LL, min(static_cast<long long>(max_per_round), room)));

  // 1-2. Registration: a contiguous run of triangles a thread, one scan.
  const int per = min(kCutRun, (T + kCutThreads - 1) / kCutThreads);
  int found = 0;  // new cuts in the sweeps before this one
  for (int t0 = 0; t0 < T; t0 += per * kCutThreads) {
    const int lo = min(T, t0 + tid * per), hi = min(T, lo + per);
    // Bit g of a mask stands for triangle lo + g.
    unsigned int todo = 0u, is_new = 0u;
    for (int g0 = lo; g0 < hi; g0 += 8) {
      uint8_t fl[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) fl[u] = g0 + u < hi ? flipped[g0 + u] : 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) todo |= fl[u] ? 1u << (g0 + u - lo) : 0u;
    }
    while (todo) {  // the flipped triangles, kCutGroup at a time
      int t[kCutGroup], cnt[kCutGroup], vert[kCutGroup][3], ch[kCutGroup][3], pr[kCutGroup][3];
      bool in[kCutGroup];
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
        in[u] = todo != 0u;
        t[u] = in[u] ? lo + __ffs(todo) - 1 : lo;
        todo &= todo - 1u;
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
        cnt[u] = in[u] ? cut_cnt[t[u]] : K;
#pragma unroll
        for (int e = 0; e < 3; ++e) vert[u][e] = in[u] ? clampi(tris[3 * t[u] + e], 0, n - 1) : 0;
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
#pragma unroll
        for (int e = 0; e < 3; ++e) ch[u][e] = in[u] ? choice[vert[u][e]] : C;
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          pr[u][e] = ch[u][e] < C
              ? pair_idx[static_cast<size_t>(vert[u][e]) * C + clampi(ch[u][e], 0, C - 1)]
              : -1;
        }
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
        if (pr[u][0] >= 0 && pr[u][1] >= 0 && pr[u][2] >= 0 && cnt[u] < K) {
          const int* mem = cut_mem + static_cast<size_t>(t[u]) * K * 3;
          bool dup = false;
          for (int q = 0; q < K; ++q) {
            dup |= (mem[3 * q] == pr[u][0]) & (mem[3 * q + 1] == pr[u][1]) &
                   (mem[3 * q + 2] == pr[u][2]);
          }
          if (!dup) is_new |= 1u << (t[u] - lo);
        }
      }
    }
    int total;
    int rank = found + block_exclusive_scan(__popc(is_new), warp_sums, &total);
    // Store the kept cuts of the run, kCutGroup at a time with each step's
    // loads issued together (they hit the lines step 1 brought in).
    unsigned int keep = is_new;
    while (keep && rank < limit) {
      int t[kCutGroup], cnt[kCutGroup], mv[kCutGroup], vert[kCutGroup][3], ch[kCutGroup][3];
      float val[kCutGroup];
      bool in[kCutGroup];
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
        in[u] = keep != 0u;
        t[u] = in[u] ? lo + __ffs(keep) - 1 : lo;
        keep &= keep - 1u;
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
        cnt[u] = in[u] ? cut_cnt[t[u]] : 0;
        mv[u] = in[u] ? clampi(vmove[t[u]], 0, 2) : 0;
        val[u] = in[u] ? surcharge[t[u]] : 0.0f;
#pragma unroll
        for (int e = 0; e < 3; ++e) vert[u][e] = in[u] ? tris[3 * t[u] + e] : 0;
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
#pragma unroll
        for (int e = 0; e < 3; ++e) ch[u][e] = in[u] ? choice[clampi(vert[u][e], 0, n - 1)] : 0;
      }
#pragma unroll
      for (int u = 0; u < kCutGroup; ++u) {
        if (in[u] && rank < limit) {
          int* slot = cut_mem + (static_cast<size_t>(t[u]) * K + cnt[u]) * 3;
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const size_t row = static_cast<size_t>(clampi(vert[u][e], 0, n - 1));
            slot[e] = pair_idx[row * C + clampi(ch[u][e], 0, C - 1)];
          }
          cut_cnt[t[u]] = cnt[u] + 1;
          const int v = mv[u] == 0 ? vert[u][0] : (mv[u] == 1 ? vert[u][1] : vert[u][2]);
          keys[rank] = (static_cast<unsigned long long>(static_cast<unsigned int>(v)) << 32) |
                       static_cast<unsigned int>(rank);
          vals[rank] = val[u];
          ++rank;
        }
      }
    }
    found += total;
  }
  const int n_added = min(found, limit);
  if (n_added == 0) {
    if (tid == 0) added[w] = 0;
    return;
  }

  // 3. Group the cuts by vertex: sort the keys (vertex, rank), padded to a
  // power of two with the largest key.
  int p = 1;
  while (p < n_added) p <<= 1;
  for (int i = n_added + tid; i < p; i += kCutThreads) keys[i] = ~0ull;
  __syncthreads();
  bitonic_sort(keys, p);

  // 4. The surcharge: the first thread of each vertex's segment applies all
  // of that vertex's updates, s outer and the cuts in triangle order inner.
  for (int i = tid; i < n_added; i += kCutThreads) {
    const unsigned int v = static_cast<unsigned int>(keys[i] >> 32);
    if (i > 0 && static_cast<unsigned int>(keys[i - 1] >> 32) == v) continue;
    int end = i + 1;
    while (end < n_added && static_cast<unsigned int>(keys[end] >> 32) == v) ++end;
    const int vi = static_cast<int>(v);
    float* row = extra + static_cast<size_t>(vi) * C;
    const int blk = (clampi(choice[clampi(vi, 0, n - 1)], 0, C - 1) / L) * L;
    int col = -1;
    float x = 0.0f;
    for (int s = 0; s < L; ++s) {
      const int c = clampi(blk + s, 0, C - 1);
      if (c != col) {  // a new column; a clamped pass goes on adding into the last
        if (col >= 0) row[col] = x;
        x = row[c];
        col = c;
      }
      for (int q = i; q < end; ++q) {
        x = __fadd_rn(x, vals[static_cast<unsigned int>(keys[q] & 0xffffffffull)]);
      }
    }
    if (col >= 0) row[col] = x;
  }
  if (tid == 0) added[w] = n_added;
}

// Lets `kernel` take `bytes` of dynamic shared memory, beyond the 48 KB a
// block gets by default; asked once per device (done[device]).
cudaError_t allow_shared(const void* kernel, int bytes, bool* done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < 64;
  if (known && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && known) done[dev] = true;
  return err;
}

}  // namespace

// K7 over nw windows of the [b, ...] stacks: windows [nw] (null: all b, in
// order); out [nw, 6]. The bitmap of refs hit (words = ceil(m_max / 32)) is
// in shared memory up to same_tear_scalars_shared_words(); beyond it seen
// [nw, words] is the global scratch that takes its place (null otherwise).
extern "C" int same_tear_scalars(
    const float* costs, const float* nm, const int* choice, const int* cand_ref,
    const int* m_ref, const uint8_t* flipped, const uint8_t* checked,
    const float* tw, const uint8_t* tri_mask, const int* src,
    const int* windows, int nw, int n, int C, int T, int words,
    unsigned int* seen, float* out, void* stream) {
  if (!seen && words > kSumSharedWords) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = seen ? 0 : static_cast<size_t>(words) * sizeof(unsigned int);
  if (!seen) {
    static bool opted[64] = {false};
    const cudaError_t err = allow_shared(
        reinterpret_cast<const void*>(&tear_scalars_kernel<false>),
        kSumSharedWords * static_cast<int>(sizeof(unsigned int)), opted);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = seen ? tear_scalars_kernel<true> : tear_scalars_kernel<false>;
  kernel<<<nw, kSumThreads, smem, st>>>(costs, nm, choice, cand_ref, m_ref, flipped, checked,
                                        tw, tri_mask, src, windows, n, C, T, words, seen, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int same_tear_scalars_shared_words() { return kSumSharedWords; }

// K8: writes cut_mem [b, T, K, 3], cut_cnt [b, T] and extra [b, n, C] in
// place and added [b]. ctl [b, 2] (null for one window: reg0, done0). The
// list of a window's cuts holds key_cap entries (a power of two at least
// min(max_per_round, T)): in shared memory up to
// same_register_cuts_shared_entries(), else in keys [b, key_cap] and vals
// [b, key_cap], global scratch (null otherwise).
extern "C" int same_register_cuts(
    const int* tris, const float* surcharge, const int* choice,
    const int* pair_idx, const uint8_t* flipped, const int8_t* vmove,
    const long long* ctl, int reg0, long long done0, int b, int n, int C, int T,
    int L, int K, int max_per_round, long long max_total, int* cut_mem, int* cut_cnt,
    float* extra, unsigned long long* keys, float* vals, int key_cap, int* added,
    void* stream) {
  if (!keys && key_cap > kCutSharedEntries) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = keys ? 0 : static_cast<size_t>(key_cap) * 12;
  if (!keys) {
    static bool opted[64] = {false};
    const cudaError_t err = allow_shared(
        reinterpret_cast<const void*>(&register_cuts_kernel<false>), kCutSharedEntries * 12,
        opted);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto kernel = keys ? register_cuts_kernel<true> : register_cuts_kernel<false>;
  kernel<<<b, kCutThreads, smem, st>>>(
      tris, surcharge, choice, pair_idx, flipped, vmove, ctl, reg0, done0, n, C, T,
      L, K, max_per_round, max_total, cut_mem, cut_cnt, extra, keys, vals, key_cap,
      added);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int same_register_cuts_shared_entries() { return kCutSharedEntries; }

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
