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
// K7, one block of 256 threads a window. The three float sums are taken in
// one fixed order that depends on nothing but the element index: thread k
// adds elements k, k + 256, k + 512, ... in that order, then the 256
// partials are added in a fixed halving tree. So a sum does not depend on
// the batch size, on the launch grid, or on the zero padding of the batched
// loop's triangles: a window's sums are the same solo and in a batch
// (ROADMAP C6: the stop rule compares f32 sums at large magnitude). The
// plain version adds in this same order. The congestion overflow is an
// integer, matched rows minus distinct refs hit (each u_ref - 1 over the
// refs hit), counted with a bitmap of seen refs; the counts are exact.
//
// K8, one block of 1,024 threads a window:
//   1. each thread takes one triangle of a chunk of 1,024 and decides
//      whether it is a new cut (flipped, matched triple not in memory,
//      memory not full, the window registers this round);
//   2. a block-wide scan over the chunk (ballot and popc in the warp, warp
//      totals in shared memory), chunk after chunk, gives each new cut its
//      rank in triangle order; the first min(max_per_round, max_total -
//      cuts_added) ranks are kept, stored in the memory and written to a
//      compacted list (vertex, column block, surcharge) at their rank;
//   3. the surcharge, in JAX's order: s outer, the cuts in triangle order
//      inner. All cuts on one vertex v share its column block (choice[v]
//      sets it), and cuts on different vertices touch different rows of
//      extra, so the only updates that can meet are those of one vertex.
//      The thread of a vertex's first cut walks the list and applies that
//      vertex's updates in exactly the sequential order, including where
//      the clamp at C - 1 makes two values of s land on one column. No
//      atomics: the f32 result does not depend on timing (the sum of dp x
//      weights is not exact in f32 unless dp is dyadic).
// It writes added[w], the cuts kept, so that one host read replaces a
// nonzero and a sum.
//
// What bounds them on the H100: latency. At the LUAD window's first round
// (n = 12,288, T = 7,128, K = 6, 1,862 triangles flipped, 1,000 cuts) the
// data needs ~0.22 MB of K7 and ~0.12 MB of K8 (only flipped triangles need
// their vertices and the filled slots of their memory; K8 reads all K slots
// of those it tests), under 0.1 us of memory time against a launch of
// several us; one launch each replaces about twenty small PyTorch launches
// and two host synchronisations of the plain code.
//
// Exactness: __fadd_rn throughout, and the file is built with --fmad=false.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kSumThreads = 256;
constexpr int kCutThreads = 1024;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// Adds the 256 partials in sh[] in the fixed halving tree; the result is in
// sh[0]. Every thread of the block calls it.
__device__ void tree_sum(float* sh) {
  __syncthreads();
  for (int s = kSumThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] = __fadd_rn(sh[threadIdx.x], sh[threadIdx.x + s]);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kSumThreads) tear_scalars_kernel(
    const float* __restrict__ costs, const float* __restrict__ nm,
    const int* __restrict__ choice, const int* __restrict__ cand_ref,
    const int* __restrict__ m_ref, const uint8_t* __restrict__ flipped,
    const uint8_t* __restrict__ checked, const float* __restrict__ tw,
    const uint8_t* __restrict__ tri_mask, const int* __restrict__ src,
    const int* __restrict__ windows, int n, int C, int T, int words,
    unsigned int* __restrict__ seen, float* __restrict__ out) {
  // Block k sums window windows[k] (every window when windows is null) into
  // out[k]; seen[k] is its bitmap.
  const size_t k = blockIdx.x;
  const size_t w = windows ? static_cast<size_t>(windows[k]) : k;
  const int tid = threadIdx.x;
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
  seen += k * words;
  const int m = m_ref[w];

  __shared__ float sums[3][kSumThreads];
  __shared__ int counts[4];  // matched rows, distinct refs, checked, flipped
  for (int i = tid; i < words; i += kSumThreads) seen[i] = 0u;
  if (tid < 4) counts[tid] = 0;
  __syncthreads();

  float base = 0.0f;
  int matched = 0, distinct = 0;
  for (int i = tid; i < n; i += kSumThreads) {
    const int ch = choice[i];
    const int col = clampi(ch, 0, C - 1);
    const bool is_match = ch < C;
    base = __fadd_rn(base, is_match ? costs[static_cast<size_t>(i) * C + col] : nm[i]);
    if (is_match) {
      const int r = clampi(cand_ref[static_cast<size_t>(i) * C + col], 0, m - 1);
      const unsigned int bit = 1u << (r & 31);
      const unsigned int old = atomicOr(&seen[r >> 5], bit);
      matched += 1;
      distinct += (old & bit) ? 0 : 1;
    }
  }
  float flip_w = 0.0f, check_w = 0.0f;
  int n_checked = 0, n_flipped = 0;
  for (int t = tid; t < T; t += kSumThreads) {
    const float wt = tw[t];
    flip_w = __fadd_rn(flip_w, flipped[t] ? wt : 0.0f);
    check_w = __fadd_rn(check_w, (tri_mask[t] && src[t] != 0) ? wt : 0.0f);
    n_checked += checked[t] ? 1 : 0;
    n_flipped += flipped[t] ? 1 : 0;
  }
  atomicAdd(&counts[0], matched);
  atomicAdd(&counts[1], distinct);
  atomicAdd(&counts[2], n_checked);
  atomicAdd(&counts[3], n_flipped);
  sums[0][tid] = base;
  sums[1][tid] = flip_w;
  sums[2][tid] = check_w;
  tree_sum(sums[0]);
  tree_sum(sums[1]);
  tree_sum(sums[2]);
  if (tid == 0) {
    float* o = out + 6 * k;
    o[0] = sums[0][0];
    o[1] = static_cast<float>(counts[0] - counts[1]);
    o[2] = sums[1][0];
    o[3] = sums[2][0];
    o[4] = static_cast<float>(counts[2]);
    o[5] = static_cast<float>(counts[3]);
  }
}

// The matched pair of aligned row v, or -1 (tearing_device.py:121).
__device__ __forceinline__ int match_pair(const int* __restrict__ choice,
                                          const int* __restrict__ pair_idx,
                                          int v, int n, int C) {
  v = clampi(v, 0, n - 1);
  const int ch = choice[v];
  return ch < C ? pair_idx[static_cast<size_t>(v) * C + clampi(ch, 0, C - 1)] : -1;
}

// ctl[w] = {register, cuts_added}. The compacted list (list_v, list_blk,
// list_val, [b, T]) is scratch written and read by the window's block.
__global__ void __launch_bounds__(kCutThreads) register_cuts_kernel(
    const int* __restrict__ tris, const float* __restrict__ surcharge,
    const int* __restrict__ choice, const int* __restrict__ pair_idx,
    const uint8_t* __restrict__ flipped, const int8_t* __restrict__ vmove,
    const long long* __restrict__ ctl, int n, int C, int T, int L, int K,
    int max_per_round, long long max_total, int* cut_mem, int* cut_cnt,
    float* extra, int* list_v, int* list_blk, float* list_val, int* added) {
  const size_t w = blockIdx.x;
  const int tid = threadIdx.x;
  if (ctl[2 * w] == 0) {
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
  list_v += w * T;
  list_blk += w * T;
  list_val += w * T;
  const long long room = max_total - ctl[2 * w + 1];
  const int limit = static_cast<int>(
      max(0LL, min(static_cast<long long>(max_per_round), room)));

  __shared__ int warp_total[kCutThreads / 32];
  const int lane = tid & 31, warp = tid >> 5;
  int found = 0;  // new cuts in the chunks before this one
  for (int t0 = 0; t0 < T; t0 += kCutThreads) {
    const int t = t0 + tid;
    bool is_new = false;
    int p0 = -1, p1 = -1, p2 = -1, cnt = 0;
    if (t < T && flipped[t]) {
      p0 = match_pair(choice, pair_idx, tris[3 * t], n, C);
      p1 = match_pair(choice, pair_idx, tris[3 * t + 1], n, C);
      p2 = match_pair(choice, pair_idx, tris[3 * t + 2], n, C);
      cnt = cut_cnt[t];
      if (p0 >= 0 && p1 >= 0 && p2 >= 0 && cnt < K) {
        bool dup = false;
        const int* mem = cut_mem + static_cast<size_t>(t) * K * 3;
        for (int k = 0; k < K; ++k) {
          dup = dup || (mem[3 * k] == p0 && mem[3 * k + 1] == p1 && mem[3 * k + 2] == p2);
        }
        is_new = !dup;
      }
    }
    const unsigned int ballot = __ballot_sync(0xffffffffu, is_new);
    if (lane == 0) warp_total[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, chunk = 0;
    for (int k = 0; k < kCutThreads / 32; ++k) {
      before += k < warp ? warp_total[k] : 0;
      chunk += warp_total[k];
    }
    const int rank = found + before + __popc(ballot & ((1u << lane) - 1u));
    if (is_new && rank < limit) {
      int* slot = cut_mem + (static_cast<size_t>(t) * K + cnt) * 3;
      slot[0] = p0;
      slot[1] = p1;
      slot[2] = p2;
      cut_cnt[t] = cnt + 1;
      const int v = tris[3 * t + clampi(vmove[t], 0, 2)];
      const int col = clampi(choice[clampi(v, 0, n - 1)], 0, C - 1);
      list_v[rank] = v;
      list_blk[rank] = (col / L) * L;
      list_val[rank] = surcharge[t];
    }
    found += chunk;
    __syncthreads();  // warp_total is rewritten by the next chunk
  }
  const int n_added = min(found, limit);

  // The surcharge: the thread of each vertex's first cut applies all of that
  // vertex's updates, s outer and the cuts in triangle order inner.
  for (int j = tid; j < n_added; j += kCutThreads) {
    const int v = list_v[j];
    bool head = true;
    for (int k = 0; k < j && head; ++k) head = list_v[k] != v;
    if (!head) continue;
    float* row = extra + static_cast<size_t>(v) * C;
    const int blk = list_blk[j];
    for (int s = 0; s < L; ++s) {
      const int c = clampi(blk + s, 0, C - 1);
      float x = row[c];
      for (int k = j; k < n_added; ++k) {
        if (list_v[k] == v) x = __fadd_rn(x, list_val[k]);
      }
      row[c] = x;
    }
  }
  if (tid == 0) added[w] = n_added;
}

}  // namespace

// K7 over nw windows of the [b, ...] stacks: windows [nw] (null: all b, in
// order); out [nw, 6]; seen [nw, words] is scratch (words = ceil(m_max / 32)).
extern "C" int same_tear_scalars(
    const float* costs, const float* nm, const int* choice, const int* cand_ref,
    const int* m_ref, const uint8_t* flipped, const uint8_t* checked,
    const float* tw, const uint8_t* tri_mask, const int* src,
    const int* windows, int nw, int n, int C, int T, int words,
    unsigned int* seen, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tear_scalars_kernel<<<nw, kSumThreads, 0, st>>>(
      costs, nm, choice, cand_ref, m_ref, flipped, checked, tw, tri_mask, src,
      windows, n, C, T, words, seen, out);
  return static_cast<int>(cudaGetLastError());
}

// K8: writes cut_mem [b, T, K, 3], cut_cnt [b, T] and extra [b, n, C] in
// place and added [b]; list_* [b, T] are scratch.
extern "C" int same_register_cuts(
    const int* tris, const float* surcharge, const int* choice,
    const int* pair_idx, const uint8_t* flipped, const int8_t* vmove,
    const long long* ctl, int b, int n, int C, int T, int L, int K,
    int max_per_round, long long max_total, int* cut_mem, int* cut_cnt,
    float* extra, int* list_v, int* list_blk, float* list_val, int* added,
    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  register_cuts_kernel<<<b, kCutThreads, 0, st>>>(
      tris, surcharge, choice, pair_idx, flipped, vmove, ctl, n, C, T, L, K,
      max_per_round, max_total, cut_mem, cut_cnt, extra, list_v, list_blk,
      list_val, added);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
