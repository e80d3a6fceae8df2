// One bidding round of the epsilon-scaling auction, shared by the
// single-round kernel K1 (auction_bid.cu, the test entry) and the persistent
// solve (auction_loop.cu, the main path): the per-bidder and per-slot bodies,
// the bid and resolve phases that loop over them, and the thread-block
// cluster both kernels run on.
//
// Each body handles one bidder or one slot. Arrays the round mutates are
// read through ld_state (a load that bypasses L1): inside the persistent
// kernel another block wrote them in the previous phase, and a pointer
// declared const __restrict__ could be read through the non-coherent path.
// Arrays that no phase writes are const __restrict__.
//
// All arithmetic is f32 with explicit round-to-nearest intrinsics, so nvcc
// cannot contract or reorder -(cost + p) or v1 - v2 + eps.
//
// In the bid phase each active bidder walks its row (row_top2), and each
// column's value needs a price gathered at the column's slot. A load issued
// only after a branch on the valid flag waits for that flag, so the columns
// ran one after the other. Here a row is read a chunk of columns at a time:
// every cost, slot and valid flag of the chunk unconditionally (16-byte
// loads where the row is a compile-time width), then the chunk's prices all
// together, and only then the same top-2 chain as before, with the valid
// flag as a select. Every slot lies in [0, S] (invalid columns hold S), so
// the gathers read nothing the JAX round (auction.py:258) does not.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace same_auction {

// The cluster of a solve (and of K1's one launch): kClusterBlocks blocks of
// kThreads threads, kStride threads in all.
constexpr int kThreads = 1024;
constexpr int kClusterBlocks = 16;
constexpr int kStride = kThreads * kClusterBlocks;
// Columns of a row that row_top2 loads before it computes any, at a
// compile-time width (kChunkCols) and at any other (kChunkAny). The chunks
// run one after the other: with these sizes neither auction_loop kernel
// spills under the 64 registers a thread that 1,024-thread blocks allow,
// and 8 was the fastest such choice for the LUAD solve on an H100
// (bid_round_bench.py; PERF.md, section 6).
constexpr int kChunkCols = 8;
constexpr int kChunkAny = 4;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <class T>
__device__ __forceinline__ T ld_state(const T* p) { return __ldcg(p); }

// Order-preserving map of f32 bits onto u32 (larger float, larger key).
__device__ __forceinline__ unsigned int ordered_bits(float f) {
  unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned int o) {
  unsigned int u = (o & 0x80000000u) ? (o & 0x7fffffffu) : ~o;
  return __uint_as_float(u);
}

// The hardware barrier of the cluster: every thread of its blocks arrives.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// A row width known at compile time.
template <int W>
struct Width {
  __device__ constexpr operator int() const { return W; }
};

// Whether rows of width 8 or 24 can be read with 16-byte loads: costs and
// slots 16-byte aligned and the valid flags 4-byte aligned (a row of such a
// width then keeps that alignment).
__device__ __forceinline__ bool vector_rows(const float* costs, const int* slots,
                                            const uint8_t* valid) {
  return ((reinterpret_cast<uintptr_t>(costs) | reinterpret_cast<uintptr_t>(slots)) & 15u) == 0 &&
         (reinterpret_cast<uintptr_t>(valid) & 3u) == 0;
}

// Calls f with the row width C: as Width<24> or Width<8> where C is one the
// main path meets (24: knn 8 x ref match multiplier 3, the LUAD and grid
// windows; 8) and the rows allow 16-byte loads (vector_rows), else as the
// int C. The loops over columns then take the vector or the scalar loads,
// with the same arithmetic in the same order.
template <class F>
__device__ __forceinline__ void at_width(int C, bool vec, F&& f) {
  if (vec && C == 24) {
    f(Width<24>{});
  } else if (vec && C == 8) {
    f(Width<8>{});
  } else {
    f(C);
  }
}

// Bidder value of column k at the current prices: -(cost + price), or -inf
// for an invalid column. Every load is issued before the select.
__device__ __forceinline__ float col_value(const float* __restrict__ costs,
                                           const int* __restrict__ slots,
                                           const uint8_t* __restrict__ valid,
                                           const float* prices, size_t idx) {
  const float c = costs[idx];
  const bool ok = valid[idx] != 0;
  const float v = -__fadd_rn(c, ld_state(prices + slots[idx]));
  return ok ? v : neg_inf();
}

struct Top2 {
  float best, second;
  int col;  // first column of the best value; C is the no-match column
};

// One step of the top-2 chain: strict '>' keeps the lower column on ties.
// A value of -inf changes nothing, so padded columns may pass through it.
__device__ __forceinline__ void top2_step(Top2& t, float v, int k) {
  const bool better = v > t.best;
  t.second = better ? t.best : fmaxf(t.second, v);
  t.col = better ? k : t.col;
  t.best = better ? v : t.best;
}

// Top-2 of a bidder's C values plus the no-match value -nm, like
// lax.top_k(vals_all, 2): strict '>' keeps the lower column on ties.
// Compile-time width: each chunk is kChunkCols / 4 16-byte loads of costs
// and of slots and as many 4-byte loads of flags, then its price gathers.
template <int W>
__device__ __forceinline__ Top2 row_top2(const float* __restrict__ costs,
                                         const int* __restrict__ slots,
                                         const uint8_t* __restrict__ valid,
                                         float nm_b, const float* prices,
                                         size_t row, Width<W>) {
  constexpr int V = kChunkCols / 4;  // 16-byte loads a chunk
  static_assert(kChunkCols % 4 == 0 && W % kChunkCols == 0, "whole 16-byte loads");
  const float4* c4 = reinterpret_cast<const float4*>(costs + row);
  const int4* s4 = reinterpret_cast<const int4*>(slots + row);
  const unsigned int* f4 = reinterpret_cast<const unsigned int*>(valid + row);
  Top2 t{neg_inf(), neg_inf(), 0};
#pragma unroll 1
  for (int q = 0; q < W / kChunkCols; ++q) {
    float c[kChunkCols], p[kChunkCols];
    int s[kChunkCols];
    unsigned int ok[V];
#pragma unroll
    for (int u = 0; u < V; ++u) {
      const float4 cu = c4[q * V + u];
      const int4 su = s4[q * V + u];
      ok[u] = f4[q * V + u];
      c[4 * u] = cu.x, c[4 * u + 1] = cu.y, c[4 * u + 2] = cu.z, c[4 * u + 3] = cu.w;
      s[4 * u] = su.x, s[4 * u + 1] = su.y, s[4 * u + 2] = su.z, s[4 * u + 3] = su.w;
    }
#pragma unroll
    for (int j = 0; j < kChunkCols; ++j) p[j] = ld_state(prices + s[j]);
#pragma unroll
    for (int j = 0; j < kChunkCols; ++j) {
      const float v = -__fadd_rn(c[j], p[j]);
      const bool on = ((ok[j / 4] >> (8 * (j % 4))) & 0xffu) != 0;
      top2_step(t, on ? v : neg_inf(), q * kChunkCols + j);
    }
  }
  top2_step(t, -nm_b, W);
  return t;
}

// Any width: scalar loads, a chunk at a time, the last chunk's columns past
// C read at column C - 1 (in bounds) and passed through as -inf.
__device__ __forceinline__ Top2 row_top2(const float* __restrict__ costs,
                                         const int* __restrict__ slots,
                                         const uint8_t* __restrict__ valid,
                                         float nm_b, const float* prices,
                                         size_t row, int C) {
  Top2 t{neg_inf(), neg_inf(), 0};
#pragma unroll 1
  for (int k0 = 0; k0 < C; k0 += kChunkAny) {
    float c[kChunkAny], p[kChunkAny];
    int s[kChunkAny];
    bool ok[kChunkAny];
#pragma unroll
    for (int j = 0; j < kChunkAny; ++j) {
      const size_t idx = row + min(k0 + j, C - 1);
      c[j] = costs[idx];
      s[j] = slots[idx];
      ok[j] = valid[idx] != 0 && k0 + j < C;
    }
#pragma unroll
    for (int j = 0; j < kChunkAny; ++j) p[j] = ld_state(prices + s[j]);
#pragma unroll
    for (int j = 0; j < kChunkAny; ++j) {
      const float v = -__fadd_rn(c[j], p[j]);
      top2_step(t, ok[j] ? v : neg_inf(), k0 + j);
    }
  }
  top2_step(t, -nm_b, C);
  return t;
}

// Bid of bidder b, which holds assignment a (same_tpu/solver/auction.py:
// 257-272). Only an active bidder (a < 0 or a == C) reads its row. Returns
// the column it bids on (-1 for none) and stores its assignment after the
// no-match choice in *na. The bid goes into keys[tgt] as ONE 64-bit
// atomicMax on (ordered bits of the bid) << 32 | (n - b): the largest key
// carries the highest bid and, among equal bids, the smallest bidder, which
// is the JAX round's scatter-max followed by its scatter-min tie-break.
template <class Cw>
__device__ __forceinline__ int bid_body(int b, int a,
                                        const float* __restrict__ costs,
                                        const int* __restrict__ slots,
                                        const uint8_t* __restrict__ valid,
                                        const float* __restrict__ nm,
                                        const float* prices, int n, Cw width,
                                        float eps, unsigned long long* keys,
                                        int* na) {
  const int C = width;
  *na = a;
  if (a >= 0 && a != C) return -1;
  const size_t row = static_cast<size_t>(b) * C;
  Top2 t = row_top2(costs, slots, valid, nm[b], prices, row, width);
  if (t.col == C) {
    if (a < 0) *na = C;
    return -1;
  }
  float v2 = isfinite(t.second) ? t.second : __fsub_rn(t.best, 1.0f);
  float incr = __fadd_rn(__fsub_rn(t.best, v2), eps);
  int tgt = slots[row + t.col];
  float bid = __fadd_rn(ld_state(prices + tgt), incr);
  unsigned long long key =
      (static_cast<unsigned long long>(ordered_bits(bid)) << 32) |
      static_cast<unsigned int>(n - b);
  atomicMax(keys + tgt, key);
  return t.col;
}

// Slot s < S after all bids (auction.py:274-291): the winning key sets the
// new price and owner, and the previous owner is evicted. Resets its key to
// 0, so the key workspace needs no clearing between rounds. Returns whether
// the slot changed hands. newp / new_owner may alias prices / owner.
__device__ __forceinline__ bool resolve_body(int s, int n,
                                             unsigned long long* keys,
                                             const float* prices,
                                             const int* owner, float* newp,
                                             int* new_owner,
                                             int* new_assigned) {
  unsigned long long key = ld_state(keys + s);
  if (key == 0ull) {
    if (newp != prices) {
      newp[s] = ld_state(prices + s);
      new_owner[s] = ld_state(owner + s);
    }
    return false;
  }
  keys[s] = 0ull;
  int w = n - static_cast<int>(key & 0xffffffffull);
  int o = ld_state(owner + s);
  newp[s] = from_ordered(static_cast<unsigned int>(key >> 32));
  new_owner[s] = w;
  if (o >= 0 && o < n && o != w) new_assigned[o] = -1;
  return true;
}

// Bidder b after the evictions: a winner takes the column it bid on (col,
// -1 for none). Returns the bidder's final assignment of the round, given
// its assignment after the evictions (na).
__device__ __forceinline__ int settle_body(int b, int col, int na,
                                           const int* __restrict__ slots,
                                           const int* new_owner, int C,
                                           int* new_assigned) {
  if (col < 0) return na;
  int tgt = slots[static_cast<size_t>(b) * C + col];
  if (ld_state(new_owner + tgt) == b) {
    new_assigned[b] = col;
    return col;
  }
  return na;
}

// The problem a round bids on.
struct RoundProblem {
  const float* costs;    // [n, C]
  const int* slots;      // [n, C], each in [0, S]
  const uint8_t* valid;  // [n, C]
  const float* nm;       // [n]
  int n, C, S;
};

// What a thread's share of the bid phase did: whether any of its bidders bid
// or changed assignment, and how many of them were active.
struct BidShare {
  bool moved;
  unsigned int active;
};

// The bid phase of a round for bidders first, first + stride, ...: each
// active bidder's key goes into keys, its column (-1 for none) into bid_col,
// and its assignment after the no-match choice into new_assigned (InPlace:
// new_assigned is assigned, written only where it changed).
template <bool InPlace>
__device__ __forceinline__ BidShare bid_phase(const RoundProblem& p, int first, int stride,
                                              const float* prices, float eps,
                                              unsigned long long* keys, const int* assigned,
                                              int* new_assigned, int* bid_col) {
  BidShare share{false, 0u};
  at_width(p.C, vector_rows(p.costs, p.slots, p.valid), [&](auto width) {
    const int C = width;
    for (int b = first; b < p.n; b += stride) {
      const int as = ld_state(assigned + b);
      int na;
      const int col = bid_body(b, as, p.costs, p.slots, p.valid, p.nm, prices, p.n, width,
                               eps, keys, &na);
      share.active += (as < 0 || as == C) ? 1u : 0u;
      bid_col[b] = col;
      if (na != as || !InPlace) new_assigned[b] = na;
      share.moved = share.moved || col >= 0 || na != as;
    }
  });
  return share;
}

// The resolve phase for slots first, first + stride, ... up to S (which
// gets price 0 and no owner). Returns how many of them changed hands.
__device__ __forceinline__ unsigned int resolve_phase(int n, int S, int first, int stride,
                                                      unsigned long long* keys,
                                                      const float* prices, const int* owner,
                                                      float* newp, int* new_owner,
                                                      int* new_assigned) {
  unsigned int resolved = 0;
  for (int s = first; s <= S; s += stride) {
    if (s == S) {
      newp[S] = 0.0f;
      new_owner[S] = -1;
    } else if (resolve_body(s, n, keys, prices, owner, newp, new_owner, new_assigned)) {
      ++resolved;
    }
  }
  return resolved;
}

// Launch configuration of `clusters` clusters of the solve's shape.
inline cudaLaunchConfig_t cluster_config(int clusters, cudaStream_t st,
                                         cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kClusterBlocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of the solve's shape the current device holds at once, for the
// one of `kernels` with fewest (queried once per device into `cached`; a
// cluster of more than 8 blocks is allowed first). An error code, or
// cudaErrorLaunchOutOfResources when the device holds none; else 0 with the
// count in *out.
template <int K>
inline int fewest_clusters(const void* const (&kernels)[K], int (&cached)[64], int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  int fewest = 0;
  for (int i = 0; i < K; ++i) {
    if (kClusterBlocks > 8) {
      err = cudaFuncSetAttribute(kernels[i], cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = cluster_config(1, nullptr, &attr);
    int held = 0;
    err = cudaOccupancyMaxActiveClusters(&held, kernels[i], &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    fewest = i == 0 || held < fewest ? held : fewest;
  }
  if (fewest < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  if (dev >= 0 && dev < 64) cached[dev] = fewest;
  *out = fewest;
  return 0;
}

}  // namespace same_auction
