// Bodies of one bidding round of the epsilon-scaling auction, shared by the
// single-round kernel K1 (auction_bid.cu, the test entry) and the persistent
// solve (auction_loop.cu, the main path).
//
// Each body handles one bidder or one slot. Arrays the round mutates are
// read through ld_state (a load that bypasses L1): inside the persistent
// kernel another block wrote them in the previous phase, and a pointer
// declared const __restrict__ could be read through the non-coherent path.
// Arrays that no phase writes are const __restrict__.
//
// All arithmetic is f32 with explicit round-to-nearest intrinsics, so nvcc
// cannot contract or reorder -(cost + p) or v1 - v2 + eps.

#pragma once

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace same_auction {

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

// Bidder value of column k at the current prices: -(cost + price), or -inf
// for an invalid column.
__device__ __forceinline__ float col_value(const float* __restrict__ costs,
                                           const int* __restrict__ slots,
                                           const uint8_t* __restrict__ valid,
                                           const float* prices, size_t idx) {
  return valid[idx] ? -__fadd_rn(costs[idx], ld_state(prices + slots[idx]))
                    : neg_inf();
}

struct Top2 {
  float best, second;
  int col;  // first column of the best value; C is the no-match column
};

// Top-2 of a bidder's C values plus the no-match value -nm, like
// lax.top_k(vals_all, 2): strict '>' keeps the lower column on ties.
__device__ __forceinline__ Top2 row_top2(const float* __restrict__ costs,
                                         const int* __restrict__ slots,
                                         const uint8_t* __restrict__ valid,
                                         float nm_b, const float* prices,
                                         size_t row, int C) {
  Top2 t{neg_inf(), neg_inf(), 0};
  for (int k = 0; k <= C; ++k) {
    float v = k < C ? col_value(costs, slots, valid, prices, row + k) : -nm_b;
    bool better = v > t.best;
    t.second = better ? t.best : fmaxf(t.second, v);
    t.col = better ? k : t.col;
    t.best = better ? v : t.best;
  }
  return t;
}

// Bid of bidder b, which holds assignment a (same_tpu/solver/auction.py:
// 257-272). Only an active bidder (a < 0 or a == C) reads its row. Returns
// the column it bids on (-1 for none) and stores its assignment after the
// no-match choice in *na. The bid goes into keys[tgt] as ONE 64-bit
// atomicMax on (ordered bits of the bid) << 32 | (n - b): the largest key
// carries the highest bid and, among equal bids, the smallest bidder, which
// is the JAX round's scatter-max followed by its scatter-min tie-break.
__device__ __forceinline__ int bid_body(int b, int a,
                                        const float* __restrict__ costs,
                                        const int* __restrict__ slots,
                                        const uint8_t* __restrict__ valid,
                                        const float* __restrict__ nm,
                                        const float* prices, int n, int C,
                                        float eps, unsigned long long* keys,
                                        int* na) {
  *na = a;
  if (a >= 0 && a != C) return -1;
  const size_t row = static_cast<size_t>(b) * C;
  Top2 t = row_top2(costs, slots, valid, nm[b], prices, row, C);
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

}  // namespace same_auction
