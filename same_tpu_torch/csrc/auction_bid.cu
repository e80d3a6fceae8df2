// K1 `auction_bid`: one bidding round of the epsilon-scaling auction, in ONE
// launch of one thread-block cluster.
//
// This single-round launch is the test entry: chip_smoke.py holds it against
// its plain version at the Pallas bench shape and on the LUAD window. It
// runs the main path's own phase code: the bid and resolve phases and the
// settle body of auction_round.cuh, which the persistent solve of
// auction_loop.cu runs each bidding round, on the same cluster shape.
//
// Replaces
//   - examples/bench_pallas.py:98-139 (`main.kernel`, the repo's only Pallas
//     kernel): masked values, top-2 over C columns plus the no-match column,
//     and the bid increment;
//   - same_tpu/solver/auction.py:256-291 (the XLA bidding round of
//     `_auction_run`): the price gather, the scatter-max of the bids into the
//     prices, the scatter-min tie-break to the smallest bidder, evictions and
//     the new owners.
//
// What bounds it on the H100: bytes, not arithmetic. A round reads the
// [n, C] costs (f32), slots (i32) and valid (u8) rows of the active bidders
// and gathers prices[slots] — 9 bytes plus one random 4-byte gather per
// entry, ~3.3 MB at the LUAD window's n = 12288, C = 24, about 1 us at HBM
// bandwidth. On the TPU the [n, C] price gather alone took 74 % of the
// round (ARCHITECTURE.md:213-221). At this size a launch costs more than the
// bytes, and inside the round the latency of each row's loads and gathers
// and of the barriers between the phases.
//
// What the design does about it:
//   - one launch: one cluster of kClusterBlocks x kThreads threads (the
//     solve's) runs bid | resolve | settle, the phases separated by two
//     hardware cluster barriers; each phase loops cluster-stride over its
//     bidders or slots, so any n and S work;
//   - each active bidder reads its row a chunk of columns at a time, all
//     loads of a chunk first, then its price gathers together (row_top2,
//     with 16-byte loads at C = 24 and 8);
//   - only ACTIVE bidders (unassigned or on no-match) touch their row: late
//     in a solve almost every bidder holds a slot, so a round reads little
//     more than the [n] assignment vector;
//   - the scatter-max and the scatter-min tie-break are ONE 64-bit atomicMax
//     per bid on the key (order-preserving f32 bits of the bid) << 32 |
//     (n - bidder). The largest key carries the highest bid and, among equal
//     bids, the smallest bidder. Keys start at 0, which is below every bid
//     key because the tag n - b >= 1. Every bid is >= the slot's old price
//     (the increment is >= eps > 0 and f32 addition is monotone), so the
//     largest bid IS max(old price, bids) — `prices.at[tgt].max(bid)` — and a
//     bid that rounds to the old price (core.py:366-378) still wins, as
//     `bid >= newp[tgt]` lets it;
//   - the per-slot decode resets its key to 0, so the [S+1] key workspace
//     needs no clearing between rounds;
//   - the `moved` flag stays on the device: zeroed before the first barrier,
//     raised after it by any thread whose bidders bid or changed assignment
//     (an eviction or a win implies a bid, auction.py:293-295).
//
// All arithmetic is f32 with explicit round-to-nearest intrinsics, so nvcc
// cannot contract or reorder -(cost + p) or v1 - v2 + eps.

#include "auction_round.cuh"

namespace {

using namespace same_auction;

struct BidArgs {
  RoundProblem p;
  const float* prices;    // [S+1]
  const int* assigned;    // [n]
  const int* owner;       // [S+1]
  float eps;
  int* new_assigned;      // [n]
  int* new_owner;         // [S+1]
  float* newp;            // [S+1]
  int* moved;             // [1]
  int* bid_col;           // [n] scratch
  unsigned long long* keys;  // [S+1], zero on entry and on exit
};

__global__ void __launch_bounds__(kThreads, 1) auction_bid_kernel(BidArgs a) {
  const int tid = static_cast<int>(blockIdx.x) * kThreads + static_cast<int>(threadIdx.x);
  if (tid == 0) *a.moved = 0;
  const BidShare bid = bid_phase<false>(a.p, tid, kStride, a.prices, a.eps, a.keys,
                                        a.assigned, a.new_assigned, a.bid_col);
  cluster_sync();
  if (bid.moved) *a.moved = 1;
  resolve_phase(a.p.n, a.p.S, tid, kStride, a.keys, a.prices, a.owner, a.newp, a.new_owner,
                a.new_assigned);
  cluster_sync();
  for (int b = tid; b < a.p.n; b += kStride) {
    settle_body(b, a.bid_col[b], ld_state(a.new_assigned + b), a.p.slots, a.new_owner, a.p.C,
                a.new_assigned);
  }
}

// 0 when the current device holds one cluster of the kernel, else an error
// code (fewest_clusters).
int check_cluster() {
  static int cached[64] = {0};
  const void* const kernels[] = {reinterpret_cast<const void*>(auction_bid_kernel)};
  int held = 0;
  return fewest_clusters(kernels, cached, &held);
}

}  // namespace

extern "C" int same_auction_bid(const float* costs, const int* slots,
                                const uint8_t* valid, const float* nm,
                                const float* prices, const int* assigned,
                                const int* owner, int n, int C, int S,
                                float eps, int* new_assigned, int* new_owner,
                                float* newp, int* moved, int* bid_col,
                                unsigned long long* keys, void* stream) {
  const int err = check_cluster();
  if (err != 0) return err;
  BidArgs a;
  a.p = RoundProblem{costs, slots, valid, nm, n, C, S};
  a.prices = prices;
  a.assigned = assigned;
  a.owner = owner;
  a.eps = eps;
  a.new_assigned = new_assigned;
  a.new_owner = new_owner;
  a.newp = newp;
  a.moved = moved;
  a.bid_col = bid_col;
  a.keys = keys;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, auction_bid_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
