// K1 `auction_bid`: one bidding round of the epsilon-scaling auction.
//
// This single-round launch is the test entry: chip_smoke.py holds it against
// its plain version at the Pallas bench shape and on the LUAD window. The
// main path runs the same __device__ bodies (auction_round.cuh) inside the
// persistent solve of auction_loop.cu, one launch per auction solve.
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
// [n, C] costs (f32), slots (i32) and valid (u8) rows and gathers
// prices[slots] — 9 bytes plus one random 4-byte gather per entry, ~2.6 MB at
// the LUAD window's n = 12288, C = 24, well under 2 us at HBM bandwidth. On
// the TPU the [n, C] price gather alone took 74 % of the round
// (ARCHITECTURE.md:213-221). At this size the launches themselves (three per
// round) cost more than the bytes.
//
// What the design does about it:
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
//     needs no clearing launch between rounds.
//
// Launches: (a) bid, one thread per bidder; (b) resolve, one thread per slot:
// new price, new owner, eviction of the previous owner; (c) settle, one
// thread per bidder: the winners take their column (after the evictions, as
// in the JAX round) and the device-side `moved` flag is raised without a host
// sync. All arithmetic is f32 with explicit round-to-nearest intrinsics, so
// nvcc cannot contract or reorder -(cost + p) or v1 - v2 + eps.

#include "auction_round.cuh"

namespace {

using namespace same_auction;

constexpr int kThreads = 256;

__global__ void bid_kernel(const float* __restrict__ costs,
                           const int* __restrict__ slots,
                           const uint8_t* __restrict__ valid,
                           const float* __restrict__ nm,
                           const float* __restrict__ prices,
                           const int* __restrict__ assigned, int n, int C,
                           float eps, int* __restrict__ new_assigned,
                           int* __restrict__ bid_col,
                           unsigned long long* __restrict__ keys) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int na;
  bid_col[b] = bid_body(b, assigned[b], costs, slots, valid, nm, prices, n, C,
                        eps, keys, &na);
  new_assigned[b] = na;
}

__global__ void resolve_kernel(const float* __restrict__ prices,
                               const int* __restrict__ owner, int n, int S,
                               unsigned long long* __restrict__ keys,
                               float* __restrict__ newp,
                               int* __restrict__ new_owner,
                               int* __restrict__ new_assigned,
                               int* __restrict__ moved) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s == 0) *moved = 0;
  if (s > S) return;
  if (s == S) {
    newp[S] = 0.0f;
    new_owner[S] = -1;
    return;
  }
  resolve_body(s, n, keys, prices, owner, newp, new_owner, new_assigned);
}

__global__ void settle_kernel(const int* __restrict__ slots,
                              const int* __restrict__ assigned,
                              const int* __restrict__ bid_col,
                              const int* __restrict__ new_owner, int n, int C,
                              int* __restrict__ new_assigned,
                              int* __restrict__ moved) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n) return;
  int col = bid_col[b];
  int na = settle_body(b, col, new_assigned[b], slots, new_owner, C,
                       new_assigned);
  // Any bid counts as movement (auction.py:293-295).
  if (col >= 0 || na != assigned[b]) *moved = 1;
}

}  // namespace

extern "C" int same_auction_bid(const float* costs, const int* slots,
                                const uint8_t* valid, const float* nm,
                                const float* prices, const int* assigned,
                                const int* owner, int n, int C, int S,
                                float eps, int* new_assigned, int* new_owner,
                                float* newp, int* moved, int* bid_col,
                                unsigned long long* keys, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int gb = (n + kThreads - 1) / kThreads;
  int gs = (S + 1 + kThreads - 1) / kThreads;
  bid_kernel<<<gb, kThreads, 0, st>>>(costs, slots, valid, nm, prices,
                                      assigned, n, C, eps, new_assigned,
                                      bid_col, keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  resolve_kernel<<<gs, kThreads, 0, st>>>(prices, owner, n, S, keys, newp,
                                          new_owner, new_assigned, moved);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  settle_kernel<<<gb, kThreads, 0, st>>>(slots, assigned, bid_col, new_owner,
                                         n, C, new_assigned, moved);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
