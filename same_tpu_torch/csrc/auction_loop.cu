// `auction_loop`: one whole auction solve (every epsilon phase, the polish
// repeats, the boundary steps and the final placement) in ONE persistent
// launch of ONE thread-block cluster; and K5 `auction_loop_batch`: the same
// solve for each window of a batch of same-shape windows ([B, n, C] stacks),
// one cluster a window, all in one launch.
//
// Replaces
//   - examples/bench_pallas.py:122 (the Pallas bid compute, through the
//     shared round bodies of auction_round.cuh, as K1 did);
//   - same_tpu/solver/auction.py:66-442 (`_auction_run`: the lax.while_loop
//     over bidding rounds with its boundary step, 4 reverse drains, phase /
//     polish / stall control and the 4 final placement passes);
//   - K5: that loop vmapped over a window batch, same_tpu/parallel/shard.py:
//     111-131 and same_tpu/solver/tearing_device.py:701-710.
// Its plain version is `auction_loop_plain` (same_tpu_torch/kernels/
// auction_loop.py), the port's Python loop; the control phase below mirrors
// that module's `_control_step` line for line.
//
// What bounds it on the H100: not HBM. A bidding round needs the rows of the
// ACTIVE bidders (C x 13 bytes each: cost, slot id, valid flag and one price
// gather, plus the no-match cost), one read of the [n] assignments and, per
// slot that got a bid, its key, old owner, new price, new owner and the
// winner's assignment: tens of kB at the LUAD window's n = 12288,
// S = 28672, i.e. well under 0.1 us at 3.35 TB/s, and the whole working set
// (~5 MB) stays in the 50 MB L2. The device counters (active bidders,
// resolved slots, rows the boundary releases read) give chip_smoke.py this
// count per solve. What bounds a round is latency: the barrier between its
// phases (three per bidding round, 18 more on a boundary round) and, inside
// the bid, each active bidder's loads of its row and its prices in row_top2
// (issued a chunk of 8 columns at a time, auction_round.cuh). On an H100
// (700 W) the software grid barrier of the cooperative design before this
// one took 1.89 us at 113 blocks, the cluster barrier takes 0.76 us, and
// the bid phase was about half of a round (the kernel's phase_cycles;
// PERF.md, section 5).
//
// What the design does about it:
//   - one cluster a solve: kClusterBlocks blocks of kThreads threads on
//     neighbouring SMs, which synchronise through the cluster's hardware
//     barrier (barrier.cluster.arrive.release / barrier.cluster.wait.acquire):
//     no global atomic, no spin, no cooperative launch. The shape is a
//     constant, chosen on the card with the barrier probe of
//     same_tpu_torch/microbench.py (row (e)) and the solve's time (PERF.md,
//     section 6). At first use the host checks that the card holds one
//     cluster of it (cudaOccupancyMaxActiveClusters) and fails otherwise;
//   - no host trip: the loop control runs on the card, redundantly in every
//     block from the same global partials, so all blocks leave the loop on the
//     same round without a fourth barrier. The host reads one small stats
//     tensor per solve;
//   - no allocation and no launch per round: the wrapper allocates the
//     working set once per solve; the kernel copies the caller's prices,
//     assignments and owners into it and never writes the inputs;
//   - as few barriers as the semantics allow: bid | resolve | settle, with
//     the control phase after the settle barrier; the `moved` flag and the
//     objective partials are double-buffered by round parity;
//   - the working state (keys, prices, owners, assignments) stays in global
//     memory, read through ld_state (L2; the whole set fits there): the round
//     bodies, shared with K1, read it that way. Every phase loops
//     cluster-stride over its rows or slots, so any window size works;
//   - the main path's row widths (C = 24 and 8) get a copy of the loops over
//     rows with C a compile-time constant and 16-byte row loads (at_width);
//   - the bid and resolve phases are auction_round.cuh's, which K1 runs too.
//
// Semantics kept exactly:
//   - the boundary step's person-side conflict (scatter-max on surplus, then
//     scatter-min on slot id) is one 64-bit atomicMax on
//     (ordered surplus bits) << 32 | (S - slot), K1's key trick turned round;
//     its [n+1] person keys are reset in the phase after the one that reads
//     them;
//   - `moved` is any bid, any assignment change or any reverse-drain win
//     (auction.py:293-295); each round's flag is zeroed one round ahead, in a
//     phase no block reads it in;
//   - the per-round objective is summed in one fixed order that depends on
//     the row index only, whatever the cluster's shape (the order of the
//     cooperative design before it, whose grid gave each thread at most one
//     row):
//       1. rows 256c .. 256c+255 form chunk c; leaf i of the chunk is
//          0 + value(row 256c + i), or 0 past the last row; the 256 leaves go
//          into a halving tree (leaf i += leaf i + w for w = 128, 64, ..., 1);
//       2. leaf k of the second level is 0 + P[k] + P[k + 256] + ... in that
//          order over the chunk sums P, zero where there is none; the 256
//          leaves go into the same halving tree.
//     A thread that holds two rows (a window wider than the cluster) sums
//     each in its own chunk, so the order holds. It is not torch's: at
//     obj_patience > 0 a stall decision can flip on the last bit (ROADMAP
//     C6);
//   - f32 control (best_obj - obj_tol and the like) uses __fsub_rn, and the
//     integer rule (it - phase_start) / 3 is on non-negative ints.
//   - the placement is folded into the tail as 4 passes of two phases each,
//     with an atomicMin winner per slot.
//
// K5 runs the same `solve` body on one cluster a window: cluster k of the
// launch solves window windows[k]. The partition of the work depends only on
// the block's rank in its cluster, and the objective's order only on the row
// index, so each window's choice, prices, owners, rounds, phase and polish
// are those of a solo launch on the same inputs. Windows share no barrier:
// when the card cannot hold every window's cluster at once, the later ones
// wait for a free place, in the same launch. The windows of a tear loop that
// has stopped are not listed at all.
//
// Memory order: the cluster barrier's arrive has release and its wait
// acquire semantics at cluster scope, which covers the global memory the
// cluster's blocks share. Every thread of every block reaches every barrier:
// the loops around them depend only on the cluster-uniform control and
// sizes. Arrays other blocks write are read with ld_state (L1 bypassed) and
// never through a const __restrict__ pointer. No block reads another's
// shared memory, so no barrier is needed before the blocks exit.

#include "auction_round.cuh"

namespace {

using namespace same_auction;

// The cluster (kClusterBlocks blocks of kThreads threads a solve) is
// auction_round.cuh's, shared with K1.
// Rows a chunk of the objective sum, and leaves of each of its trees.
constexpr int kChunk = 256;
static_assert(kThreads % kChunk == 0, "a block holds whole chunks");
// Phases of the loop that phase_cycles splits it into, for diagnosis: the
// boundary step, bid, resolve and settle, each up to the exit from its last
// barrier, and the control up to the next round's start.
enum Phase { kBoundary, kBid, kResolve, kSettle, kControl, kPhases };

struct LoopArgs {
  // Read-only problem.
  const float* costs;      // [n, C]
  const int* slots;        // [n, C]
  const uint8_t* valid;    // [n, C]
  const float* nm;         // [n]
  const int* slot_rows;    // [S, Ps] or null
  const int* slot_cols;    // [S, Ps] or null
  const float* eps_sched;  // [P]
  const float* prices0;    // [S+1]
  const int* assigned0;    // [n] or null (all -1)
  const int* owner0;       // [S+1] or null (all -1)
  int n, C, S, Ps, P;
  int max_rounds, max_polish, obj_patience;
  float obj_tol;
  // Outputs (the working state).
  int* assigned;           // [n] -> choice
  float* prices;           // [S+1]
  int* owner;              // [S+1]
  long long* stats;        // [10]
  float* trace;            // [max_rounds, 2] (moved, cur_obj) or null
  long long* phase_cycles; // [kPhases] clock64 cycles a phase, or null
  // Workspace.
  unsigned long long* keys;   // [S+1] bid keys
  unsigned long long* pkeys;  // [n+1] reverse-drain person keys
  int* bid_col;               // [n]
  float* top_best;            // [n]
  float* top_second;          // [n]
  int* top_col;               // [n]
  int* rev_person;            // [S]
  int* rev_col;               // [S]
  float* rev_price;           // [S]
  int* place_win;             // [2, S+1]
  int* moved;                 // [2]
  float* partials;            // [2, chunks(n)] chunk sums of the objective
  unsigned long long* active;   // [1] bidder-rounds of active bidders
  unsigned long long* resolved; // [1] slot-rounds with a winning bid
  unsigned long long* held;     // [1] rows the boundary releases read
  unsigned long long* unplaced; // [1] bidders unplaced when the loop ends
};

__host__ __device__ __forceinline__ int chunks(int n) {
  return (n + kChunk - 1) / kChunk;
}

// Adds each thread's v to a device counter: one atomic per warp. Every
// thread of the block calls it.
__device__ __forceinline__ void count_add(unsigned long long* ctr,
                                          unsigned int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) {
    atomicAdd(ctr, static_cast<unsigned long long>(v));
  }
}

// Halving-tree sum of the 256 leaves of each group of 256 threads (leaf i
// += leaf i + w for w = 128, ..., 1): the result is valid in the group's
// first thread. Every thread of the block calls it.
__device__ __forceinline__ float chunk_sum(float v, float* red) {
  const int i = threadIdx.x & (kChunk - 1);
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kChunk / 2; w >= 32; w >>= 1) {
    if (i < w) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  // The last five steps inside the group's first warp: lane i reads lane
  // i + w, as the shared-memory tree reads leaf i + w.
  v = red[threadIdx.x];
  for (int w = 16; w > 0; w >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, w));
  }
  return v;
}

// Loop control of one bidding round: kernels/auction_loop.py::_control_step.
struct Control {
  int phase, boundary, changed, polish, it, since_obj, phase_start;
  float best_obj, last_stall_best;
};

__device__ __forceinline__ void control_step(Control& c, bool moved,
                                             float cur_obj, int P,
                                             int max_polish, int obj_patience,
                                             float obj_tol) {
  c.changed = c.changed || moved;
  bool obj_improved = cur_obj < __fsub_rn(c.best_obj, obj_tol);
  c.best_obj = cur_obj < c.best_obj ? cur_obj : c.best_obj;
  c.since_obj = obj_improved ? 0 : c.since_obj + 1;
  int window = (c.it - c.phase_start) / 3;
  bool stall = obj_patience > 0 &&
               c.since_obj >= (obj_patience > window ? obj_patience : window);
  bool fixed = !moved;
  bool is_last = c.phase >= P - 1;
  bool fixed_or_stall = fixed || stall;
  bool drain_failed = c.best_obj >= __fsub_rn(c.last_stall_best, obj_tol);
  bool stall_finish =
      stall && is_last && (drain_failed || c.polish >= max_polish);
  bool stall_repeat = stall && is_last && !stall_finish;
  bool repeat_last = fixed && is_last && c.changed &&
                     c.polish < max_polish && !stall;
  bool finish = (fixed && is_last && (!c.changed || c.polish >= max_polish)) ||
                stall_finish;
  bool advance = fixed_or_stall && !is_last;
  c.phase = finish ? P : (advance ? c.phase + 1 : c.phase);
  if (repeat_last || stall_repeat) c.polish += 1;
  c.boundary = fixed_or_stall;
  if (fixed_or_stall) c.changed = 0;
  if (advance || stall_repeat) {
    c.phase_start = c.it + 1;
    c.since_obj = 0;
  }
  if (stall_repeat) c.last_stall_best = c.best_obj;
  c.it += 1;
}

// Release of eps-CS violators and zeroing of unowned prices
// (auction.py:131-147): two phases.
__device__ __forceinline__ void boundary_release(const LoopArgs& a, float eps,
                                                 int tid) {
  const int n = a.n, S = a.S;
  unsigned int n_held = 0;
  at_width(a.C, vector_rows(a.costs, a.slots, a.valid), [&](auto width) {
    const int C = width;
    for (int b = tid; b < n; b += kStride) {
      int as = ld_state(a.assigned + b);
      if (as < 0 || as >= C) continue;
      ++n_held;
      const size_t row = static_cast<size_t>(b) * C;
      Top2 t = row_top2(a.costs, a.slots, a.valid, a.nm[b], a.prices, row, width);
      float held = col_value(a.costs, a.slots, a.valid, a.prices, row + as);
      if (held < __fsub_rn(t.best, eps)) {
        a.assigned[b] = -1;
        a.owner[a.slots[row + as]] = -1;
      }
    }
  });
  count_add(a.held, n_held);
  cluster_sync();
  for (int s = tid; s <= S; s += kStride) {
    if (s == S) {
      a.owner[S] = -1;
      a.prices[S] = 0.0f;
    } else if (ld_state(a.owner + s) < 0) {
      a.prices[s] = 0.0f;
    }
  }
  cluster_sync();
}

// One reverse-auction drain (auction.py:164-237): four phases. A win raises
// the round's moved flag.
__device__ __forceinline__ void reverse_once(const LoopArgs& a, float eps,
                                             int tid, int* moved_flag) {
  const int n = a.n, C = a.C, S = a.S, Ps = a.Ps;
  // (1) Per bidder: top-2 at the current prices.
  at_width(C, vector_rows(a.costs, a.slots, a.valid), [&](auto width) {
    const int W = width;
    for (int b = tid; b < n; b += kStride) {
      Top2 t = row_top2(a.costs, a.slots, a.valid, a.nm[b], a.prices,
                        static_cast<size_t>(b) * W, width);
      a.top_best[b] = t.best;
      a.top_second[b] = isfinite(t.second) ? t.second : t.best;
      a.top_col[b] = t.col;
    }
  });
  cluster_sync();
  // (2) Per slot: its best person at exclusive profit; an eligible claim
  // goes into the person's key.
  const float two_eps = __fmul_rn(2.0f, eps);
  for (int s = tid; s < S; s += kStride) {
    const size_t base = static_cast<size_t>(s) * Ps;
    float ms = neg_inf();
    int arg = 0;
    for (int p = 0; p < Ps; ++p) {
      int r = a.slot_rows[base + p];
      int c = a.slot_cols[base + p];
      float surplus = neg_inf();
      if (r >= 0) {
        bool is_best = ld_state(a.top_col + r) == c;
        float pi = is_best ? ld_state(a.top_second + r) : ld_state(a.top_best + r);
        surplus = __fsub_rn(-a.costs[static_cast<size_t>(r) * C + c], pi);
      }
      // Strict '>' keeps the first maximum, like argmax.
      if (surplus > ms) {
        ms = surplus;
        arg = p;
      }
    }
    int person = Ps > 0 ? a.slot_rows[base + arg] : -1;
    bool eligible = ld_state(a.owner + s) < 0 && person >= 0 && ms > 0.0f;
    if (eligible) {
      float pn = __fsub_rn(ms, two_eps);
      a.rev_price[s] = pn < 0.0f ? 0.0f : pn;
      a.rev_col[s] = a.slot_cols[base + arg];
      unsigned long long key =
          (static_cast<unsigned long long>(ordered_bits(ms)) << 32) |
          static_cast<unsigned int>(S - s);
      atomicMax(a.pkeys + person, key);
    }
    a.rev_person[s] = eligible ? person : -1;
  }
  cluster_sync();
  // (3) Per slot: the person's highest surplus, then smallest slot, wins.
  // The winner moves the person: its old slot is freed, it takes the column.
  bool any = false;
  for (int s = tid; s < S; s += kStride) {
    int person = a.rev_person[s];
    if (person < 0) continue;
    unsigned long long key = ld_state(a.pkeys + person);
    if (S - static_cast<int>(key & 0xffffffffull) != s) {
      a.rev_person[s] = -1;
      continue;
    }
    any = true;
    int as = ld_state(a.assigned + person);
    if (as >= 0 && as < C) {
      a.owner[a.slots[static_cast<size_t>(person) * C + as]] = -1;
    }
    a.assigned[person] = a.rev_col[s];
  }
  if (any) *moved_flag = 1;
  cluster_sync();
  // (4) Per slot: winners take their person at the attract price; freed and
  // unclaimed unowned slots at zero. The winner resets its person's key.
  for (int s = tid; s <= S; s += kStride) {
    if (s == S) {
      a.prices[S] = 0.0f;
      a.owner[S] = -1;
      continue;
    }
    int person = a.rev_person[s];
    if (person >= 0) {
      a.owner[s] = person;
      a.prices[s] = a.rev_price[s];
      a.pkeys[person] = 0ull;
    } else if (ld_state(a.owner + s) < 0) {
      a.prices[s] = 0.0f;
    }
  }
  cluster_sync();
}

// One whole solve by the cluster whose block of rank `rank` this is.
__device__ __forceinline__ void solve(const LoopArgs& a, int rank) {
  __shared__ float red[kThreads];
  __shared__ Control s_ctl;
  __shared__ long long s_cycles[kPhases];
  const int n = a.n, C = a.C, S = a.S, P = a.P;
  const int n_chunks = chunks(n);
  const int tid = rank * kThreads + threadIdx.x;
  // With phase_cycles, the first thread of the cluster adds the cycles since
  // the last mark to a phase's count at each mark (after a barrier).
  const bool timed = a.phase_cycles != nullptr && tid == 0;
  long long mark = 0;
  auto lap = [&](int phase) {
    if (timed) {
      const long long now = clock64();
      s_cycles[phase] += now - mark;
      mark = now;
    }
  };

  // Prologue: the working state from the caller's (never written) inputs.
  for (int b = tid; b < n; b += kStride) {
    a.assigned[b] = a.assigned0 ? a.assigned0[b] : -1;
    a.pkeys[b] = 0ull;
  }
  for (int s = tid; s <= S; s += kStride) {
    a.prices[s] = a.prices0[s];
    a.owner[s] = a.owner0 ? a.owner0[s] : -1;
    a.keys[s] = 0ull;
    a.place_win[s] = n;
    a.place_win[S + 1 + s] = n;
  }
  if (tid == 0) {
    a.pkeys[n] = 0ull;
    a.moved[0] = 0;
    a.moved[1] = 0;
    *a.active = 0ull;
    *a.resolved = 0ull;
    *a.held = 0ull;
    *a.unplaced = 0ull;
  }
  const float inf = __int_as_float(0x7f800000);
  if (threadIdx.x == 0) {
    s_ctl = Control{0, 1, 0, 0, 0, 0, 0, inf, inf};
  }
  if (timed) {
    for (int k = 0; k < kPhases; ++k) s_cycles[k] = 0;
  }
  long long boundary_rounds = 0;
  cluster_sync();
  if (timed) mark = clock64();

  while (true) {
    __syncthreads();
    const Control ctl = s_ctl;
    __syncthreads();
    if (ctl.it > 0) lap(kControl);
    if (!(ctl.phase < P && ctl.it < a.max_rounds)) break;
    const float eps = a.eps_sched[ctl.phase < P - 1 ? ctl.phase : P - 1];
    const int par = ctl.it & 1;
    int* moved_flag = a.moved + par;
    float* partials = a.partials + par * n_chunks;

    if (ctl.boundary) {
      ++boundary_rounds;
      boundary_release(a, eps, tid);
      if (a.slot_rows != nullptr) {
        for (int d = 0; d < 4; ++d) {
          reverse_once(a, eps, tid, moved_flag);
        }
      }
      lap(kBoundary);
    }

    // Bid, in place on the working state.
    const BidShare bid = bid_phase<true>(RoundProblem{a.costs, a.slots, a.valid, a.nm, n, C, S},
                                         tid, kStride, a.prices, eps, a.keys, a.assigned,
                                         a.assigned, a.bid_col);
    if (bid.moved) *moved_flag = 1;
    count_add(a.active, bid.active);
    cluster_sync();
    lap(kBid);

    // Resolve; the next round's flag is zeroed here (its last reader, the
    // control phase of the previous round, is behind the bid barrier).
    if (tid == 0) a.moved[par ^ 1] = 0;
    count_add(a.resolved, resolve_phase(n, S, tid, kStride, a.keys, a.prices, a.owner,
                                        a.prices, a.owner, a.assigned));
    cluster_sync();
    lap(kResolve);

    // Settle, and the placement value of the round's state (unplaced
    // bidders at their reservation cost): each chunk's sum into partials.
    // The pass loop is uniform over the cluster, as chunk_sum needs.
    for (int base = 0; base < n; base += kStride) {
      const int b = base + tid;
      float leaf = 0.0f;
      if (b < n) {
        int na = settle_body(b, a.bid_col[b], ld_state(a.assigned + b), a.slots,
                             a.owner, C, a.assigned);
        if (a.obj_patience > 0) {
          float v = (na >= 0 && na < C) ? a.costs[static_cast<size_t>(b) * C + na]
                                        : a.nm[b];
          leaf = __fadd_rn(0.0f, v);
        }
      }
      if (a.obj_patience > 0) {
        float part = chunk_sum(leaf, red);
        const int c = b / kChunk;
        if ((threadIdx.x & (kChunk - 1)) == 0 && c < n_chunks) partials[c] = part;
      }
    }
    cluster_sync();
    lap(kSettle);

    // Control, in every block from the same global values: the chunk sums'
    // tree in the block's first 256 threads. The flag's load is issued
    // first, so that its latency hides behind the tree's.
    const bool moved = threadIdx.x == 0 && ld_state(moved_flag) != 0;
    float cur_obj = inf;
    if (a.obj_patience > 0) {
      float v = 0.0f;
      if (threadIdx.x < kChunk) {
        for (int c = threadIdx.x; c < n_chunks; c += kChunk) {
          v = __fadd_rn(v, ld_state(partials + c));
        }
      }
      cur_obj = chunk_sum(v, red);
    }
    if (threadIdx.x == 0) {
      // The control state read again (only this thread writes it, below):
      // the round's copy would stay live in registers across its phases.
      Control c = s_ctl;
      if (a.trace != nullptr && rank == 0) {
        a.trace[2 * c.it] = moved ? 1.0f : 0.0f;
        a.trace[2 * c.it + 1] = cur_obj;
      }
      control_step(c, moved, cur_obj, P, a.max_polish, a.obj_patience,
                   a.obj_tol);
      s_ctl = c;
    }
  }

  // Final placement (auction.py:405-438): 4 passes, then the rest to
  // no-match. Pass k's winners sit in place_win[k & 1]; the other buffer is
  // reset in the same phase (its last reader was the previous pass).
  unsigned int n_unplaced = 0;
  for (int k = 0; k < 4; ++k) {
    int* win = a.place_win + (k & 1) * (S + 1);
    int* other = a.place_win + ((k & 1) ^ 1) * (S + 1);
    for (int b = tid; b < n; b += kStride) {
      int col = -1;
      if (ld_state(a.assigned + b) < 0) {
        if (k == 0) ++n_unplaced;
        const size_t row = static_cast<size_t>(b) * C;
        float best = neg_inf();
        int bc = 0;
        for (int j = 0; j < C; ++j) {
          float v = neg_inf();
          if (a.valid[row + j] && ld_state(a.owner + a.slots[row + j]) < 0) {
            v = -__fadd_rn(a.costs[row + j], ld_state(a.prices + a.slots[row + j]));
          }
          if (v > best) {
            best = v;
            bc = j;
          }
        }
        bool take_nm = (-a.nm[b] >= best) || !isfinite(best);
        col = take_nm ? C : bc;
        if (!take_nm) atomicMin(win + a.slots[row + bc], b);
      }
      a.bid_col[b] = col;
    }
    cluster_sync();
    for (int s = tid; s <= S; s += kStride) other[s] = n;
    for (int b = tid; b < n; b += kStride) {
      int col = a.bid_col[b];
      if (col == C) {
        a.assigned[b] = C;
      } else if (col >= 0) {
        int tgt = a.slots[static_cast<size_t>(b) * C + col];
        if (ld_state(win + tgt) == b) {
          a.assigned[b] = col;
          a.owner[tgt] = b;
        }
      }
      if (k == 3 && ld_state(a.assigned + b) < 0) a.assigned[b] = C;
    }
    if (tid == 0) a.owner[S] = -1;
    if (k == 0) count_add(a.unplaced, n_unplaced);
    cluster_sync();
  }

  if (tid == 0) {
    const Control c = s_ctl;
    a.stats[0] = c.it;
    a.stats[1] = c.phase;
    a.stats[2] = c.polish;
    a.stats[3] = boundary_rounds;
    a.stats[4] = static_cast<long long>(ld_state(a.active));
    a.stats[5] = kClusterBlocks;
    a.stats[6] = static_cast<long long>(ld_state(a.unplaced));
    a.stats[7] = static_cast<long long>(ld_state(a.resolved));
    a.stats[8] = static_cast<long long>(ld_state(a.held));
    if (timed) {
      for (int k = 0; k < kPhases; ++k) a.phase_cycles[k] = s_cycles[k];
    }
  }
}

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

struct Layout {
  size_t keys, pkeys, active, resolved, held, unplaced, bid_col, top_best, top_second, top_col,
      rev_person, rev_col, rev_price, place_win, moved, partials, total;
};

Layout layout(int n, int S) {
  Layout l{};
  size_t off = 0;
  auto take = [&](size_t bytes) {
    size_t at = off;
    off = align_up(off + bytes);
    return at;
  };
  l.keys = take(sizeof(unsigned long long) * (S + 1));
  l.pkeys = take(sizeof(unsigned long long) * (n + 1));
  l.active = take(sizeof(unsigned long long));
  l.resolved = take(sizeof(unsigned long long));
  l.held = take(sizeof(unsigned long long));
  l.unplaced = take(sizeof(unsigned long long));
  l.bid_col = take(sizeof(int) * n);
  l.top_best = take(sizeof(float) * n);
  l.top_second = take(sizeof(float) * n);
  l.top_col = take(sizeof(int) * n);
  l.rev_person = take(sizeof(int) * S);
  l.rev_col = take(sizeof(int) * S);
  l.rev_price = take(sizeof(float) * S);
  l.place_win = take(sizeof(int) * 2 * (S + 1));
  l.moved = take(sizeof(int) * 2);
  l.partials = take(sizeof(float) * 2 * chunks(n));
  l.total = off;
  return l;
}

// Points the workspace fields of `a` into one solve's workspace `ws`.
__host__ __device__ void bind_workspace(LoopArgs& a, char* ws, const Layout& l) {
  a.keys = reinterpret_cast<unsigned long long*>(ws + l.keys);
  a.pkeys = reinterpret_cast<unsigned long long*>(ws + l.pkeys);
  a.active = reinterpret_cast<unsigned long long*>(ws + l.active);
  a.resolved = reinterpret_cast<unsigned long long*>(ws + l.resolved);
  a.held = reinterpret_cast<unsigned long long*>(ws + l.held);
  a.unplaced = reinterpret_cast<unsigned long long*>(ws + l.unplaced);
  a.bid_col = reinterpret_cast<int*>(ws + l.bid_col);
  a.top_best = reinterpret_cast<float*>(ws + l.top_best);
  a.top_second = reinterpret_cast<float*>(ws + l.top_second);
  a.top_col = reinterpret_cast<int*>(ws + l.top_col);
  a.rev_person = reinterpret_cast<int*>(ws + l.rev_person);
  a.rev_col = reinterpret_cast<int*>(ws + l.rev_col);
  a.rev_price = reinterpret_cast<float*>(ws + l.rev_price);
  a.place_win = reinterpret_cast<int*>(ws + l.place_win);
  a.moved = reinterpret_cast<int*>(ws + l.moved);
  a.partials = reinterpret_cast<float*>(ws + l.partials);
}

__global__ void __launch_bounds__(kThreads, 1) auction_loop_kernel(LoopArgs a) {
  solve(a, static_cast<int>(blockIdx.x));
}

// K5 `auction_loop_batch`: a batch of same-shape windows stacked on a leading
// axis, one launch. Cluster k of the launch solves window windows[k], with
// its own control, moved flags, objective partials and workspace.
struct BatchArgs {
  LoopArgs base;            // window 0's pointers and the shared sizes
  const int* windows;       // [launch windows] batch index of each cluster
  const int* max_rounds;    // [B]
  const int* obj_patience;  // [B]
  const float* obj_tol;     // [B]
  const int* warm;          // [B] 1: start from assigned0 / owner0
  char* workspace;          // [B, ws_stride]
  long long ws_stride;
  Layout lay;
};

__device__ LoopArgs window_args(const BatchArgs& ba, int w) {
  LoopArgs a = ba.base;
  const size_t n = a.n, nC = static_cast<size_t>(a.n) * a.C,
               S1 = static_cast<size_t>(a.S) + 1,
               SP = static_cast<size_t>(a.S) * a.Ps;
  a.costs += w * nC;
  a.slots += w * nC;
  a.valid += w * nC;
  a.nm += w * n;
  if (a.slot_rows != nullptr) {
    a.slot_rows += w * SP;
    a.slot_cols += w * SP;
  }
  a.eps_sched += static_cast<size_t>(w) * a.P;
  a.prices0 += w * S1;
  const bool warm = ba.warm[w] != 0;
  a.assigned0 = warm ? a.assigned0 + w * n : nullptr;
  a.owner0 = warm ? a.owner0 + w * S1 : nullptr;
  a.max_rounds = ba.max_rounds[w];
  a.obj_patience = ba.obj_patience[w];
  a.obj_tol = ba.obj_tol[w];
  a.assigned += w * n;
  a.prices += w * S1;
  a.owner += w * S1;
  a.stats += static_cast<size_t>(w) * 10;
  a.trace = nullptr;
  a.phase_cycles = nullptr;
  bind_workspace(a, ba.workspace + w * ba.ws_stride, ba.lay);
  return a;
}

__global__ void __launch_bounds__(kThreads, 1)
auction_loop_batch_kernel(BatchArgs ba) {
  // The window's arguments once a block, in shared memory rather than in
  // registers.
  __shared__ LoopArgs s_args;
  const int k = static_cast<int>(blockIdx.x) / kClusterBlocks;
  if (threadIdx.x == 0) s_args = window_args(ba, ba.windows[k]);
  __syncthreads();
  solve(s_args, static_cast<int>(blockIdx.x) - k * kClusterBlocks);
}

// Clusters of the solve's shape the current device holds at once, for the
// kernel with fewer (fewest_clusters).
int max_clusters(int* out) {
  static int cached[64] = {0};
  const void* const kernels[] = {reinterpret_cast<const void*>(auction_loop_kernel),
                                 reinterpret_cast<const void*>(auction_loop_batch_kernel)};
  return fewest_clusters(kernels, cached, out);
}

}  // namespace

// Bytes of workspace one solve of this size needs (0 with an error code in
// *err when the device cannot hold one cluster of the solve's shape). A
// batched solve takes this many bytes per window.
extern "C" long long same_auction_loop_workspace(int n, int S, int* err) {
  int held = 0;
  *err = max_clusters(&held);
  if (*err != 0) return 0;
  return static_cast<long long>(layout(n, S).total);
}

// Clusters of the solve's shape the device holds at once (0 with an error
// code in *err); *blocks and *threads get the shape.
extern "C" int same_auction_loop_clusters(int* blocks, int* threads, int* err) {
  int held = 0;
  *blocks = kClusterBlocks;
  *threads = kThreads;
  *err = max_clusters(&held);
  return *err != 0 ? 0 : held;
}

extern "C" int same_auction_loop(
    const float* costs, const int* slots, const uint8_t* valid,
    const float* nm, const int* slot_rows, const int* slot_cols, int Ps,
    const float* eps_sched, int P, const float* prices0, const int* assigned0,
    const int* owner0, int n, int C, int S, int max_rounds, int max_polish,
    int obj_patience, float obj_tol, int* assigned, float* prices, int* owner,
    long long* stats, float* trace, long long* phase_cycles, void* workspace,
    long long workspace_bytes, void* stream) {
  int held = 0;
  int err = max_clusters(&held);
  if (err != 0) return err;
  Layout l = layout(n, S);
  if (workspace_bytes < static_cast<long long>(l.total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  LoopArgs a;
  a.costs = costs;
  a.slots = slots;
  a.valid = valid;
  a.nm = nm;
  a.slot_rows = slot_rows;
  a.slot_cols = slot_cols;
  a.eps_sched = eps_sched;
  a.prices0 = prices0;
  a.assigned0 = assigned0;
  a.owner0 = owner0;
  a.n = n;
  a.C = C;
  a.S = S;
  a.Ps = Ps;
  a.P = P;
  a.max_rounds = max_rounds;
  a.max_polish = max_polish;
  a.obj_patience = obj_patience;
  a.obj_tol = obj_tol;
  a.assigned = assigned;
  a.prices = prices;
  a.owner = owner;
  a.stats = stats;
  a.trace = trace;
  a.phase_cycles = phase_cycles;
  bind_workspace(a, static_cast<char*>(workspace), l);
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg = cluster_config(1, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, auction_loop_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K5: solves the windows listed in `windows` (device array of n_windows batch
// indices) of a [B, ...] stack in one launch of n_windows clusters; *launches
// gets 1 (0 for an empty list). Each listed window's choice, prices, owners
// and stats row are written; the other rows of the outputs are not touched.
// `workspace` holds ws_stride bytes per batch window
// (same_auction_loop_workspace); each solve's prologue initialises its own.
extern "C" int same_auction_loop_batch(
    const float* costs, const int* slots, const uint8_t* valid,
    const float* nm, const int* slot_rows, const int* slot_cols, int Ps,
    const float* eps_sched, int P, const float* prices0, const int* assigned0,
    const int* owner0, const int* warm, int B, int n, int C, int S,
    const int* max_rounds, int max_polish, const int* obj_patience,
    const float* obj_tol, const int* windows, int n_windows, int* assigned,
    float* prices, int* owner, long long* stats, void* workspace,
    long long ws_stride, void* stream, int* launches) {
  *launches = 0;
  int held = 0;
  int err = max_clusters(&held);
  if (err != 0) return err;
  Layout l = layout(n, S);
  if (ws_stride < static_cast<long long>(l.total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_windows == 0) return 0;
  BatchArgs ba;
  ba.base.costs = costs;
  ba.base.slots = slots;
  ba.base.valid = valid;
  ba.base.nm = nm;
  ba.base.slot_rows = slot_rows;
  ba.base.slot_cols = slot_cols;
  ba.base.eps_sched = eps_sched;
  ba.base.prices0 = prices0;
  ba.base.assigned0 = assigned0;
  ba.base.owner0 = owner0;
  ba.base.n = n;
  ba.base.C = C;
  ba.base.S = S;
  ba.base.Ps = Ps;
  ba.base.P = P;
  ba.base.max_rounds = 0;
  ba.base.max_polish = max_polish;
  ba.base.obj_patience = 0;
  ba.base.obj_tol = 0.0f;
  ba.base.assigned = assigned;
  ba.base.prices = prices;
  ba.base.owner = owner;
  ba.base.stats = stats;
  ba.base.trace = nullptr;
  ba.base.phase_cycles = nullptr;
  ba.windows = windows;
  ba.max_rounds = max_rounds;
  ba.obj_patience = obj_patience;
  ba.obj_tol = obj_tol;
  ba.warm = warm;
  ba.workspace = static_cast<char*>(workspace);
  ba.ws_stride = ws_stride;
  ba.lay = l;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg =
      cluster_config(n_windows, static_cast<cudaStream_t>(stream), &attr);
  cudaError_t e = cudaLaunchKernelEx(&cfg, auction_loop_batch_kernel, ba);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  *launches = 1;
  return 0;
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
