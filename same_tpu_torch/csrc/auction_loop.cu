// `auction_loop`: one whole auction solve (every epsilon phase, the polish
// repeats, the boundary steps and the final placement) in ONE persistent
// cooperative launch; and K5 `auction_loop_batch`: the same solve for each
// window of a batch of same-shape windows ([B, n, C] stacks), in one
// cooperative launch per batch (or a few, when the batch's blocks cannot all
// be co-resident).
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
// count per solve. What bounds a round is the grid-wide barrier between its
// phases, a few us each: three per bidding round, 18 more on a boundary
// round.
//
// What the design does about it:
//   - no host trip: the loop control runs on the card, redundantly in every
//     block from the same global partials, so all blocks leave the loop on the
//     same round without a fourth barrier. The host reads one small stats
//     tensor per solve;
//   - no allocation and no launch per round: the wrapper allocates the
//     working set once per solve; the kernel copies the caller's prices,
//     assignments and owners into it and never writes the inputs;
//   - as few barriers as the semantics allow: bid | resolve | settle, with
//     the control phase after the settle barrier; the `moved` flag and the
//     objective partials are double-buffered by round parity, so the next
//     round may start while a slow block still reads the last one's;
//   - the grid is never larger than the co-resident maximum (queried once,
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs, the smaller of the
//     solo and the batch kernel's) and no larger than the widest phase needs:
//     extra blocks would only add barrier arrivals.
//     Every phase loops grid-stride, so any window size works.
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
//   - the per-round objective is summed in a fixed order (per thread over its
//     grid-stride items, then a shared-memory tree per block, then a tree over
//     the block partials), so the same inputs give the same rounds on every
//     run. The order is not torch's: at obj_patience > 0 a stall decision can
//     flip on the last bit (ROADMAP C6);
//   - f32 control (best_obj - obj_tol and the like) uses __fsub_rn, and the
//     integer rule (it - phase_start) / 3 is on non-negative ints.
//   - the placement is folded into the tail as 4 passes of two phases each,
//     with an atomicMin winner per slot.
//
// K5 runs the same `solve` body on each window's own range of g blocks, g
// being the solo grid of its (n, S): the grid-stride partitions, the barrier
// arrivals and the fixed-order objective sum depend only on (block, g), so
// each window's choice, prices, owners, rounds, phase and polish are those of
// a solo launch on the same inputs. Windows share no barrier: a window that
// finishes early lets its blocks leave, and the windows of a tear loop that
// has stopped are not listed at all. What bounds it is what bounds one solve
// (the barriers), now paid once for the batch rather than once per window.
//
// Memory order: a grid barrier is __syncthreads, a __threadfence and an
// arrival on a global counter by one thread per block, a spin on a volatile
// generation word, a __threadfence and __syncthreads: it is safe only under
// a cooperative launch, which guarantees co-residency. Arrays other blocks
// write are read with ld_state (L1 bypassed) and never through a
// const __restrict__ pointer.

#include "auction_round.cuh"

namespace {

using namespace same_auction;

constexpr int kThreads = 256;

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
  float* partials;            // [2, grid]
  unsigned long long* active;   // [1] bidder-rounds of active bidders
  unsigned long long* resolved; // [1] slot-rounds with a winning bid
  unsigned long long* held;     // [1] rows the boundary releases read
  unsigned long long* unplaced; // [1] bidders unplaced when the loop ends
  unsigned int* bar;          // [2] barrier count and generation
};

// Barrier over the `nblocks` blocks of one solve (the whole grid of a solo
// launch, one window's range of a batched launch).
__device__ __forceinline__ void grid_barrier(unsigned int* bar,
                                             unsigned int nblocks) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == nblocks - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      // A barrier that never opens is a bug: trap (a launch error on the
      // host) after seconds of spinning instead of hanging the card.
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

// Adds each thread's v to a device counter: one atomic per warp. Every
// thread of the block calls it.
__device__ __forceinline__ void count_add(unsigned long long* ctr,
                                          unsigned int v) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0 && v) {
    atomicAdd(ctr, static_cast<unsigned long long>(v));
  }
}

// Fixed-order block sum of one value per thread; the result is valid in
// thread 0.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] = __fadd_rn(red[threadIdx.x], red[threadIdx.x + w]);
    __syncthreads();
  }
  float out = red[0];
  __syncthreads();
  return out;
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
__device__ void boundary_release(const LoopArgs& a, float eps, int tid,
                                 int stride, int nblocks) {
  const int n = a.n, C = a.C, S = a.S;
  unsigned int n_held = 0;
  for (int b = tid; b < n; b += stride) {
    int as = ld_state(a.assigned + b);
    if (as < 0 || as >= C) continue;
    ++n_held;
    const size_t row = static_cast<size_t>(b) * C;
    Top2 t = row_top2(a.costs, a.slots, a.valid, a.nm[b], a.prices, row, C);
    float held = col_value(a.costs, a.slots, a.valid, a.prices, row + as);
    if (held < __fsub_rn(t.best, eps)) {
      a.assigned[b] = -1;
      a.owner[a.slots[row + as]] = -1;
    }
  }
  count_add(a.held, n_held);
  grid_barrier(a.bar, nblocks);
  for (int s = tid; s <= S; s += stride) {
    if (s == S) {
      a.owner[S] = -1;
      a.prices[S] = 0.0f;
    } else if (ld_state(a.owner + s) < 0) {
      a.prices[s] = 0.0f;
    }
  }
  grid_barrier(a.bar, nblocks);
}

// One reverse-auction drain (auction.py:164-237): four phases. A win raises
// the round's moved flag.
__device__ void reverse_once(const LoopArgs& a, float eps, int tid, int stride,
                             int nblocks, int* moved_flag) {
  const int n = a.n, C = a.C, S = a.S, Ps = a.Ps;
  // (1) Per bidder: top-2 at the current prices.
  for (int b = tid; b < n; b += stride) {
    Top2 t = row_top2(a.costs, a.slots, a.valid, a.nm[b], a.prices,
                      static_cast<size_t>(b) * C, C);
    a.top_best[b] = t.best;
    a.top_second[b] = isfinite(t.second) ? t.second : t.best;
    a.top_col[b] = t.col;
  }
  grid_barrier(a.bar, nblocks);
  // (2) Per slot: its best person at exclusive profit; an eligible claim
  // goes into the person's key.
  const float two_eps = __fmul_rn(2.0f, eps);
  for (int s = tid; s < S; s += stride) {
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
  grid_barrier(a.bar, nblocks);
  // (3) Per slot: the person's highest surplus, then smallest slot, wins.
  // The winner moves the person: its old slot is freed, it takes the column.
  bool any = false;
  for (int s = tid; s < S; s += stride) {
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
  grid_barrier(a.bar, nblocks);
  // (4) Per slot: winners take their person at the attract price; freed and
  // unclaimed unowned slots at zero. The winner resets its person's key.
  for (int s = tid; s <= S; s += stride) {
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
  grid_barrier(a.bar, nblocks);
}

// One whole solve on blocks [0, nblocks) of its own (`block` is this block's
// index among them). Every partition of the work and every sum order depends
// only on (block, nblocks), so a window solved inside a batched launch gives
// the same bits as a solo launch with a grid of nblocks.
__device__ __forceinline__ void solve(const LoopArgs& a, int block, int nblocks) {
  __shared__ float red[kThreads];
  __shared__ Control s_ctl;
  const int n = a.n, C = a.C, S = a.S, P = a.P;
  const int tid = block * blockDim.x + threadIdx.x;
  const int stride = nblocks * blockDim.x;

  // Prologue: the working state from the caller's (never written) inputs.
  for (int b = tid; b < n; b += stride) {
    a.assigned[b] = a.assigned0 ? a.assigned0[b] : -1;
    a.pkeys[b] = 0ull;
  }
  for (int s = tid; s <= S; s += stride) {
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
  long long boundary_rounds = 0;
  grid_barrier(a.bar, nblocks);

  while (true) {
    __syncthreads();
    const Control ctl = s_ctl;
    __syncthreads();
    if (!(ctl.phase < P && ctl.it < a.max_rounds)) break;
    const float eps = a.eps_sched[ctl.phase < P - 1 ? ctl.phase : P - 1];
    const int par = ctl.it & 1;
    int* moved_flag = a.moved + par;

    if (ctl.boundary) {
      ++boundary_rounds;
      boundary_release(a, eps, tid, stride, nblocks);
      if (a.slot_rows != nullptr) {
        for (int d = 0; d < 4; ++d) {
          reverse_once(a, eps, tid, stride, nblocks, moved_flag);
        }
      }
    }

    // Bid.
    bool bid_moved = false;
    unsigned int n_active = 0;
    for (int b = tid; b < n; b += stride) {
      int as = ld_state(a.assigned + b);
      int na;
      int col = bid_body(b, as, a.costs, a.slots, a.valid, a.nm, a.prices, n,
                         C, eps, a.keys, &na);
      n_active += (as < 0 || as == C) ? 1u : 0u;
      a.bid_col[b] = col;
      if (na != as) a.assigned[b] = na;
      bid_moved = bid_moved || col >= 0 || na != as;
    }
    if (bid_moved) *moved_flag = 1;
    count_add(a.active, n_active);
    grid_barrier(a.bar, nblocks);

    // Resolve; the next round's flag is zeroed here (its last reader, the
    // control phase of the previous round, is behind the bid barrier).
    if (tid == 0) a.moved[par ^ 1] = 0;
    unsigned int n_resolved = 0;
    for (int s = tid; s <= S; s += stride) {
      if (s == S) {
        a.prices[S] = 0.0f;
        a.owner[S] = -1;
      } else if (resolve_body(s, n, a.keys, a.prices, a.owner, a.prices,
                              a.owner, a.assigned)) {
        ++n_resolved;
      }
    }
    count_add(a.resolved, n_resolved);
    grid_barrier(a.bar, nblocks);

    // Settle, and the placement value of the round's state (unplaced
    // bidders at their reservation cost).
    float obj = 0.0f;
    for (int b = tid; b < n; b += stride) {
      int na = settle_body(b, a.bid_col[b], ld_state(a.assigned + b), a.slots,
                           a.owner, C, a.assigned);
      if (a.obj_patience > 0) {
        float v = (na >= 0 && na < C) ? a.costs[static_cast<size_t>(b) * C + na]
                                      : a.nm[b];
        obj = __fadd_rn(obj, v);
      }
    }
    if (a.obj_patience > 0) {
      float part = block_sum(obj, red);
      if (threadIdx.x == 0) a.partials[par * nblocks + block] = part;
    }
    grid_barrier(a.bar, nblocks);

    // Control, in every block from the same global values.
    float cur_obj = inf;
    if (a.obj_patience > 0) {
      float v = 0.0f;
      for (int k = threadIdx.x; k < nblocks; k += kThreads) {
        v = __fadd_rn(v, ld_state(a.partials + par * nblocks + k));
      }
      cur_obj = block_sum(v, red);
    }
    if (threadIdx.x == 0) {
      Control c = ctl;
      bool moved = ld_state(moved_flag) != 0;
      if (a.trace != nullptr && block == 0) {
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
    for (int b = tid; b < n; b += stride) {
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
    grid_barrier(a.bar, nblocks);
    for (int s = tid; s <= S; s += stride) other[s] = n;
    for (int b = tid; b < n; b += stride) {
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
    grid_barrier(a.bar, nblocks);
  }

  if (tid == 0) {
    const Control c = s_ctl;
    a.stats[0] = c.it;
    a.stats[1] = c.phase;
    a.stats[2] = c.polish;
    a.stats[3] = boundary_rounds;
    a.stats[4] = static_cast<long long>(ld_state(a.active));
    a.stats[5] = nblocks;
    a.stats[6] = static_cast<long long>(ld_state(a.unplaced));
    a.stats[7] = static_cast<long long>(ld_state(a.resolved));
    a.stats[8] = static_cast<long long>(ld_state(a.held));
  }
}

size_t align_up(size_t x) { return (x + 255) & ~static_cast<size_t>(255); }

struct Layout {
  size_t keys, pkeys, active, resolved, held, unplaced, bid_col, top_best, top_second, top_col,
      rev_person, rev_col, rev_price, place_win, moved, partials, bar, total;
};

Layout layout(int n, int S, int grid) {
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
  l.partials = take(sizeof(float) * 2 * grid);
  l.bar = take(sizeof(unsigned int) * 2);
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
  a.bar = reinterpret_cast<unsigned int*>(ws + l.bar);
}

__global__ void __launch_bounds__(kThreads) auction_loop_kernel(LoopArgs a) {
  solve(a, blockIdx.x, gridDim.x);
}

// K5 `auction_loop_batch`: a batch of same-shape windows stacked on a leading
// axis, one cooperative launch. Window windows[k] of the launch owns blocks
// [k * g, (k + 1) * g), g being the solo grid for its (n, S); it has its own
// barrier words, control, moved flags, objective partials and workspace, and
// no barrier spans two windows.
struct BatchArgs {
  LoopArgs base;            // window 0's pointers and the shared sizes
  const int* windows;       // [launch windows] batch index of each range
  const int* max_rounds;    // [B]
  const int* obj_patience;  // [B]
  const float* obj_tol;     // [B]
  const int* warm;          // [B] 1: start from assigned0 / owner0
  char* workspace;          // [B, ws_stride]
  long long ws_stride;
  Layout lay;
  int g;
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
  bind_workspace(a, ba.workspace + w * ba.ws_stride, ba.lay);
  return a;
}

__global__ void __launch_bounds__(kThreads)
auction_loop_batch_kernel(BatchArgs ba) {
  const int k = blockIdx.x / ba.g;
  const LoopArgs a = window_args(ba, ba.windows[k]);
  solve(a, blockIdx.x - k * ba.g, ba.g);
}

// Co-resident grid of `kernel` on the current device, queried once per device
// into `cached`. Returns a CUDA error code (cudaErrorNotSupported when the
// device cannot launch cooperatively).
int max_grid(const void* kernel, int* cached, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && cached[dev] > 0) {
    *out = cached[dev];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (!coop) return static_cast<int>(cudaErrorNotSupported);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  int g = per_sm * sms;
  if (dev >= 0 && dev < 64) cached[dev] = g;
  *out = g;
  return 0;
}

int solo_max_grid(int* out) {
  static int cached[64] = {0};
  return max_grid(reinterpret_cast<const void*>(auction_loop_kernel), cached, out);
}

int batch_max_grid(int* out) {
  static int cached[64] = {0};
  return max_grid(reinterpret_cast<const void*>(auction_loop_batch_kernel), cached, out);
}

// The grid of a window's solve, solo or batched: no wider than its widest
// phase needs, and no wider than the co-resident maximum of either kernel, so
// that a window gets the same g on both paths at every size (the batch kernel
// holds fewer blocks an SM than the solo one).
int grid_for(int n, int S, int* grid) {
  int solo = 0, batch = 0;
  int err = solo_max_grid(&solo);
  if (err != 0) return err;
  err = batch_max_grid(&batch);
  if (err != 0) return err;
  int g = solo < batch ? solo : batch;
  int widest = n > S + 1 ? n : S + 1;
  int need = (widest + kThreads - 1) / kThreads;
  *grid = need < g ? (need > 0 ? need : 1) : g;
  return 0;
}

// Windows of size (n, S) one batched launch can hold: all their blocks must
// be co-resident. At least one, as grid_for never exceeds the batch kernel's
// maximum.
int batch_capacity(int n, int S, int* per_launch, int* grid) {
  int err = grid_for(n, S, grid);
  if (err != 0) return err;
  int cap = 0;
  err = batch_max_grid(&cap);
  if (err != 0) return err;
  *per_launch = cap / *grid;
  return 0;
}

}  // namespace

// Bytes of workspace one solve of this size needs (0 with an error code in
// *err when the device cannot run the kernel). A batched solve takes this
// many bytes per window.
extern "C" long long same_auction_loop_workspace(int n, int S, int* err) {
  int grid = 0;
  *err = grid_for(n, S, &grid);
  if (*err != 0) return 0;
  return static_cast<long long>(layout(n, S, grid).total);
}

// Windows of size (n, S) one batched launch holds (0 with an error code in
// *err); *grid gets the blocks of one window.
extern "C" int same_auction_loop_batch_capacity(int n, int S, int* grid, int* err) {
  int per_launch = 0;
  *err = batch_capacity(n, S, &per_launch, grid);
  return *err != 0 ? 0 : per_launch;
}

extern "C" int same_auction_loop(
    const float* costs, const int* slots, const uint8_t* valid,
    const float* nm, const int* slot_rows, const int* slot_cols, int Ps,
    const float* eps_sched, int P, const float* prices0, const int* assigned0,
    const int* owner0, int n, int C, int S, int max_rounds, int max_polish,
    int obj_patience, float obj_tol, int* assigned, float* prices, int* owner,
    long long* stats, float* trace, void* workspace,
    long long workspace_bytes, void* stream) {
  int grid = 0;
  int err = grid_for(n, S, &grid);
  if (err != 0) return err;
  Layout l = layout(n, S, grid);
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
  bind_workspace(a, static_cast<char*>(workspace), l);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = cudaMemsetAsync(a.bar, 0, 2 * sizeof(unsigned int), st);
  if (e != cudaSuccess) return static_cast<int>(e);
  void* args[] = {&a};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(auction_loop_kernel),
                                  dim3(grid), dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// K5: solves the windows listed in `windows` (device array of n_windows batch
// indices) of a [B, ...] stack, in as many consecutive cooperative launches
// of whole windows as co-residency needs; *launches gets their number. Each
// listed window's choice, prices, owners and stats row are written; the other
// rows of the outputs are not touched. `workspace` holds ws_stride bytes per
// batch window (same_auction_loop_workspace); it is cleared here.
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
  int grid = 0, per_launch = 0;
  int err = batch_capacity(n, S, &per_launch, &grid);
  if (err != 0) return err;
  Layout l = layout(n, S, grid);
  if (ws_stride < static_cast<long long>(l.total)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
  ba.max_rounds = max_rounds;
  ba.obj_patience = obj_patience;
  ba.obj_tol = obj_tol;
  ba.warm = warm;
  ba.workspace = static_cast<char*>(workspace);
  ba.ws_stride = ws_stride;
  ba.lay = l;
  ba.g = grid;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Barrier counts start at 0; the rest of the workspace is initialised by
  // each solve's prologue.
  cudaError_t e = cudaMemsetAsync(workspace, 0, static_cast<size_t>(B) * ws_stride, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int first = 0; first < n_windows; first += per_launch) {
    int count = n_windows - first < per_launch ? n_windows - first : per_launch;
    ba.windows = windows + first;
    void* args[] = {&ba};
    e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(auction_loop_batch_kernel), dim3(count * grid),
        dim3(kThreads), args, 0, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    ++*launches;
  }
  return 0;
}

extern "C" const char* same_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
