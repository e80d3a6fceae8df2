"""K7 ``tear_scalars`` and K8 ``register_cuts``: the rest of a tear round.

Both take [b, ...] stacks of windows (the solo loop passes [1, ...] views)
and launch ``csrc/tear_round.cu`` for CUDA tensors; for CPU tensors they run
their plain PyTorch versions, transcriptions of
``same_tpu/solver/tearing_device.py:146-160`` (``tear_scalars_plain``, the
six values of the stop rule) and ``:209-254`` (``register_cuts_plain``, cut
registration and surcharge).

Two orders are fixed, and kernel and plain version share them:

- the float sums of ``tear_scalars`` add element ``i`` into partial ``i %
  256`` in index order, then the 256 partials in a halving tree
  (:func:`fixed_order_sum`): a window's sums do not depend on the batch or
  on the zero padding of the batched loop's triangles;
- the surcharges of ``register_cuts`` are added in JAX's order, the L
  column passes outer and the cuts in triangle order inner; with a
  non-dyadic ``dp`` two cuts on one (vertex, column) give an
  order-dependent f32 sum, which a scatter with atomics would leave to
  chance.

Each kernel keeps its working set in shared memory up to a capacity (K7's
bitmap of refs hit, K8's list of a round's cuts: :func:`shared_capacity`)
and runs the same code on global scratch, allocated here, beyond it.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build

SUM_PARTIALS = 256  # csrc/tear_round.cu: kSumChains


def fixed_order_sum(x):
    """Sum over the last axis of [b, N] in the kernel's order: element ``i``
    into partial ``i % 256`` in index order, then the partials in a halving
    tree. Returns [b]."""
    b, N = x.shape
    k = -(-N // SUM_PARTIALS)
    padded = x.new_zeros((b, k * SUM_PARTIALS))
    padded[:, :N] = x
    parts = padded.view(b, k, SUM_PARTIALS)
    acc = x.new_zeros((b, SUM_PARTIALS))
    for i in range(k):
        acc = acc + parts[:, i]
    s = SUM_PARTIALS // 2
    while s:
        acc = acc[:, :s] + acc[:, s:2 * s]
        s //= 2
    return acc[:, 0]


def tear_scalars_plain(costs, nm, choice, cand_ref, ref_xy, m_ref, flipped,
                       checked, tri_weights, tri_mask, src, windows=None):
    """Plain version of K7 (same_tpu/solver/tearing_device.py:146-160)."""
    if windows is not None:
        idx = torch.as_tensor(np.asarray(windows, np.int64)).to(costs.device)
        costs, nm, choice, cand_ref, m_ref, flipped, checked, tri_weights, tri_mask, src = (
            t.index_select(0, idx) for t in (costs, nm, choice, cand_ref, m_ref, flipped,
                                             checked, tri_weights, tri_mask, src))
    b, n, C = costs.shape
    dev = costs.device
    col = choice.clamp(0, C - 1).long()[..., None]
    is_match = choice < C
    base = torch.where(is_match, costs.gather(2, col)[..., 0], nm)
    m = m_ref.long()[:, None]
    ref = torch.minimum(cand_ref.gather(2, col)[..., 0].long().clamp_min(0), m - 1)
    ref = torch.where(is_match, ref, 0)
    width = max(int(ref_xy.shape[1]), 1)
    u_ref = torch.zeros(b * width, dtype=torch.float32, device=dev).index_add(
        0, (torch.arange(b, device=dev)[:, None] * width + ref).reshape(-1),
        is_match.to(torch.float32).reshape(-1),
    ).view(b, width)
    over = torch.clamp_min(u_ref - 1.0, 0.0).sum(dim=1)  # integers: exact
    flip_w = torch.where(flipped, tri_weights, 0.0)
    check_w = torch.where(tri_mask & (src != 0), tri_weights, 0.0)
    return torch.stack([
        fixed_order_sum(base), over, fixed_order_sum(flip_w),
        fixed_order_sum(check_w), checked.sum(dim=1).to(torch.float32),
        flipped.sum(dim=1).to(torch.float32),
    ], dim=1)


def _lib():
    lib = _build.load("tear_round")
    if lib.same_tear_scalars.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.same_tear_scalars.restype = i
        lib.same_tear_scalars.argtypes = [p] * 11 + [i] * 5 + [p] * 3
        lib.same_register_cuts.restype = i
        lib.same_register_cuts.argtypes = (
            [p] * 7 + [i, ll] + [i] * 7 + [ll] + [p] * 5 + [i, p, p]
        )
        for f in (lib.same_tear_scalars_shared_words, lib.same_register_cuts_shared_entries):
            f.restype = i
            f.argtypes = []
    return lib


def shared_capacity():
    """(K7's shared bitmap in 32-bit words, K8's shared list in cuts): the
    sizes above which each kernel works on global scratch. Loads the
    library (needs nvcc)."""
    lib = _lib()
    return lib.same_tear_scalars_shared_words(), lib.same_register_cuts_shared_entries()


class _Upload:
    """A small host array copied to a device through one pinned buffer that
    is kept from call to call (one a device). A new fill first waits for
    the event recorded after the previous copy out of the buffer, so a copy
    still in flight is never overwritten."""

    def __init__(self):
        self._lock = threading.Lock()
        self._slots = {}  # device -> [pinned buffer, event after its last copy]

    def __call__(self, arr, dev):
        arr = np.ascontiguousarray(arr)
        dtype = {np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64}[arr.dtype]
        with self._lock:
            slot = self._slots.get(dev)
            if slot is None:
                slot = self._slots[dev] = [None, torch.cuda.Event()]
            slot[1].synchronize()
            if slot[0] is None or slot[0].numel() < arr.nbytes:
                slot[0] = torch.empty(max(arr.nbytes, 512), dtype=torch.uint8, pin_memory=True)
            host = slot[0][:arr.nbytes]
            host.numpy()[:] = arr.reshape(-1).view(np.uint8)
            out = torch.empty(arr.nbytes, dtype=torch.uint8, device=dev)
            out.copy_(host, non_blocking=True)
            slot[1].record(torch.cuda.current_stream(dev))
        return out.view(dtype).view(arr.shape)


_upload_windows = _Upload()  # K7's window list
_upload_ctl = _Upload()  # K8's {register, cuts_added} of a batch


def tear_scalars(costs, nm, choice, cand_ref, ref_xy, m_ref, flipped, checked,
                 tri_weights, tri_mask, src, windows=None):
    """The six f32 values of each window's stop rule, as [b, 6]: base cost,
    congestion overflow, flipped weight, checkable weight, checked and
    flipped counts. K7 on CUDA tensors, the plain version on CPU tensors.

    ``costs`` and ``cand_ref`` [b, n, C], ``nm`` and ``choice`` [b, n],
    ``ref_xy`` [b, m_max, 2] the stacked ref coordinates (only its width is
    read: it sizes the bitmap of refs hit), ``m_ref`` [b] int32 each
    window's own ref count, the triangle tensors [b, T] (padded triangles
    with ``tri_mask`` False and weight 0). ``windows`` (host ints) picks the
    windows to sum, in that order: the result is then [len(windows), 6].
    """
    args = (costs, nm, choice, cand_ref, ref_xy, m_ref, flipped, checked,
            tri_weights, tri_mask, src)
    if costs.device.type == "cpu":
        return tear_scalars_plain(*args, windows=windows)
    if costs.device.type != "cuda":
        raise ValueError(f"tear_scalars: unsupported device {costs.device}")
    dev = costs.device
    b, n, C = costs.shape
    T = flipped.shape[1]
    _build.check_tensors("tear_scalars", dev, (
        ("costs", costs, torch.float32, (b, n, C)),
        ("nm", nm, torch.float32, (b, n)),
        ("choice", choice, torch.int32, (b, n)),
        ("cand_ref", cand_ref, torch.int32, (b, n, C)),
        ("m_ref", m_ref, torch.int32, (b,)),
        ("flipped", flipped, torch.bool, (b, T)),
        ("checked", checked, torch.bool, (b, T)),
        ("tri_weights", tri_weights, torch.float32, (b, T)),
        ("tri_mask", tri_mask, torch.bool, (b, T)),
        ("src", src, torch.int32, (b, T)),
    ))
    if ref_xy.dim() != 3 or ref_xy.shape[0] != b or ref_xy.shape[1] < 1:
        raise ValueError(f"tear_scalars: ref_xy of shape {tuple(ref_xy.shape)} for {b} windows")
    win = None
    nw = b
    if windows is not None:
        sel = np.asarray(windows, np.int64).reshape(-1)
        if sel.size and (sel.min() < 0 or sel.max() >= b):
            raise ValueError(f"tear_scalars: windows {sel} outside [0, {b})")
        nw = sel.size
        if nw:
            win = _upload_windows(sel.astype(np.int32), dev)
    words = -(-int(ref_xy.shape[1]) // 32)
    out = torch.empty((nw, 6), dtype=torch.float32, device=dev)
    if nw == 0:
        return out
    with torch.cuda.device(dev):
        lib = _lib()
        # Beyond the shared bitmap each window gets a row of global scratch.
        on_chip = words <= lib.same_tear_scalars_shared_words()
        seen = None if on_chip else torch.empty((nw, words), dtype=torch.int32, device=dev)
        rc = lib.same_tear_scalars(
            costs.data_ptr(), nm.data_ptr(), choice.data_ptr(), cand_ref.data_ptr(),
            m_ref.data_ptr(), flipped.data_ptr(), checked.data_ptr(),
            tri_weights.data_ptr(), tri_mask.data_ptr(), src.data_ptr(),
            None if win is None else win.data_ptr(), nw, n, C, T, words,
            None if seen is None else seen.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "tear_scalars")
    _build.count_launch(tear_scalars, bitmap="shared" if on_chip else "global")
    return out


tear_scalars.launches = 0
tear_scalars.bitmap = None  # "shared" or "global": where the last launch kept it


def register_cuts_plain(tris, surcharge, choice, pair_idx, flipped, vmove, register,
                        cuts_added, cut_mem, cut_cnt, extra, *, L, K,
                        max_cuts_per_round, max_cuts_total):
    """Plain version of K8 (same_tpu/solver/tearing_device.py:209-254)."""
    b, T, _ = tris.shape
    n, C = extra.shape[1:]
    dev = tris.device
    col = choice.clamp(0, C - 1).long()[..., None]
    match_pair = torch.where(choice < C, pair_idx.gather(2, col)[..., 0], -1)
    tri_pairs = match_pair.gather(1, tris.reshape(b, -1).long()).view(b, T, 3)
    all_matched = (tri_pairs >= 0).all(dim=2)
    is_dup = (cut_mem == tri_pairs[:, :, None, :]).all(dim=3).any(dim=2)
    new_cut = flipped & all_matched & ~is_dup & (cut_cnt < K)
    new_cut &= torch.as_tensor(np.asarray(register, bool)).to(dev)[:, None]
    rank = torch.cumsum(new_cut.to(torch.int64), 1) - 1
    done = torch.as_tensor(np.asarray(cuts_added, np.int64)).to(dev)[:, None]
    new_cut &= (rank < max_cuts_per_round) & (done + rank < max_cuts_total)
    added = new_cut.sum(dim=1).to(torch.int32)
    bi, ti = new_cut.nonzero(as_tuple=True)  # by window, then triangle order
    if not bi.numel():
        return added
    cut_mem[bi, ti, cut_cnt[bi, ti].long()] = tri_pairs[bi, ti]
    cut_cnt += new_cut.to(torch.int32)
    v_t = tris.gather(2, vmove.long()[..., None])[..., 0][bi, ti].long()
    col_t = choice[bi, v_t.clamp(0, n - 1)].clamp(0, C - 1).long()
    blk_t = (col_t // L) * L
    # Unbuffered adds in index order (np.add.at), one column pass after the
    # other: JAX's order, whatever device ``extra`` lies on.
    host = extra if extra.device.type == "cpu" else extra.cpu()
    arr = host.numpy()
    idx = [t.cpu().numpy() for t in (bi, v_t)]
    upd = surcharge[bi, ti].cpu().numpy()
    blk = blk_t.cpu().numpy()
    for s in range(L):
        np.add.at(arr, (idx[0], idx[1], np.clip(blk + s, 0, C - 1)), upd)
    if host is not extra:
        extra.copy_(host)
    return added


def register_cuts(tris, surcharge, choice, pair_idx, flipped, vmove, register,
                  cuts_added, cut_mem, cut_cnt, extra, *, L, K,
                  max_cuts_per_round, max_cuts_total):
    """Cut registration and surcharge of one tear round over [b, ...] stacks:
    K8 on CUDA tensors, the plain version on CPU tensors.

    ``tris`` [b, T, 3] int32, ``surcharge`` [b, T] f32 (dp x weight, or the
    hard penalty), ``choice`` [b, n], ``pair_idx`` [b, n, C], ``flipped`` and
    ``vmove`` [b, T] from K2/K6; ``register`` ([b] bool) and ``cuts_added``
    ([b] int) are host arrays: only windows with ``register`` set take cuts.
    ``cut_mem`` [b, T, K, 3] int32 (-2 = empty), ``cut_cnt`` [b, T] int32 and
    ``extra`` [b, n, C] f32 are written in place. Returns the cuts added per
    window, [b] int32 on the device.
    """
    args = (tris, surcharge, choice, pair_idx, flipped, vmove, register, cuts_added,
            cut_mem, cut_cnt, extra)
    kw = dict(L=L, K=K, max_cuts_per_round=max_cuts_per_round,
              max_cuts_total=max_cuts_total)
    if tris.device.type == "cpu":
        return register_cuts_plain(*args, **kw)
    if tris.device.type != "cuda":
        raise ValueError(f"register_cuts: unsupported device {tris.device}")
    dev = tris.device
    b, T, _ = tris.shape
    n, C = extra.shape[1:]
    _build.check_tensors("register_cuts", dev, (
        ("tris", tris, torch.int32, (b, T, 3)),
        ("surcharge", surcharge, torch.float32, (b, T)),
        ("choice", choice, torch.int32, (b, n)),
        ("pair_idx", pair_idx, torch.int32, (b, n, C)),
        ("flipped", flipped, torch.bool, (b, T)),
        ("vmove", vmove, torch.int8, (b, T)),
        ("cut_mem", cut_mem, torch.int32, (b, T, K, 3)),
        ("cut_cnt", cut_cnt, torch.int32, (b, T)),
        ("extra", extra, torch.float32, (b, n, C)),
    ))
    added = torch.empty(b, dtype=torch.int32, device=dev)
    if b == 0 or T == 0:
        return added.zero_()
    register = np.asarray(register, bool).reshape(b)
    cuts_added = np.asarray(cuts_added, np.int64).reshape(b)
    ctl, reg0, done0 = None, 0, 0
    if b == 1:  # the solo loop: two scalar arguments, no copy
        reg0, done0 = int(register[0]), int(cuts_added[0])
    else:
        ctl = _upload_ctl(np.stack([register.astype(np.int64), cuts_added], axis=1), dev)
    per_round = int(min(max_cuts_per_round, 2**31 - 1))
    # The list holds the most cuts a window can keep, padded to a power of
    # two for the sort.
    key_cap = 1 << (max(min(per_round, T), 1) - 1).bit_length()
    max_total = min(int(max_cuts_total), 2**62)
    with torch.cuda.device(dev):
        lib = _lib()
        on_chip = key_cap <= lib.same_register_cuts_shared_entries()
        keys = vals = None
        if not on_chip:
            keys = torch.empty((b, key_cap), dtype=torch.int64, device=dev)
            vals = torch.empty((b, key_cap), dtype=torch.float32, device=dev)
        rc = lib.same_register_cuts(
            tris.data_ptr(), surcharge.data_ptr(), choice.data_ptr(), pair_idx.data_ptr(),
            flipped.data_ptr(), vmove.data_ptr(), None if ctl is None else ctl.data_ptr(),
            reg0, done0, b, n, C, T, int(L), int(K), per_round, max_total,
            cut_mem.data_ptr(), cut_cnt.data_ptr(), extra.data_ptr(),
            None if keys is None else keys.data_ptr(),
            None if vals is None else vals.data_ptr(), key_cap, added.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _build.check(lib, rc, "register_cuts")
    _build.count_launch(register_cuts, cut_list="shared" if on_chip else "global")
    return added


register_cuts.launches = 0
register_cuts.cut_list = None  # "shared" or "global": where the last launch kept it


def synthetic_round_state(rng, n=40, C=7, T=60, K=2, dp=0.1, hot=12):
    """One synthetic window's tear-round state (numpy arrays) that reaches
    the corners of both kernels: the triangles draw their vertices from the
    first ``hot`` rows, so that many cuts move the same vertex; row 0's
    column block is clamped at C - 1 when L does not divide C; surcharges of
    ``dp`` x weight with a non-dyadic ``dp``; 15 % of the memories full of
    other triples and 15 % holding the current triple. Used by the CPU tests
    and ``chip_smoke.py``."""
    choice = np.where(rng.random(n) < 0.85, rng.integers(0, C, n), C).astype(np.int32)
    choice[0] = C - 1
    pair_idx = (np.arange(n)[:, None] * C + np.arange(C)[None, :]).astype(np.int32)
    cand_ref = rng.integers(0, 30, (n, C)).astype(np.int32)
    tris = np.stack([rng.choice(hot, 3, replace=False) for _ in range(T)]).astype(np.int32)
    tw = rng.uniform(1.0, 50.0, T).astype(np.float32)
    surcharge = (np.float32(dp) * tw).astype(np.float32)
    flipped = rng.random(T) < 0.7
    checked = flipped | (rng.random(T) < 0.5)
    vmove = rng.integers(0, 3, T).astype(np.int8)
    cut_mem = np.full((T, K, 3), -2, np.int32)
    cut_cnt = np.zeros(T, np.int32)
    match_pair = np.where(choice < C, pair_idx[np.arange(n), np.clip(choice, 0, C - 1)], -1)
    for t in range(T):
        u = rng.random()
        if u < 0.15:
            cut_mem[t] = rng.integers(1000, 2000, (K, 3))
            cut_cnt[t] = K
        elif u < 0.3:
            cut_mem[t, 0] = match_pair[tris[t]]
            cut_cnt[t] = 1
    extra = rng.uniform(0.0, 1000.0, (n, C)).astype(np.float32)
    costs = rng.uniform(0.0, 200.0, (n, C)).astype(np.float32)
    nm = np.full(n, 500.0, np.float32)
    return dict(choice=choice, pair_idx=pair_idx, cand_ref=cand_ref, tris=tris, tw=tw,
                surcharge=surcharge, flipped=flipped, checked=checked, vmove=vmove,
                cut_mem=cut_mem, cut_cnt=cut_cnt, extra=extra, costs=costs, nm=nm)


def surcharged_cells(tris, vmove, choice, new, C, L):
    """The (vertex, column) cells of one window that the cuts on triangles
    ``new`` surcharge, one entry a cut and column pass (numpy, [len(new) * L,
    2])."""
    new = np.asarray(new, np.int64)
    v = tris[new, vmove[new]]
    blk = (np.clip(choice[v], 0, C - 1) // L) * L
    cols = np.clip(blk[None, :] + np.arange(L)[:, None], 0, C - 1)
    return np.stack([np.broadcast_to(v, cols.shape).reshape(-1), cols.reshape(-1)], axis=1)
