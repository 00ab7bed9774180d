"""Per-row candidates from match slots: kernels B3, B4 and B5.

Port of metacache_tpu/ops/candidates_pallas.py.

Packed slots (sort_pallas_packed, candidates_pallas_packed): int32
pk = (tgt << pack_bits) | win with I32_MAX padding; the caller
guarantees 2^pack_bits > 2 * max window and mwir <= 2^(pack_bits-1),
so one compare pe >= pk - (mwir - 1) tests target and window range.
``sort_packed`` (B3) sorts each row ascending; ``candidates_packed``
pads rows to a power of two and runs B4, which sorts each row itself
before its sweep + top-k (JAX's split=False), or, with ``split`` (B3
first) or ``sorted_input``, sweeps rows that arrive sorted.

Unpacked slots (candidates_pallas), for databases whose slots do not
pack into int32: ``candidates_unpacked`` (B5) sorts each row by
(tgt, win), padding (I32_MAX, I32_MAX) last, and runs the same sweep +
top-k with the target and window tests kept apart.

Rows wider than one block's shared memory holds (MAX_CAND_L2 packed
slots, MAX_UNPACKED_L2 pairs: long reads) take B4's and B5's wide form
(csrc/candidates_wide.cu): tiles of one block's rows sorted in shared
memory, then, by the row's shape (``wide_route``), either one launch of
a thread block cluster a row that merges and sweeps the tiles in
distributed shared memory (up to MAX_CLUSTER tiles), or merge passes in
device memory, a sweep per tile with a top k per tile and the row's top
k from the tiles' picks (wider rows); the same function, with int64
keys where the one-block kernels' int32 keys could overflow. The plain
versions keep their keys in int64, which equals the int32 keys wherever
those cannot overflow (L2 <= 32,768).

CUDA tensors launch the kernels (csrc/candidates.cu,
csrc/candidates_unpacked.cu, csrc/candidates_wide.cu); CPU tensors take
the plain versions below.
"""
from __future__ import annotations

import torch

from .. import kernels

I32_MAX = 2**31 - 1
MAX_SORT_L2 = 32768
MAX_CAND_L2 = 32768      # csrc/candidates.cu: one row array, u16 run starts
MAX_UNPACKED_L2 = 16384   # csrc/candidates_unpacked.cu: 12.5 B/slot of smem
MAX_WIDE_L2 = 1 << 24     # csrc/candidates_wide.cu: i32 lane numbers
MAX_CLUSTER = 8           # csrc/candidates_wide.cu: tiles a cluster route row


def padded_width(l: int) -> int:
    """Row width the kernels take: max(128, next power of two)."""
    return 1 << max(int(l - 1).bit_length(), 7)


def _check(t: torch.Tensor, name: str, ndim: int):
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise ValueError(f"{name} must be an int32 tensor of {ndim} dims")


def sort_packed_plain(pk: torch.Tensor, presorted: int = 0) -> torch.Tensor:
    """Plain version of B3: the ascending per-row sort. The result does
    not depend on ``presorted``, which only lets the kernel skip phases
    of input that already holds alternating sorted runs."""
    return torch.sort(pk, dim=1).values


def sort_packed(pk: torch.Tensor, presorted: int = 0) -> torch.Tensor:
    """(B, L2) int32 slots, L2 a power of two >= 128 -> rows sorted
    ascending (B3). ``presorted=r`` asserts alternating asc/desc sorted
    runs of r lanes."""
    _check(pk, "pk", 2)
    b, l2 = pk.shape
    if l2 != padded_width(l2):
        raise ValueError(f"row width {l2} is not a power of two >= 128")
    if presorted and (presorted & (presorted - 1) or l2 % presorted):
        raise ValueError(f"presorted={presorted} must be a power of two "
                         f"dividing {l2}")
    if not pk.is_cuda:
        return sort_packed_plain(pk, presorted)
    if l2 > MAX_SORT_L2:
        raise ValueError(
            f"rows of {l2} > {MAX_SORT_L2} slots do not fit the sort "
            "kernel's shared memory (candidates_packed sorts them in its "
            "wide form)")
    pk = pk.contiguous()
    if pk.data_ptr() % 16:              # the kernel loads 16 bytes a lane
        pk = pk.clone()
    out = torch.empty_like(pk)
    if b:
        kernels.SORT(pk.data_ptr(), out.data_ptr(), b, l2, presorted)
    return out


def wide_route(l2: int, pairs: bool) -> str:
    """The route of B4's (packed) or B5's (pairs) wide form for rows of
    l2 lanes, by shape alone (csrc/candidates_wide.cu::cluster_route):
    "cluster" for rows of up to MAX_CLUSTER sort tiles (one cluster
    launch, no work space), "passes" for wider ones."""
    tile = MAX_UNPACKED_L2 if pairs else MAX_CAND_L2
    if not tile < l2 <= MAX_WIDE_L2:
        raise ValueError(f"rows of {l2} slots do not take the wide form")
    return "cluster" if l2 // tile <= MAX_CLUSTER else "passes"


def _wide(kernel, slots, mwir, l2: int, presorted: int, extra, walk: int,
          dedup_walk: int, kk: int) -> torch.Tensor:
    """B4's or B5's wide form on CUDA rows of l2 > one block's lanes:
    ``slots`` (pk,) or (tgt, win), ``extra`` the kernel's arguments after
    ``presorted`` and before the sweep's. -> (B, K, 4) int32."""
    b = slots[0].shape[0]
    pairs = len(slots) == 2
    route = wide_route(l2, pairs)
    # its tile sort takes the rows of the one-block kernels
    tile = MAX_UNPACKED_L2 if pairs else MAX_CAND_L2
    if presorted not in (0, l2) and presorted > tile // 2:
        raise ValueError(f"presorted={presorted} runs must fit half a "
                         f"sort tile of {tile} lanes")
    slots = [x.contiguous() for x in slots]
    dev = slots[0].device
    res = torch.empty((b, kk, 4), dtype=torch.int32, device=dev)
    if b:
        work = None
        if route == "passes":
            work = torch.empty(kernels.wide_work_bytes(b, l2, pairs, kk),
                               dtype=torch.uint8, device=dev)
        kernel(*(x.data_ptr() for x in slots), mwir.data_ptr(),
               res.data_ptr(), 0 if work is None else work.data_ptr(), b,
               l2, presorted, *extra, walk, dedup_walk, kk)
    return res


def _lane_shift(x: torch.Tensor, e: int) -> torch.Tensor:
    """y[:, i] = x[:, i - e] for i >= e, 0 below."""
    y = torch.zeros_like(x)
    y[:, e:] = x[:, :-e]
    return y


def _compact_runs(p: torch.Tensor, fill: int = I32_MAX):
    """Left-compact the distinct runs of each sorted row: -> (slots,
    run counts), vacated lanes (fill, 0)
    (candidates_pallas.py::_compact_runs_packed, and _compact_runs on
    the (tgt, win) keys of ``_pair_key``)."""
    b, l = p.shape
    lane = torch.arange(l, device=p.device)
    start = torch.ones_like(p, dtype=torch.bool)
    start[:, 1:] = p[:, 1:] != p[:, :-1]
    s_pos = torch.where(start, lane, l)
    nxt = torch.flip(torch.cummin(torch.flip(s_pos, [1]), dim=1).values, [1])
    nxt = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], l)], dim=1)
    cnt = torch.where(start, nxt - lane, 0).to(torch.int32)
    dest = torch.where(start, torch.cumsum(start, dim=1) - 1, l)
    cp = torch.full((b, l + 1), fill, dtype=p.dtype, device=p.device)
    cc = torch.zeros((b, l + 1), dtype=torch.int32, device=p.device)
    cp.scatter_(1, dest, p)
    cc.scatter_(1, dest, cnt)
    return cp[:, :l], cc[:, :l]


def candidates_sorted_plain(p: torch.Tensor, mwir: torch.Tensor,
                            pack_bits: int, walk_elems: int = 0,
                            dedup_walk: int = 0, max_candidates: int = 2):
    """Plain version of B4 on sorted (B, L2) rows: the sweep + top-k of
    candidates_pallas.py::_packed_kernel, lane shifts as shifted tensors.
    -> (B, K, 4) int32 [tgt, hits, beg, end] per round."""
    b, l2 = p.shape
    lane = torch.arange(l2, dtype=torch.int32, device=p.device)[None, :]
    mw1 = (mwir.to(torch.int32) - 1)[:, None]
    if dedup_walk:
        p, cnt = _compact_runs(p)
        is_match = p != I32_MAX
        lo_p = p - mw1
        hits = torch.where(is_match, cnt, 0)
        beg = p.clone()
        for e in range(1, dedup_walk):
            pe = _lane_shift(p, e)
            ce = _lane_shift(cnt, e)
            ok = (lane >= e) & is_match & (pe >= lo_p)
            hits = hits + torch.where(ok, ce, 0)
            beg = torch.where(ok, pe, beg)
    else:
        is_match = p != I32_MAX
        lo_p = p - mw1
        hits = torch.ones_like(p)
        beg = p.clone()
        for e in range(1, walk_elems):
            pe = _lane_shift(p, e)
            ok = (lane >= e) & (pe >= lo_p)
            hits = hits + ok.to(torch.int32)
            beg = torch.where(ok, pe, beg)
    key = hits.to(torch.int64) * l2 + (l2 - 1 - lane)
    v = torch.where(is_match, key, -1)
    tq = (p >> pack_bits) & ((1 << (32 - pack_bits)) - 1)
    shift = int(l2).bit_length() - 1
    wmask = (1 << pack_bits) - 1
    rounds = []
    for _ in range(max_candidates):
        best = v.max(dim=1).values
        ok = best > 0
        bestcol = torch.where(ok, (l2 - 1) - (best & (l2 - 1)), 0)
        bc = bestcol[:, None].to(torch.int64)
        pbest = p.gather(1, bc)[:, 0]
        tbest = torch.where(ok, (pbest >> pack_bits) &
                            ((1 << (32 - pack_bits)) - 1), -1)
        rounds.append(torch.stack([
            tbest,
            torch.where(ok, best >> shift, 0),
            torch.where(ok, beg.gather(1, bc)[:, 0] & wmask, 0),
            torch.where(ok, pbest & wmask, 0)], dim=1))
        v = torch.where(tq == tbest[:, None], -1, v)
    return torch.stack(rounds, dim=1).to(torch.int32)


def candidates_packed(pk: torch.Tensor, mwir: torch.Tensor, pack_bits: int,
                      walk_elems: int = 0, dedup_walk: int = 0,
                      max_candidates: int = 2, presorted: int = 0,
                      sorted_input: bool = False, split: bool = False):
    """(B, L) packed slots + (B,) mwir -> per-row top-k candidates
    (cand_tgt, cand_hits, cand_beg, cand_end), each (B, K) int32,
    cand_tgt == -1 for empty slots (candidates_pallas_packed :429-490).

    Rows are padded with I32_MAX to max(128, next power of two) lanes.
    B4 sorts them itself (phases below ``presorted`` skipped) and sweeps;
    with ``split`` B3 sorts them first and B4 only sweeps, and with
    ``sorted_input`` they arrive sorted. Walk mode when ``dedup_walk``
    is 0. CPU tensors take the plain sort and sweep on every route. Rows
    wider than MAX_CAND_L2 take the wide form, which sorts them itself
    (``split`` does not apply: B3 takes no such row)."""
    _check(pk, "pk", 2)
    b, l = pk.shape
    kk = max_candidates
    if not 1 <= kk <= 4:
        raise ValueError("max_candidates must be in 1..4")
    walk = 0 if dedup_walk else walk_elems
    if walk <= 0 and dedup_walk <= 0:
        raise ValueError("need walk_elems > 0 or dedup_walk > 0")
    l2 = padded_width(l)
    if l2 != l:
        if presorted:
            raise ValueError("presorted runs must tile the padded row")
        pad = torch.full((b, l2 - l), I32_MAX, dtype=torch.int32,
                         device=pk.device)
        pk = torch.cat([pk, pad], dim=1)
    if presorted and (presorted & (presorted - 1) or l2 % presorted):
        raise ValueError(f"presorted={presorted} must be a power of two "
                         f"dividing {l2}")
    mwir = mwir.to(device=pk.device, dtype=torch.int32).contiguous()
    if mwir.shape != (b,):
        raise ValueError(f"mwir must have shape ({b},)")
    if not pk.is_cuda:
        if not sorted_input:
            pk = sort_packed_plain(pk, presorted)
        res = candidates_sorted_plain(pk, mwir, pack_bits, walk, dedup_walk,
                                      kk)
    elif l2 > MAX_CAND_L2:
        res = _wide(kernels.CANDIDATES_WIDE, (pk,), mwir, l2,
                    l2 if sorted_input else presorted, (pack_bits,), walk,
                    dedup_walk, kk)
    else:
        if sorted_input:
            presorted = l2
        elif split:
            pk, presorted = sort_packed(pk, presorted), l2
        pk = pk.contiguous()
        if pk.data_ptr() % 16:          # the kernel loads 16 bytes a lane
            pk = pk.clone()
        res = torch.empty((b, kk, 4), dtype=torch.int32, device=pk.device)
        if b:
            kernels.CANDIDATES(pk.data_ptr(), mwir.data_ptr(),
                               res.data_ptr(), b, l2, presorted, pack_bits,
                               walk, dedup_walk, kk)
    return res[:, :, 0], res[:, :, 1], res[:, :, 2], res[:, :, 3]


def _pair_key(t: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """int32 (tgt, win) -> int64 keys whose order is the signed
    lexicographic (tgt, win) order (CPU torch has no two-key sort)."""
    return (t.to(torch.int64) << 32) + (w.to(torch.int64) + 2**31)


def _pair_split(k: torch.Tensor):
    return ((k >> 32).to(torch.int32),
            ((k & 0xFFFFFFFF) - 2**31).to(torch.int32))


_PAD_KEY = (I32_MAX << 32) + I32_MAX + 2**31   # _pair_key(I32_MAX, I32_MAX)


def candidates_unpacked_plain(tgt: torch.Tensor, win: torch.Tensor,
                              mwir: torch.Tensor, walk_elems: int = 0,
                              dedup_walk: int = 0, max_candidates: int = 2):
    """Plain version of B5 on (B, L2) rows, L2 a power of two: the
    (tgt, win) sort, the walk or dedup sweep and the top-k rounds of
    candidates_pallas.py::_candidates_kernel, lane shifts as shifted
    tensors. -> (B, K, 4) int32 [tgt, hits, beg, end] per round."""
    b, l2 = tgt.shape
    lane = torch.arange(l2, dtype=torch.int32, device=tgt.device)[None, :]
    mw1 = (mwir.to(torch.int32) - 1)[:, None]
    key = torch.sort(_pair_key(tgt, win), dim=1).values
    if dedup_walk:
        key, cnt = _compact_runs(key, fill=_PAD_KEY)
    t, w = _pair_split(key)
    is_match = t != I32_MAX
    w_lo = w - mw1
    hits = torch.where(is_match, cnt, 0) if dedup_walk \
        else torch.ones_like(t)
    beg = w.clone()
    for e in range(1, dedup_walk or walk_elems):
        we = _lane_shift(w, e)
        ok = (lane >= e) & (_lane_shift(t, e) == t) & (we >= w_lo)
        if dedup_walk:
            ok = ok & is_match
            hits = hits + torch.where(ok, _lane_shift(cnt, e), 0)
        else:
            hits = hits + ok.to(torch.int32)
        beg = torch.where(ok, we, beg)
    v = torch.where(is_match, hits.to(torch.int64) * l2 + (l2 - 1 - lane),
                    -1)
    shift = int(l2).bit_length() - 1
    rounds = []
    for _ in range(max_candidates):
        best = v.max(dim=1).values
        ok = best > 0
        bc = torch.where(ok, (l2 - 1) - (best & (l2 - 1)), 0)[:, None] \
            .to(torch.int64)
        tbest = torch.where(ok, t.gather(1, bc)[:, 0], -1)
        rounds.append(torch.stack([
            tbest,
            torch.where(ok, best >> shift, 0),
            torch.where(ok, beg.gather(1, bc)[:, 0], 0),
            torch.where(ok, w.gather(1, bc)[:, 0], 0)], dim=1))
        v = torch.where(t == tbest[:, None], -1, v)
    return torch.stack(rounds, dim=1).to(torch.int32)


def candidates_unpacked(tgt: torch.Tensor, win: torch.Tensor,
                        mwir: torch.Tensor, walk_elems: int = 0,
                        dedup_walk: int = 0, max_candidates: int = 2,
                        presorted: int = 0):
    """(B, L) target and window slots + (B,) mwir -> per-row top-k
    candidates (cand_tgt, cand_hits, cand_beg, cand_end), each (B, K)
    int32, cand_tgt == -1 for empty slots (candidates_pallas :264-303).

    Rows are padded with (I32_MAX, I32_MAX) to max(128, next power of
    two) lanes; B5 sorts them by (tgt, win), skipping the phases below
    ``presorted`` (alternating sorted runs of that many lanes), sweeps
    and picks the top k. Walk mode when ``dedup_walk`` is 0. Rows wider
    than MAX_UNPACKED_L2 take the wide form."""
    _check(tgt, "tgt", 2)
    _check(win, "win", 2)
    if win.shape != tgt.shape or win.device != tgt.device:
        raise ValueError("tgt and win must have one shape and device")
    b, l = tgt.shape
    kk = max_candidates
    if not 1 <= kk <= 4:
        raise ValueError("max_candidates must be in 1..4")
    walk = 0 if dedup_walk else walk_elems
    if walk <= 0 and dedup_walk <= 0:
        raise ValueError("need walk_elems > 0 or dedup_walk > 0")
    l2 = padded_width(l)
    if l2 != l:
        if presorted:
            raise ValueError("presorted runs must tile the padded row")
        pad = torch.full((b, l2 - l), I32_MAX, dtype=torch.int32,
                         device=tgt.device)
        tgt = torch.cat([tgt, pad], dim=1)
        win = torch.cat([win, pad], dim=1)
    if presorted and (presorted & (presorted - 1) or l2 % presorted):
        raise ValueError(f"presorted={presorted} must be a power of two "
                         f"dividing {l2}")
    mwir = mwir.to(device=tgt.device, dtype=torch.int32).contiguous()
    if mwir.shape != (b,):
        raise ValueError(f"mwir must have shape ({b},)")
    if not tgt.is_cuda:
        res = candidates_unpacked_plain(tgt, win, mwir, walk, dedup_walk, kk)
    elif l2 > MAX_UNPACKED_L2:
        res = _wide(kernels.CANDIDATES_UNPACKED_WIDE, (tgt, win), mwir, l2,
                    presorted, (), walk, dedup_walk, kk)
    else:
        tgt, win = tgt.contiguous(), win.contiguous()
        res = torch.empty((b, kk, 4), dtype=torch.int32, device=tgt.device)
        if b:
            kernels.CANDIDATES_UNPACKED(
                tgt.data_ptr(), win.data_ptr(), mwir.data_ptr(),
                res.data_ptr(), b, l2, presorted, walk, dedup_walk, kk)
    return res[:, :, 0], res[:, :, 1], res[:, :, 2], res[:, :, 3]
