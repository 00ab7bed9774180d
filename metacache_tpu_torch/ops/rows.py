"""Row-layout query step: one row of match slots per read.

Port of metacache_tpu/ops/rows.py for the dense, two-tier and
size-classed fused-row layouts, plain or pair-packed: sketch (B1, or B2
for windows wider than 128) -> bucket-row probe (B9 when
``MC_PROBE_PALLAS`` names its stage) + row gather -> match slots ->
candidates -> ranked LCA. Two-tier rows with packed slots decode
through B7 (head + overflow rows; B8 finds the overflow rows first
where JAX runs it) or, in escalation phase 1, B6 (head rows only);
classed cells decode as torch ops, as the JAX package decodes them with
XLA ops. Slots that pack into int32 (pack_bits > 0) go through B4, which
sorts each row itself before its sweep + top-k, or, with
``MC_SPLIT_CAND=1``, through sort B3 and then B4's sweep + top-k
(``split_candidates``); unpacked (tgt, win) slots go through the
two-key kernel (B5). The port runs the fused candidate branch of
``rows_to_result`` whenever the result allows it; branches it does not
carry yet raise NotImplementedError naming their ROADMAP item. A Python
loop over the K stacked batches takes the place of ``lax.scan``.
"""
from __future__ import annotations

import os

import torch

from .candidates import (I32_MAX, candidates_packed, candidates_unpacked,
                         padded_width)
from .pipeline import QueryResult, classify_candidates
from .probe import probe_bucket, probe_bucket_classed, shift_right_logical
from .probe_decode import (_rows, full_decode, head_decode, oidx_decode,
                           probe_pallas_enabled)
from .sketch import (LANES, sketch_windows, sketch_windows_packed,
                     unpack_2bit)


# the route of packed slots when MC_SPLIT_CAND is unset: "0" sorts inside
# B4. JAX splits by default only to give its sort a larger VMEM row tile
# (candidates_pallas.py:387-390); on the card the fused form was timed
# against B3 + B4 at the main path's shapes (PERF.md §6)
SPLIT_CAND_DEFAULT = "0"


def split_candidates() -> bool:
    """MC_SPLIT_CAND as JAX's rows.py:156 reads it: "0" runs B4 with the
    sort fused in, any other value B3 and then B4's sweep; unset, the
    port's default ``SPLIT_CAND_DEFAULT``."""
    return os.environ.get("MC_SPLIT_CAND", SPLIT_CAND_DEFAULT) != "0"


def _meta_match(rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Fused-row feature verification, u32 features (rows.py:65-77)."""
    return (rows[:, 0] == flat) & (flat != -1)


def _alt_runs(fast_top2: bool, walk_elems: int, dedup_walk: int,
              feats_per_query: int, spf: int) -> int:
    """Run length for alternating-direction probe emission, 0 = off
    (rows.py:80-90; the port always takes the fused candidate branch)."""
    if not (fast_top2 and (walk_elems or dedup_walk)):
        return 0
    if spf <= 64 or feats_per_query & (feats_per_query - 1):
        return 0
    return 1 << (spf - 1).bit_length()


def _bucket_idx(flat: torch.Tensor, tables) -> torch.Tensor:
    """The bucket-probe stage: feature rows, or classed cell addresses
    (pidx), of (N,) features (rows.py:1035-1047)."""
    if tables.classed:
        return probe_bucket_classed(flat, tables.bucket_rows,
                                    tables.bucket_bits)[0]
    idx, _found = probe_bucket(flat, tables.bucket_rows, tables.bucket_bits)
    return torch.clamp(idx, 0, max(tables.num_features - 1, 0))


# rows.py:469-494
def _classed_window(cells: torch.Tensor, pidx: torch.Tensor):
    """Each probe's classed cell as a 64-lane window -> (window, cls).

    pidx = (addr16 << 2) | cls; cells = the (P, 128) cell array. Cell
    bases are 8-unit aligned per class and widths 1/2/4 units at
    width-aligned offsets, so no cell crosses a 64-lane half: read the
    half, then shift it left by the cell's 16-lane offset, zero filled.
    Lanes past the cell's width hold neighbour cells; callers mask by
    the bucket count, which never exceeds the cell's slots."""
    a16 = shift_right_logical(pidx, 2)
    row = cells.view(-1, 64)[(a16 >> 2).to(torch.int64)]
    src = torch.arange(64, device=pidx.device)[None, :] + \
        16 * (a16 & 3).to(torch.int64)[:, None]
    window = torch.where(src < 64,
                         torch.gather(row, 1, torch.clamp(src, max=63)), 0)
    return window, pidx & 3


# rows.py:497-515
def _classed_head_slots(flat, cells, hsl: int, idx_c):
    """One classed head cell per probe -> (window (N, 64), found, cnt,
    isC class-C mask, slots (N, hsl) head slot lanes); hsl <= 61."""
    window, clsv = _classed_window(cells, idx_c)
    found = (window[:, 0] == flat) & (flat != -1)
    cnt = torch.where(found, window[:, 1], 0)
    isC = clsv == 2
    slots = torch.where(isC[:, None], window[:, 3:3 + hsl],
                        window[:, 2:2 + hsl])
    return window, found, cnt, isC, slots


# rows.py:518-542
def _classed_probe(flat, tables, c: int, idx_c):
    """Classed head + overflow slots -> pks (N, c) packed slots masked
    to the bucket count."""
    hsl = tables.head_slots
    window, found, cnt, isC, slots = _classed_head_slots(
        flat, tables.fused_rows, hsl, idx_c)
    if c > hsl:
        orow = _rows(tables.ovf_rows, torch.where(found & isC, window[:, 2],
                                                  0))
        pks = torch.cat([slots, orow[:, :c - hsl]], dim=1)
    else:
        pks = slots[:, :c]
    j = torch.arange(c, dtype=torch.int32, device=flat.device)[None, :]
    return torch.where(j < cnt[:, None], pks, I32_MAX)


def _encode(lanes, slot_bits: int, pack_bits: int):
    """Slots as stored -> the caller's encoding: (pk,) packed with
    ``pack_bits``, or (tgt, win) when 0 (rows.py:798-815)."""
    if slot_bits:
        pks = lanes[0]
        if pack_bits == slot_bits:
            return (pks,)
        pad_ = pks == I32_MAX
        tgts = torch.where(pad_, I32_MAX, shift_right_logical(pks, slot_bits))
        wins = torch.where(pad_, I32_MAX, pks & ((1 << slot_bits) - 1))
    else:
        tgts, wins = lanes
    if pack_bits:
        return (torch.where(tgts != I32_MAX, (tgts << pack_bits) | wins,
                            I32_MAX),)
    return tgts, wins


def _emit(lanes, b: int, f: int, alt_runs: int):
    """(B*F, C) slot lanes -> (B, F*C) rows; with ``alt_runs=r`` each
    feature's run is padded to r lanes and odd features' runs reversed
    (rows.py:816-838). -> (pk, pk) or (tgt, win)."""
    out = []
    for x in lanes:
        if alt_runs:
            rl, c = alt_runs, x.shape[1]
            if rl > c:
                x = torch.cat([x, torch.full((b * f, rl - c), I32_MAX,
                                             dtype=torch.int32,
                                             device=x.device)], dim=1)
            odd = ((torch.arange(b * f, device=x.device)[:, None] % f)
                   & 1) == 1
            x = torch.where(odd, x.flip(1), x)
        out.append(x.reshape(b, -1))
    return (out[0], out[0]) if len(out) == 1 else tuple(out)


def probe_rows(feats: torch.Tensor, tables, alt_runs: int = 0,
               pack_bits: int = 0, idx_pre: torch.Tensor | None = None):
    """(B, F) int32 features -> (B, F*C) match slots (rows.py:624-839,
    dense, two-tier and classed branches). With ``pack_bits=w`` returns
    (pk, pk), pk = (tgt << w) | win with I32_MAX padding, else (tgt, win).

    ``alt_runs=r`` pads each feature's slots to r lanes and reverses
    odd features' segments, emitting alternating asc/desc sorted runs so
    that the slot sort skips its first log2(r) phases. ``idx_pre``: the
    feature rows (classed: cell addresses), found by an earlier bucket
    probe (rows.py:665-669).

    Two-tier tables with packed slots decode head and overflow rows
    through B7, with the overflow rows found by B8 first where JAX runs
    its oidx kernel (pair-packed heads, full runs; rows.py:716-738);
    (tgt, win) lane rows and classed cells decode as torch ops, as the
    JAX package decodes them with XLA ops (rows.py:699-701, 750-758)."""
    b, f = feats.shape
    c = tables.spf
    flat = feats.reshape(-1)
    slot_bits = tables.slot_bits
    idx_c = _bucket_idx(flat, tables) if idx_pre is None \
        else idx_pre.reshape(-1)
    hsl = tables.head_slots
    if tables.classed:
        pks = _classed_probe(flat, tables, c, idx_c)
        return _emit(_encode((pks,), slot_bits, pack_bits), b, f, alt_runs)
    if hsl and slot_bits:
        rl = alt_runs or c
        oidx = None
        if (tables.packed and not tables.ovf_packed and
                slot_bits == pack_bits and hsl <= 61 and alt_runs >= c and
                probe_pallas_enabled("oidx")):
            oidx = oidx_decode(tables.fused_rows, idx_c, flat)
        pks = full_decode(tables.fused_rows, tables.ovf_rows, idx_c, flat,
                          hsl, c, rl, f if alt_runs else 1, oidx)
        return _emit(_encode((pks,), slot_bits, pack_bits), b, f, 0)
    rows = tables.fused_rows[idx_c.to(torch.int64)]   # ONE row gather
    found = _meta_match(rows, flat)
    cnt = torch.where(found, rows[:, 1], 0)
    j = torch.arange(c, dtype=torch.int32, device=feats.device)[None, :]
    hit = j < cnt[:, None]
    if hsl:
        # two-tier (tgt, win) lanes: head [feat, count, ovf_idx, tgt*H,
        # win*H], overflow [tgt*(C-H), win*(C-H)]
        ow = c - hsl
        orow = tables.ovf_rows[torch.where(found, rows[:, 2], 0).to(
            torch.int64)]
        tgts = torch.cat([rows[:, 3:3 + hsl], orow[:, :ow]], dim=1)
        wins = torch.cat([rows[:, 3 + hsl:3 + 2 * hsl], orow[:, ow:2 * ow]],
                         dim=1)
        lanes = (torch.where(hit, tgts, I32_MAX),
                 torch.where(hit, wins, I32_MAX))
    elif slot_bits:
        lanes = (torch.where(hit, rows[:, 2:2 + c], I32_MAX),)
    else:
        lanes = (torch.where(hit, rows[:, 2:2 + c], I32_MAX),
                 torch.where(hit, rows[:, 2 + c:2 + 2 * c], I32_MAX))
    return _emit(_encode(lanes, slot_bits, pack_bits), b, f, alt_runs)


def probe_rows_head(feats: torch.Tensor, tables, alt_runs: int,
                    pack_bits: int, idx_pre: torch.Tensor | None = None):
    """Head-only probe, escalation phase 1 (rows.py:545-621): one head
    row (two-tier, decoded by B6) or head cell (classed, torch ops) per
    probe; slots past the head are dropped. -> (pk (B, F*rl) packed
    slots, over (B,) bool: a probed bucket is deeper than the head, so
    the read must be redone at full depth). Needs slot-packed two-tier
    or classed tables and pack_bits == slot_bits."""
    b, f = feats.shape
    hsl = tables.head_slots
    if not (hsl and tables.slot_bits and tables.slot_bits == pack_bits):
        raise ValueError("the head-only probe needs slot-packed two-tier "
                         "tables whose slot bits equal pack_bits")
    flat = feats.reshape(-1)
    idx_c = _bucket_idx(flat, tables) if idx_pre is None \
        else idx_pre.reshape(-1)
    rl = alt_runs or hsl
    if tables.classed:
        _w, _found, cnt, _isC, slots = _classed_head_slots(
            flat, tables.fused_rows, hsl, idx_c)
        j = torch.arange(hsl, dtype=torch.int32, device=flat.device)
        pk = torch.where(j[None, :] < torch.clamp(cnt, max=hsl)[:, None],
                         slots, I32_MAX)
        pk = _emit((pk,), b, f, alt_runs)[0]
    else:
        pk, cnt = head_decode(tables.fused_rows, idx_c, flat, hsl, rl,
                              f if alt_runs else 1)
    over = (cnt > hsl).reshape(b, f).any(dim=1)
    return pk.reshape(b, f * rl), over


def rows_to_result(tgt, win, mwir, merge_tax_of_target, lineages,
                   hits_min, hits_diff_frac, highest_rank, merge_rank,
                   *, max_candidates: int, walk_elems: int = 0,
                   dedup_walk: int = 0, fast_top2: bool = False,
                   emit_hits: bool = False, presorted_runs: int = 0,
                   pack_bits: int = 0) -> QueryResult:
    """(B, L) match slots -> candidates + classification: the fused
    branch of rows.py:134-179. With ``pack_bits`` > 0, ``tgt`` holds the
    packed slots (``win`` is ignored) for B4, fused or after B3 as
    ``split_candidates`` says; with 0, (tgt, win) go to the two-key
    kernel B5."""
    kk = max_candidates
    if emit_hits:
        raise NotImplementedError(
            "per-hit lists (-allhits) need the non-fused result path "
            "(ROADMAP queue A5)")
    if not fast_top2 or kk > 4:
        raise NotImplementedError(
            "taxon merging (-lowest above sequence) or more than 4 "
            "candidates need the non-fused result path (ROADMAP queue A5)")
    if not (walk_elems > 0 or dedup_walk > 0):
        raise NotImplementedError(
            "contiguous ranges longer than 48 windows need the rank-join "
            "sweep (ROADMAP queue A5)")
    walk = 0 if dedup_walk else walk_elems
    if pack_bits:
        # clamping mwir to 2^(wbits-1) is semantically identity and keeps
        # the packed sweep's single-compare range test exact
        # (rows.py:134-140)
        mwir = torch.clamp(mwir.to(torch.int32), max=1 << (pack_bits - 1))
        cand_tgt, cand_hits, cand_beg, cand_end = candidates_packed(
            tgt, mwir, pack_bits, walk_elems=walk, dedup_walk=dedup_walk,
            max_candidates=kk, presorted=presorted_runs,
            split=split_candidates())
    else:
        cand_tgt, cand_hits, cand_beg, cand_end = candidates_unpacked(
            tgt, win, mwir, walk_elems=walk, dedup_walk=dedup_walk,
            max_candidates=kk, presorted=presorted_runs)
    ntax = merge_tax_of_target.shape[0]
    cand_tax = torch.where(
        cand_tgt >= 0,
        merge_tax_of_target[torch.clamp(cand_tgt, 0, ntax - 1).to(
            torch.int64)], 0)
    cls_tax = classify_candidates(
        cand_tgt, cand_tax, cand_hits, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank)
    return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg, cand_end,
                       cls_tax)


def query_step_rows(windows, valid, mwir, tables, hits_min, hits_diff_frac,
                    highest_rank, merge_rank, *, k: int, sketchlen: int,
                    windows_per_query: int, max_candidates: int,
                    walk_elems: int = 0, dedup_walk: int = 0,
                    fast_top2: bool = False, emit_hits: bool = False,
                    pack_bits: int = 0) -> QueryResult:
    """Row-layout classification step (rows.py:904).

    windows: (B, Wq, W) u8 -- every read padded to Wq windows;
    valid: (B, Wq) chars per window (0 = padding window);
    mwir: (B,) contiguous-range length per read."""
    b, wq, w = windows.shape
    feats = sketch_windows(windows.reshape(b * wq, w),
                           valid.reshape(b * wq), k, sketchlen)
    feats = feats.reshape(b, wq * sketchlen)
    alt = _alt_runs(fast_top2, walk_elems, dedup_walk, wq * sketchlen,
                    tables.spf)
    tgt, win = probe_rows(feats, tables, alt_runs=alt, pack_bits=pack_bits)
    return rows_to_result(
        tgt, win, mwir, tables.merge_tax, tables.lineages, hits_min,
        hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, emit_hits=emit_hits,
        presorted_runs=alt, pack_bits=pack_bits)


def _sketch_stage(wmat, vmat, k: int, sketchlen: int,
                  infeed_packed: bool) -> torch.Tensor:
    """(B, Wq, W) windows -> (B, Wq*s) features (rows.py:998-1009).
    ``infeed_packed``: 2-bit codes, four bases per byte, low bits first:
    windows of at most 128 codes go to B1 as they are, which reads them
    itself, wider ones are unpacked here for B2; content past a window's
    valid length is ignored by the sketchers."""
    b, wq, w = wmat.shape
    vmat = vmat.reshape(b * wq)
    if infeed_packed and w * 4 <= LANES:
        return sketch_windows_packed(wmat.reshape(b * wq, w), vmat, k,
                                     sketchlen).reshape(b, wq * sketchlen)
    if infeed_packed:
        wmat = unpack_2bit(wmat.reshape(b * wq, w))
        w *= 4
    return sketch_windows(wmat.reshape(b * wq, w), vmat, k,
                          sketchlen).reshape(b, wq * sketchlen)


def query_step_rows_scan(windows_k, valid_k, mwir_k, tables, hits_min,
                         hits_diff_frac, highest_rank, merge_rank, *,
                         k: int, sketchlen: int, windows_per_query: int,
                         max_candidates: int, walk_elems: int = 0,
                         dedup_walk: int = 0, fast_top2: bool = False,
                         pack_bits: int = 0,
                         infeed_packed: bool = False) -> torch.Tensor:
    """K stacked row batches -> (K, B) int32 classified taxon ids
    (rows.py:958). ``infeed_packed``: windows_k holds 2-bit codes, four
    bases per byte, low bits first, unpacked here; valid_k and mwir_k
    may arrive as uint8."""
    wq = windows_k.shape[2]
    alt = _alt_runs(fast_top2, walk_elems, dedup_walk, wq * sketchlen,
                    tables.spf)
    out = []
    for i in range(windows_k.shape[0]):
        feats = _sketch_stage(windows_k[i], valid_k[i], k, sketchlen,
                              infeed_packed)
        tgt, win = probe_rows(feats, tables, alt_runs=alt,
                              pack_bits=pack_bits)
        res = rows_to_result(
            tgt, win, mwir_k[i], tables.merge_tax, tables.lineages, hits_min,
            hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            dedup_walk=dedup_walk, fast_top2=fast_top2,
            presorted_runs=alt, pack_bits=pack_bits)
        out.append(res.cls_tax)
    return torch.stack(out)


def _pack_bits32(over: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> (ceil(B/32),) int32, read i in bit i % 32 of word
    i // 32 (rows.py:1379-1383)."""
    b = over.shape[0]
    nw = -(-b // 32)
    ob = torch.zeros(nw * 32, dtype=torch.int32, device=over.device)
    ob[:b] = over.to(torch.int32)
    sh = torch.arange(32, dtype=torch.int32, device=over.device)
    return (ob.reshape(nw, 32) << sh).sum(dim=1, dtype=torch.int32)


def query_step_rows_scan_head(windows_k, valid_k, mwir_k, tables, hits_min,
                              hits_diff_frac, highest_rank, merge_rank, *,
                              k: int, sketchlen: int, max_candidates: int,
                              walk_elems: int = 0, dedup_walk: int = 0,
                              fast_top2: bool = True, pack_bits: int = 0,
                              infeed_packed: bool = False):
    """Escalation phase 1 (rows.py:1314-1430): the scan of
    ``query_step_rows_scan`` with one head row per probe (B6) and runs of
    rl = pow2(hsl) lanes, so the slot sort works on F*rl lanes instead of
    F*pow2(spf). -> (cls (K, B) int32, over (K, ceil(B/32)) int32 bit
    words, feats (K, B, F) int32, idx (K, B, F) int32): reads whose bit
    is set touched a bucket deeper than the head and must be redone at
    full depth (``query_step_rows_redo_scan`` on their saved feats and
    idx); the others are exact. The JAX function returns feats and idx
    only with prefetch on, its device default; here they cost nothing."""
    nk, b, wq = windows_k.shape[:3]
    hsl = tables.head_slots
    rl = 1 << max(int(hsl - 1).bit_length(), 0)
    f = wq * sketchlen
    presorted = rl if padded_width(f * rl) == f * rl else 0
    cls, over, feats_k, idx_k = [], [], [], []
    for i in range(nk):
        feats = _sketch_stage(windows_k[i], valid_k[i], k, sketchlen,
                              infeed_packed)
        idx_c = _bucket_idx(feats.reshape(-1), tables)
        pk, ov = probe_rows_head(feats, tables, alt_runs=rl,
                                 pack_bits=pack_bits, idx_pre=idx_c)
        res = rows_to_result(
            pk, pk, mwir_k[i], tables.merge_tax, tables.lineages, hits_min,
            hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            dedup_walk=dedup_walk, fast_top2=fast_top2,
            presorted_runs=presorted, pack_bits=pack_bits)
        cls.append(res.cls_tax)
        over.append(_pack_bits32(ov))
        feats_k.append(feats)
        idx_k.append(idx_c.reshape(b, f))
    return (torch.stack(cls), torch.stack(over), torch.stack(feats_k),
            torch.stack(idx_k))


def query_step_rows_redo(feats, idx_c, mwir, tables, hits_min,
                         hits_diff_frac, highest_rank, merge_rank, *,
                         max_candidates: int, walk_elems: int = 0,
                         dedup_walk: int = 0, fast_top2: bool = True,
                         pack_bits: int = 0) -> torch.Tensor:
    """Escalation phase 2 (rows.py:1079-1117, the body of
    ``_redo_body`` :1157): full-depth classification of (B, F) features
    whose feature rows phase 1 already found, so neither the sketch nor
    the bucket probe runs again. -> (B,) int32 classified taxa."""
    f = feats.shape[1]
    alt = _alt_runs(fast_top2, walk_elems, dedup_walk, f, tables.spf)
    tgt, win = probe_rows(feats, tables, alt_runs=alt, pack_bits=pack_bits,
                          idx_pre=idx_c)
    return rows_to_result(
        tgt, win, mwir.to(torch.int32), tables.merge_tax, tables.lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, presorted_runs=alt,
        pack_bits=pack_bits).cls_tax


def query_step_rows_redo_scan(feats_k, idx_k, mwir_k, tables, hits_min,
                              hits_diff_frac, highest_rank, merge_rank,
                              **kw) -> torch.Tensor:
    """K stacked redo batches (rows.py:1126-1154): feats_k and idx_k
    (K, B, F), mwir_k (K, B) -> (K, B) classified taxa."""
    return torch.stack([
        query_step_rows_redo(feats_k[i], idx_k[i], mwir_k[i], tables,
                             hits_min, hits_diff_frac, highest_rank,
                             merge_rank, **kw)
        for i in range(feats_k.shape[0])])
