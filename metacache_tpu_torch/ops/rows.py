"""Row-layout query step: one row of match slots per read.

Port of metacache_tpu/ops/rows.py for the dense fused-row layout:
sketch (B1) -> bucket-row probe + fused-row gather -> match slots ->
candidates -> ranked LCA. Slots that pack into int32 (pack_bits > 0) go
through sort (B3) and sweep + top-k (B4); unpacked (tgt, win) slots go
through the two-key kernel (B5). The port runs the fused candidate
branch of ``rows_to_result`` whenever the result allows it; branches it
does not carry yet raise NotImplementedError naming their ROADMAP item.
A Python loop over the K stacked batches takes the place of
``lax.scan``.
"""
from __future__ import annotations

import torch

from .candidates import I32_MAX, candidates_packed, candidates_unpacked
from .pipeline import QueryResult, classify_candidates
from .probe import probe_bucket, shift_right_logical
from .sketch import sketch_windows


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


def probe_rows(feats: torch.Tensor, tables, alt_runs: int = 0,
               pack_bits: int = 0):
    """(B, F) int32 features -> (B, F*C) match slots (rows.py:624-839,
    dense branches). With ``pack_bits=w`` returns (pk, pk),
    pk = (tgt << w) | win with I32_MAX padding, else (tgt, win).

    ``alt_runs=r`` pads each feature's slots to r lanes and reverses
    odd features' segments, emitting alternating asc/desc sorted runs so
    that the slot sort skips its first log2(r) phases."""
    b, f = feats.shape
    c = tables.spf
    flat = feats.reshape(-1)
    slot_bits = tables.slot_bits
    idx, _found = probe_bucket(flat, tables.bucket_rows, tables.bucket_bits)
    idx_c = torch.clamp(idx, 0, max(tables.num_features - 1, 0))
    rows = tables.fused_rows[idx_c.to(torch.int64)]   # ONE row gather
    found = _meta_match(rows, flat)
    cnt = torch.where(found, rows[:, 1], 0)
    j = torch.arange(c, dtype=torch.int32, device=feats.device)[None, :]
    hit = j < cnt[:, None]
    pks = None
    if slot_bits:
        pks = torch.where(hit, rows[:, 2:2 + c], I32_MAX)
    else:
        tgts = torch.where(hit, rows[:, 2:2 + c], I32_MAX)
        wins = torch.where(hit, rows[:, 2 + c:2 + 2 * c], I32_MAX)
    if pks is not None and not pack_bits:
        pad_ = pks == I32_MAX
        tgts = torch.where(pad_, I32_MAX, shift_right_logical(pks, slot_bits))
        wins = torch.where(pad_, I32_MAX, pks & ((1 << slot_bits) - 1))
    fidx = torch.arange(b * f, device=feats.device)[:, None] % f
    odd = (fidx & 1) == 1

    def alternate(x):
        rl = alt_runs
        if rl > c:
            x = torch.cat([x, torch.full((b * f, rl - c), I32_MAX,
                                         dtype=torch.int32,
                                         device=x.device)], dim=1)
        return torch.where(odd, x.flip(1), x).reshape(b, f * rl)

    if pack_bits:
        if pks is None:
            pk = torch.where(tgts != I32_MAX, (tgts << pack_bits) | wins,
                             I32_MAX)
        elif slot_bits == pack_bits:
            pk = pks
        else:
            # re-base the storage encoding onto the caller's bits
            pk = torch.where(
                pks == I32_MAX, I32_MAX,
                (shift_right_logical(pks, slot_bits) << pack_bits)
                | (pks & ((1 << slot_bits) - 1)))
        pk = alternate(pk) if alt_runs else pk.reshape(b, f * c)
        return pk, pk
    if alt_runs:
        return alternate(tgts), alternate(wins)
    return tgts.reshape(b, f * c), wins.reshape(b, f * c)


def rows_to_result(tgt, win, mwir, merge_tax_of_target, lineages,
                   hits_min, hits_diff_frac, highest_rank, merge_rank,
                   *, max_candidates: int, walk_elems: int = 0,
                   dedup_walk: int = 0, fast_top2: bool = False,
                   emit_hits: bool = False, presorted_runs: int = 0,
                   pack_bits: int = 0) -> QueryResult:
    """(B, L) match slots -> candidates + classification: the fused
    branch of rows.py:134-179. With ``pack_bits`` > 0, ``tgt`` holds the
    packed slots (``win`` is ignored) for sort B3 and sweep + top-k B4;
    with 0, (tgt, win) go to the two-key kernel B5."""
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
            max_candidates=kk, presorted=presorted_runs)
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
    nk, b, wq, w = windows_k.shape
    if infeed_packed:
        w = w * 4
        shifts = torch.arange(4, dtype=torch.uint8,
                              device=windows_k.device) * 2
    alt = _alt_runs(fast_top2, walk_elems, dedup_walk, wq * sketchlen,
                    tables.spf)
    out = []
    for i in range(nk):
        wmat = windows_k[i]
        if infeed_packed:
            # content past a window's valid length is ignored by the
            # sketcher (rows.py:1000-1005)
            wmat = ((wmat[..., None] >> shifts) & 3).reshape(b, wq, w)
        feats = sketch_windows(wmat.reshape(b * wq, w),
                               valid_k[i].reshape(b * wq).to(torch.int32),
                               k, sketchlen).reshape(b, wq * sketchlen)
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
