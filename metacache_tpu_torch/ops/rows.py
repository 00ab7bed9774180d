"""Row-layout query step: one row of match slots per read.

Port of metacache_tpu/ops/rows.py for the dense, two-tier and
size-classed fused-row layouts, plain or pair-packed, and the CSR layout
(JAX's ``dense=False``: the feature's row found through the bucket
index, or by a search of u64 features, then its slots read one by one by
the csr_decode kernel): sketch (B1, or B2
for windows wider than 128) -> bucket-row probe (B9; classed_bucket for
the classed cells) -> row decode -> match slots -> candidates -> ranked
LCA. Two-tier rows of u32 features with packed
slots decode through B7 (head + overflow rows, the overflow row read
from the head row it already holds: B8's work, folded in) or, in
escalation phase 1, B6 (head rows only). Dense rows (packed slots or
(tgt, win) lanes), two-tier (tgt, win) lane rows and the u64 tables'
dense and two-tier rows (k > 16: two meta lanes, a bucket index of the
low 32 bits) decode through dense_decode, one pass from the feature
rows to the encoded, padded and reversed runs, where JAX runs XLA ops
(rows.py:699-838). Classed cells decode through classed_decode, at full
depth and in escalation phase 1, where JAX runs XLA ops
(rows.py:469-575); the u64 heads of phase 1 decode as torch ops, which
no runner reaches (u64 rows never escalate, as in JAX).

``rows_to_result`` has JAX's two branches. The fused one runs the
candidate kernels: slots that pack into int32 (pack_bits > 0) go
through B4, which sorts each row itself before its sweep + top-k, or,
with ``MC_SPLIT_CAND=1``, through sort B3 and then B4's sweep + top-k
(``split_candidates``); unpacked (tgt, win) slots go through the
two-key kernel (B5); rows wider than those kernels' shared memory takes
(long reads) go through their wide form, which spreads a row over
blocks (ops/candidates.py). The non-fused branch is the torch counterpart of
JAX's XLA code (rows.py:181-467): a row sort, the walk, dedup or
rank-join sweep, then either the segmented suffix-max top-k
(``_fast_top2_result``) or the best range per target, the taxon merge
and the final ranking, and the per-hit lists of -allhits. Both branches
end in the classify_lca kernel (ops/pipeline.py): the ranked LCA, after
the candidate-taxon lookup where the candidates come without taxa
(``classify_with_taxa``), where JAX runs XLA ops. ``fuses``
picks the branch from flags before the probe, as JAX's runner and
rows.py:142-143 do (``MC_FUSED_CANDIDATES``, runner.py:612-622). A
Python loop over the K stacked batches takes the place of ``lax.scan``;
JAX's scan carries (its ``prefetch``, and the fused escalation's phase 2
inside phase 1) become work on a side stream (device.SideStream),
ordered by events: batch i+1's sketch and bucket probe, and a redo
slice, beside batch i's probe and candidates.
A query holds windows_per_query windows (a pair: mate 1's, then mate
2's); ``query_step_rows_multipart`` probes every part of a multi-part
database and concatenates the parts' slot rows.
"""
from __future__ import annotations

import os

import torch

from ..device import SideStream
from .candidates import (I32_MAX, candidates_packed, candidates_unpacked,
                         padded_width)
from .pipeline import QueryResult, classify_candidates, classify_with_taxa
from .probe import (probe_bucket, probe_bucket64, probe_bucket_classed,
                    shift_right_logical)
from .probe_decode import (_encode, check_probe_pallas, classed_decode,
                           csr_decode, dense_decode, full_decode,
                           head_decode, meta_match)
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


def fused_candidates_enabled() -> bool:
    """MC_FUSED_CANDIDATES as JAX's runner.py:612-622 reads it: "0"
    turns the fused candidate kernels off, any other value leaves them
    on. The port keeps them on by default on the CPU too, where the
    kernels' plain versions run."""
    return os.environ.get("MC_FUSED_CANDIDATES") != "0"


def fuses(fused_candidates: bool, fast_top2: bool, max_candidates: int,
          walk_elems: int, dedup_walk: int, emit_hits: bool) -> bool:
    """True when ``rows_to_result`` takes the fused candidate kernels:
    JAX's condition (rows.py:142-143; its runner asks for no per-hit
    lists then). The kernels take rows of every width."""
    return (fused_candidates and fast_top2 and max_candidates <= 4 and
            (walk_elems > 0 or dedup_walk > 0) and not emit_hits)


def nonfused_sweep(walk_elems: int, dedup_walk: int, l: int) -> str:
    """The non-fused branch's sweep of rows of ``l`` match slots
    (rows.py:200-264): "dedup" (dedup + walk over distinct entries),
    "walk" (a lane walk, which needs 0 < walk_elems < l) or
    "rank-join"."""
    if dedup_walk > 0:
        return "dedup"
    return "walk" if 0 < walk_elems < l else "rank-join"


def _alt_runs(fused: bool, fast_top2: bool, walk_elems: int,
              dedup_walk: int, feats_per_query: int, spf: int) -> int:
    """Run length for alternating-direction probe emission, 0 = off
    (rows.py:80-90): only for the fused candidate kernels."""
    if not (fused and fast_top2 and (walk_elems or dedup_walk)):
        return 0
    if spf <= 64 or feats_per_query & (feats_per_query - 1):
        return 0
    return 1 << (spf - 1).bit_length()


def route(fused_candidates: bool, fast_top2: bool, max_candidates: int,
           walk_elems: int, dedup_walk: int, emit_hits: bool, f: int,
           spf: int):
    """The branch of a step's rows, from flags and shapes before the
    probe: -> (fused, alt_runs). The probe emits f * (alt_runs or spf)
    slots a row; the non-fused branch gets no alternating runs (JAX's
    ``_alt_runs(fused=False, ...)``)."""
    fused = fuses(fused_candidates, fast_top2, max_candidates, walk_elems,
                  dedup_walk, emit_hits)
    return fused, _alt_runs(fused, fast_top2, walk_elems, dedup_walk, f,
                            spf)


def _bucket_idx(flat: torch.Tensor, tables) -> torch.Tensor:
    """The bucket-probe stage: feature rows, clamped into the table
    (B9), or classed cell addresses (pidx, classed_bucket), of (N,)
    features (rows.py:1035-1047). Row layouts only: the CSR layout finds
    its rows in ``_csr_rows``."""
    assert not tables.csr, "a CSR part has no rows to find ahead"
    if tables.classed:
        return probe_bucket_classed(flat, tables.bucket_rows,
                                    tables.bucket_bits)[0]
    probe = probe_bucket64 if tables.wide else probe_bucket
    return probe(flat, tables.bucket_rows, tables.bucket_bits,
                 max(tables.num_features - 1, 0))[0]


INT64_MIN = -2**63


def _csr_rows(flat: torch.Tensor, tables):
    """The CSR layout's row stage (rows.py:670-689) -> (idx int32, found
    bool): a u32 part through its bucket-row index (B9), rows clamped
    into the table; a u64 or empty part by a binary search of the
    sign-flipped features, found where the row holds the feature and it
    is not the sentinel."""
    nf = tables.num_features
    if tables.bucket_rows is not None:
        return probe_bucket(flat, tables.bucket_rows, tables.bucket_bits,
                            nf - 1)
    check_probe_pallas()
    if nf == 0:
        return (torch.zeros(flat.shape, dtype=torch.int32, device=flat.device),
                torch.zeros(flat.shape, dtype=torch.bool, device=flat.device))
    key = flat ^ INT64_MIN
    idx = torch.clamp(torch.searchsorted(tables.features, key), max=nf - 1)
    found = (tables.features[idx] == key) & (flat != -1)
    return idx.to(torch.int32), found


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
    """(B, F) int32 features (int64 on u64 tables) -> (B, F*C) match
    slots (rows.py:624-839, dense, two-tier and classed branches). With
    ``pack_bits=w`` returns (pk, pk), pk = (tgt << w) | win with I32_MAX
    padding, else (tgt, win).

    ``alt_runs=r`` pads each feature's slots to r lanes and reverses
    odd features' segments, emitting alternating asc/desc sorted runs so
    that the slot sort skips its first log2(r) phases. ``idx_pre``: the
    feature rows (classed: cell addresses), found by an earlier bucket
    probe (rows.py:665-669).

    Two-tier tables of u32 features with packed slots decode head and
    overflow rows through B7, which reads each probe's overflow row from
    lane 2 of the head row it holds. JAX runs B8 for that first where
    its oidx stage is named (rows.py:716-738): its kernel had to find the
    rows before XLA gathered them, while B7 reads them itself, so the
    port runs B7 alone under every ``MC_PROBE_PALLAS`` (B8's contract,
    ``found ? row[2] : 0``, is B7's branch without ``oidx``). Dense rows
    (packed slots or (tgt, win) lanes, u32 or u64 features), two-tier
    (tgt, win) lane rows and u64 two-tier rows decode through
    dense_decode, which reads the rows, checks the meta lanes, masks to
    the count, encodes, pads and reverses in one pass, where JAX runs
    XLA ops (rows.py:699-838). Classed cells decode through
    classed_decode, where JAX runs XLA ops (rows.py:469-542). A CSR part
    (``tables.csr``) finds its rows (``_csr_rows``) and reads its slots
    through csr_decode, which writes the encoded, padded and reversed
    runs itself; it is never probed with ``idx_pre`` (no escalation and
    no prefetch reach it, rows.py:785-786)."""
    b, f = feats.shape
    c = tables.spf
    flat = feats.reshape(-1)
    slot_bits = tables.slot_bits
    rl, fr = (alt_runs, f) if alt_runs else (c, 1)
    if tables.csr:
        assert idx_pre is None, "a CSR part recomputes its rows"
        idx, found = _csr_rows(flat, tables)
        out = csr_decode(idx, found, tables.offsets, tables.loc_tgt,
                         tables.loc_win, c, rl, fr, pack_bits)
    else:
        idx_c = _bucket_idx(flat, tables) if idx_pre is None \
            else idx_pre.reshape(-1)
        hsl = tables.head_slots
        if tables.classed:
            out = classed_decode(tables.fused_rows, tables.ovf_rows, idx_c,
                                 flat, hsl, c, rl, fr, slot_bits, pack_bits)
        elif hsl and slot_bits and not tables.wide:
            pks = full_decode(tables.fused_rows, tables.ovf_rows, idx_c,
                              flat, hsl, c, rl, fr)
            return _emit(_encode((pks,), slot_bits, pack_bits), b, f, 0)
        else:
            out = dense_decode(tables.fused_rows,
                               tables.ovf_rows if hsl else None, idx_c,
                               flat, hsl, c, rl, fr, slot_bits, pack_bits)
    out = [x.reshape(b, -1) for x in out]
    return (out[0], out[0]) if pack_bits else tuple(out)


def _wide_rows(flat, tables, idx_c):
    """u64 features' head rows, gathered (as JAX keeps them in XLA,
    rows.py:588) -> (rows, found, cnt)."""
    rows = tables.fused_rows[idx_c.to(torch.int64)]
    found = meta_match(rows, flat)
    return rows, found, torch.where(found, rows[:, 2], 0)


def probe_rows_head(feats: torch.Tensor, tables, alt_runs: int,
                    pack_bits: int, idx_pre: torch.Tensor | None = None):
    """Head-only probe, escalation phase 1 (rows.py:545-621): one head
    row (two-tier, decoded by B6) or head cell (classed, decoded by
    classed_decode) per probe; slots past the head are dropped. -> (pk (B, F*rl) packed
    slots, over (B,) bool: a probed bucket is deeper than the head, so
    the read must be redone at full depth). Needs slot-packed two-tier
    or classed tables and pack_bits == slot_bits."""
    b, f = feats.shape
    hsl = tables.head_slots
    assert not tables.csr, "a CSR part is never escalated"
    if not (hsl and tables.slot_bits and tables.slot_bits == pack_bits):
        raise ValueError("the head-only probe needs slot-packed two-tier "
                         "tables whose slot bits equal pack_bits")
    flat = feats.reshape(-1)
    idx_c = _bucket_idx(flat, tables) if idx_pre is None \
        else idx_pre.reshape(-1)
    rl = alt_runs or hsl
    if tables.classed:
        pk, cnt = classed_decode(tables.fused_rows, tables.ovf_rows, idx_c,
                                 flat, hsl, tables.spf, rl,
                                 f if alt_runs else 1, tables.slot_bits,
                                 pack_bits, head=True)
    elif tables.wide:
        # u64 heads decode as torch ops, as JAX's XLA path (rows.py:588):
        # no runner escalates u64 rows (classify/runner.py), so no query
        # reaches this branch
        rows, _found, cnt = _wide_rows(flat, tables, idx_c)
        j = torch.arange(hsl, dtype=torch.int32, device=flat.device)
        pk = torch.where(j[None, :] < torch.clamp(cnt, max=hsl)[:, None],
                         rows[:, 4:4 + hsl], I32_MAX)
        pk = _emit((pk,), b, f, alt_runs)[0]
    else:
        pk, cnt = head_decode(tables.fused_rows, idx_c, flat, hsl, rl,
                              f if alt_runs else 1)
    over = (cnt > hsl).reshape(b, f).any(dim=1)
    return pk.reshape(b, f * rl), over


def _shifted(x: torch.Tensor, e: int, fill) -> torch.Tensor:
    """y[:, i] = x[:, i - e] for i >= e, ``fill`` below (JAX's
    concatenate of a filled block and x[:, :-e])."""
    b, l = x.shape
    e = min(e, l)
    return torch.cat([torch.full((b, e), fill, dtype=x.dtype,
                                 device=x.device), x[:, :l - e]], dim=1)


def _pair_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Two int32 keys -> one int64 key in their lexicographic order
    (signed hi, then signed lo)."""
    return hi.to(torch.int64) * (1 << 32) + (lo.to(torch.int64) + (1 << 31))


def _sort_rows(ops, num_keys: int):
    """jax.lax.sort(ops, dimension=1, num_keys=num_keys) for int32
    operands: a stable lexicographic sort of each row by the first
    ``num_keys`` operands, the others carried. Keys pair up into int64
    from the last; a chain of stable sorts, the last key first, gives
    the lexicographic order."""
    keys = list(ops[:num_keys])
    chain = []
    while keys:
        chain.append(_pair_key(keys[-2], keys[-1]) if len(keys) >= 2
                     else keys[-1])
        keys = keys[:-2]
    perm = None
    for k in chain:
        if perm is not None:
            k = torch.gather(k, 1, perm)
        idx = torch.sort(k, dim=1, stable=True).indices
        perm = idx if perm is None else torch.gather(perm, 1, idx)
    return tuple(torch.gather(x, 1, perm) for x in ops)


def _hit_lists(hit_tgt, hit_win, device):
    """Flat per-hit lists of -allhits (rows.py:364-373): the sorted
    slots, row-major, with the row index as query id (the row count for
    padding); without them three (1,) zeros."""
    if hit_tgt is None:
        z = torch.zeros((1,), dtype=torch.int32, device=device)
        return z, z, z
    b, l = hit_tgt.shape
    row = torch.arange(b, dtype=torch.int32, device=hit_tgt.device)
    qid = torch.where(hit_tgt != I32_MAX, row[:, None], b)
    return qid.reshape(-1), hit_tgt.reshape(-1), hit_win.reshape(-1)


def rows_to_result(tgt, win, mwir, merge_tax_of_target, lineages,
                   hits_min, hits_diff_frac, highest_rank, merge_rank,
                   *, max_candidates: int, walk_elems: int = 0,
                   dedup_walk: int = 0, fast_top2: bool = False,
                   fused_candidates: bool = True, emit_hits: bool = False,
                   presorted_runs: int = 0,
                   pack_bits: int = 0) -> QueryResult:
    """(B, L) match slots -> candidates + classification
    (rows.py:93-373). With ``pack_bits`` > 0, ``tgt`` holds the packed
    slots (``win`` is ignored); with 0, (tgt, win) pairs.

    Where ``fuses`` says so (``fused_candidates``, the port's default,
    and JAX's other conditions), the fused branch: packed slots go to
    B4, fused or after B3 as ``split_candidates`` says, (tgt, win) pairs
    to B5, and rows wider than their shared memory takes to their wide
    form. Otherwise the
    non-fused branch, as torch ops: the sweep by walk (``0 < walk_elems
    < L``), by dedup + walk (``dedup_walk``), else by the rank join;
    then ``_fast_top2_result`` (``fast_top2`` and at most 4 candidates)
    or the best range per target, the merge by taxon and the final
    ranking; with ``emit_hits`` also the per-hit lists."""
    b, l = tgt.shape
    kk = max_candidates
    mwir = mwir.to(torch.int32)
    if pack_bits:
        # clamping mwir to 2^(wbits-1) is semantically identity and keeps
        # the packed sweep's single-compare range test exact
        # (rows.py:134-140)
        mwir = torch.clamp(mwir, max=1 << (pack_bits - 1))
    ntax = merge_tax_of_target.shape[0]
    if fuses(fused_candidates, fast_top2, kk, walk_elems, dedup_walk,
             emit_hits):
        walk = 0 if dedup_walk else walk_elems
        if pack_bits:
            cand_tgt, cand_hits, cand_beg, cand_end = candidates_packed(
                tgt, mwir, pack_bits, walk_elems=walk,
                dedup_walk=dedup_walk, max_candidates=kk,
                presorted=presorted_runs, split=split_candidates())
        else:
            cand_tgt, cand_hits, cand_beg, cand_end = candidates_unpacked(
                tgt, win, mwir, walk_elems=walk, dedup_walk=dedup_walk,
                max_candidates=kk, presorted=presorted_runs)
        cand_tax, cls_tax = classify_with_taxa(
            cand_tgt, cand_hits, merge_tax_of_target, lineages,
            hits_min, hits_diff_frac, highest_rank, merge_rank)
        return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg,
                           cand_end, cls_tax, *_hit_lists(None, None,
                                                           tgt.device))

    dev = tgt.device
    # ---- per-row sort by (target, window) (rows.py:181-192) ----------
    if pack_bits:
        pk = torch.sort(tgt, dim=1).values
        pad = pk == I32_MAX
        tgt = torch.where(pad, I32_MAX, shift_right_logical(pk, pack_bits))
        win = torch.where(pad, I32_MAX, pk & ((1 << pack_bits) - 1))
    else:
        tgt, win = _sort_rows((tgt, win), 2)
    is_match = tgt != I32_MAX
    pos = torch.arange(l, dtype=torch.int32, device=dev).expand(b, l)
    hit_tgt, hit_win = (tgt, win) if emit_hits else (None, None)
    m1 = (mwir - 1)[:, None]

    carry_beg = False
    sweep = nonfused_sweep(walk_elems, dedup_walk, l)
    if sweep == "dedup":
        # compact duplicate (t, w) runs to distinct entries + counts
        # (rows.py:200-217)
        start = (pos == 0) | (tgt != _shifted(tgt, 1, -1)) | \
            (win != _shifted(win, 1, -1))
        s_pos = torch.where(start, pos, I32_MAX)
        nxt_incl = torch.cummin(s_pos.flip(1), dim=1).values.flip(1)
        nxt = torch.cat([nxt_incl[:, 1:],
                         torch.full((b, 1), I32_MAX, dtype=torch.int32,
                                    device=dev)], dim=1)
        nxt = torch.clamp(nxt, max=l)      # next run's start = my run end
        cnt = nxt - pos
        endpos = nxt - 1
        ckey = torch.where(start & is_match, 0, 1).to(torch.int32)
        ckey2, _p, tgt, win, cnt, endpos = _sort_rows(
            (ckey, pos, tgt, win, cnt, endpos), 2)
        valid = ckey2 == 0
        # sweep over distinct entries: <= max(mwir) per range
        # (rows.py:218-234); lane i looks back e lanes, lanes below e
        # have nothing there, so the shifts work on the row's views
        w_lo = win - m1
        hits = torch.where(valid, cnt, 0)
        beg = win.clone()
        for e in range(1, min(dedup_walk, l)):
            ok = valid[:, e:] & valid[:, :-e] & \
                (tgt[:, :-e] == tgt[:, e:]) & (win[:, :-e] >= w_lo[:, e:])
            hits[:, e:] += torch.where(ok, cnt[:, :-e], 0)
            # the last ok shift gives the smallest window
            beg[:, e:] = torch.where(ok, win[:, :-e], beg[:, e:])
        is_match = valid
        tgt = torch.where(valid, tgt, I32_MAX)
        win = torch.where(valid, win, I32_MAX)
        pos = endpos                       # the range's last slot
        lo = beg                           # the begin window, carried
        carry_beg = True
    elif sweep == "walk":
        # rows.py:243-251
        w_lo = win - m1
        hits = torch.ones((b, l), dtype=torch.int32, device=dev)
        for e in range(1, walk_elems):
            hits[:, e:] += ((tgt[:, :-e] == tgt[:, e:]) &
                            (win[:, :-e] >= w_lo[:, e:])).to(torch.int32)
        lo = pos + 1 - hits
    else:
        # the rank join for the two-pointer left bound (rows.py:252-264);
        # the second sort of JAX, by the unique (flag, index) keys, is
        # the inverse permutation, written here as a scatter
        win_lo = torch.clamp(win - m1, min=0)
        ones = torch.ones((b, l), dtype=torch.int32, device=dev)
        ct, cw, cf, cidx = _sort_rows(
            (torch.cat([tgt, tgt], 1), torch.cat([win, win_lo], 1),
             torch.cat([ones, ones - 1], 1), torch.cat([pos, pos], 1)), 3)
        orig_before = torch.cumsum(cf, dim=1, dtype=torch.int32) - cf
        dest = (cidx + l * cf).to(torch.int64)
        lo = torch.empty_like(orig_before).scatter_(1, dest, orig_before)
        lo = lo[:, :l]
        hits = pos + 1 - lo

    if fast_top2 and kk <= 4:
        return _fast_top2_result(
            tgt, win, hits, lo, is_match, carry_beg, hit_tgt, hit_win,
            merge_tax_of_target, lineages, hits_min, hits_diff_frac,
            highest_rank, merge_rank, kk)

    # ---- best range per target: sort by (tgt, hits desc, pos) --------
    neg_hits0 = torch.where(is_match, -hits, I32_MAX)
    tgt1, neg1, pos1, end1, lo1 = _sort_rows(
        (tgt, neg_hits0, pos, win, lo), 3)
    col = torch.arange(l, dtype=torch.int32, device=dev).expand(b, l)
    is_cand = (tgt1 != I32_MAX) & ((col == 0) |
                                   (tgt1 != _shifted(tgt1, 1, -1)))
    tax = merge_tax_of_target[torch.clamp(tgt1, 0, ntax - 1).to(
        torch.int64)]
    is_cand = is_cand & (tax != 0)

    # ---- merge by taxon: sort by (tax, hits desc, pos) ---------------
    taxkey = torch.where(is_cand, tax, I32_MAX)
    neg2 = torch.where(is_cand, neg1, I32_MAX)
    taxkey2, neg2, pos2, tgt2, end2, lo2 = _sort_rows(
        (taxkey, neg2, pos1, tgt1, end1, lo1), 3)
    # taxon ids can be negative (sequence-level): column 0 always starts
    # a group
    is_rep = (taxkey2 != I32_MAX) & ((col == 0) |
                                     (taxkey2 != _shifted(taxkey2, 1, -1)))
    # the first insertion position of each taxon group by one suffix
    # min with per-group offsets g * L2 (rows.py:316-332), in int64:
    # JAX's int32 keys wrap once a row holds 2^31 / L2 groups (1,024 at
    # rows of 1 M slots), and equal these wherever they do not
    g = torch.cumsum(is_rep.to(torch.int64), dim=1)
    l2 = 1 << int(l).bit_length()
    v = torch.where(taxkey2 != I32_MAX, pos2 + g * l2, torch.iinfo(
        torch.int64).max)
    sufmin = torch.cummin(v.flip(1), dim=1).values.flip(1)
    # below L at the representatives, the only lanes read
    first_pos = (sufmin - g * l2).to(torch.int32)

    # ---- final ranking: hits desc, first insertion asc ---------------
    if kk <= 4 and l * l2 < 2**31:
        # neg * L2 + first_pos is a unique total order over the
        # representatives: kk masked min-reductions
        comp = torch.where(is_rep, neg2 * l2 + first_pos, I32_MAX)
        cols = (neg2, tgt2, taxkey2, end2, lo2)
        picked = [[] for _ in cols]
        oks = []
        for _ in range(kk):
            m = comp.min(dim=1, keepdim=True).values
            pick = comp == m
            oks.append(m[:, 0] != I32_MAX)
            for out, arr in zip(picked, cols):
                out.append(torch.where(pick, arr, 0).sum(
                    dim=1, dtype=torch.int32))
            comp = torch.where(pick, I32_MAX, comp)
        okc = torch.stack(oks, dim=1)
        neg3, tgt3, tax3, end3, lo3 = (torch.stack(x, dim=1)
                                       for x in picked)
    else:
        neg3 = torch.where(is_rep, neg2, I32_MAX)
        fp3 = torch.where(is_rep, first_pos, I32_MAX)
        neg3, _f, tgt3, tax3, end3, lo3 = (
            x[:, :kk] for x in _sort_rows(
                (neg3, fp3, tgt2, taxkey2, end2, lo2), 2))
        okc = neg3 != I32_MAX

    cand_tgt = torch.where(okc, tgt3, -1)
    cand_tax = torch.where(okc, tax3, 0)
    cand_hits = torch.where(okc, -neg3, 0)
    if carry_beg:
        cand_beg = torch.where(okc, lo3, 0)
    else:
        lo_sel = torch.clamp(lo3, 0, l - 1).to(torch.int64)
        cand_beg = torch.where(okc, torch.gather(win, 1, lo_sel), 0)
    cand_end = torch.where(okc, end3, 0)
    cls_tax = classify_candidates(
        cand_tgt, cand_tax, cand_hits, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank)
    return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg, cand_end,
                       cls_tax, *_hit_lists(hit_tgt, hit_win, dev))


def _fast_top2_result(tgt, win, hits, lo, is_match, carry_beg, hit_tgt,
                      hit_win, merge_tax_of_target, lineages, hits_min,
                      hits_diff_frac, highest_rank, merge_rank,
                      kk: int) -> QueryResult:
    """Top-k candidates without taxon merging (rows.py:376-467): slots
    arrive (tgt, win)-sorted with padding last, so target groups are
    contiguous runs. Each group's best range is the max of key = hits *
    L2 + (L2 - 1 - col), placed at the group's start by a suffix max
    with per-group offsets -g * L2^2; the candidates are the kk largest
    group maxima. The keys are int64 where L * L2^2 >= 2^31, as JAX
    widens them (``wide``), else int32."""
    b, l = tgt.shape
    dev = tgt.device
    l2 = 1 << int(l).bit_length()
    kb = l2 * l2
    kdt = torch.int64 if l * kb >= 2**31 else torch.int32
    neg_inf = torch.iinfo(kdt).min + 1
    col = torch.arange(l, dtype=torch.int32, device=dev).expand(b, l)
    key = hits.to(kdt) * l2 + (l2 - 1 - col).to(kdt)
    newt = (col == 0) | (tgt != _shifted(tgt, 1, -1))
    g = torch.cumsum(newt.to(kdt), dim=1, dtype=kdt)
    v = torch.where(is_match, key - g * kb, neg_inf)
    sufmax = torch.cummax(v.flip(1), dim=1).values.flip(1)
    comp = torch.where(newt & is_match, sufmax + g * kb, neg_inf)

    shift = int(l2).bit_length() - 1
    out = [[] for _ in range(4)]          # tgt, hits, beg, end
    for _ in range(kk):
        mx = comp.max(dim=1, keepdim=True).values
        ok = mx[:, 0] > 0
        bestkey = torch.where(ok, mx[:, 0], 0)
        bc = torch.clamp(l2 - 1 - (bestkey & (l2 - 1)), 0, l - 1).to(
            torch.int64)[:, None]
        t_b = torch.gather(tgt, 1, bc)[:, 0]
        w_b = torch.gather(win, 1, bc)[:, 0]
        lo_b = torch.gather(lo, 1, bc)[:, 0]
        if carry_beg:
            beg_b = lo_b                   # the begin window, carried
        else:
            beg_b = torch.gather(win, 1, torch.clamp(
                lo_b, 0, l - 1).to(torch.int64)[:, None])[:, 0]
        # tg is -1 exactly where ok is false, so the lookup gives taxon 0
        # there
        out[0].append(torch.where(ok, t_b, -1))
        out[1].append(torch.where(ok, bestkey >> shift, 0).to(torch.int32))
        out[2].append(torch.where(ok, beg_b, 0))
        out[3].append(torch.where(ok, w_b, 0))
        comp = torch.where(comp == mx, neg_inf, comp)
    cand_tgt, cand_hits, cand_beg, cand_end = (
        torch.stack(x, dim=1) for x in out)
    cand_tax, cls_tax = classify_with_taxa(
        cand_tgt, cand_hits, merge_tax_of_target, lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank)
    return QueryResult(cand_tgt, cand_tax, cand_hits, cand_beg, cand_end,
                       cls_tax, *_hit_lists(hit_tgt, hit_win, dev))


def query_step_rows(windows, valid, mwir, tables, hits_min, hits_diff_frac,
                    highest_rank, merge_rank, *, k: int, sketchlen: int,
                    windows_per_query: int, max_candidates: int,
                    walk_elems: int = 0, dedup_walk: int = 0,
                    fast_top2: bool = False, fused_candidates: bool = True,
                    emit_hits: bool = False,
                    pack_bits: int = 0) -> QueryResult:
    """Row-layout classification step (rows.py:904).

    windows: (B, Wq, W) u8 -- every read padded to Wq windows;
    valid: (B, Wq) chars per window (0 = padding window);
    mwir: (B,) contiguous-range length per read."""
    b, wq, w = windows.shape
    feats = sketch_windows(windows.reshape(b * wq, w),
                           valid.reshape(b * wq), k, sketchlen)
    feats = feats.reshape(b, wq * sketchlen)
    fused, alt = route(fused_candidates, fast_top2, max_candidates,
                        walk_elems, dedup_walk, emit_hits, wq * sketchlen,
                        tables.spf)
    tgt, win = probe_rows(feats, tables, alt_runs=alt, pack_bits=pack_bits)
    return rows_to_result(
        tgt, win, mwir, tables.merge_tax, tables.lineages, hits_min,
        hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, fused_candidates=fused,
        emit_hits=emit_hits, presorted_runs=alt, pack_bits=pack_bits)


def query_step_rows_multipart(windows, valid, mwir, parts, hits_min,
                              hits_diff_frac, highest_rank, merge_rank, *,
                              k: int, sketchlen: int, windows_per_query: int,
                              max_candidates: int, walk_elems: int = 0,
                              dedup_walk: int = 0, fast_top2: bool = False,
                              fused_candidates: bool = True,
                              emit_hits: bool = False,
                              pack_bits: int = 0) -> QueryResult:
    """Row-layout step over a multi-part database (rows.py:849-895):
    sketch once, probe every part's tables, concatenate the (B, F*spf_p)
    slot rows along the slot axis, then one ``rows_to_result``. The
    parts' runs differ in width, so the probes emit no alternating runs
    and the fused kernels sort each row whole (presorted 0, as JAX
    passes none). Taxon maps and lineages are the first part's: every
    part holds the same ones. All parts' slots pack with one
    ``pack_bits``."""
    b, wq, w = windows.shape
    feats = sketch_windows(windows.reshape(b * wq, w),
                           valid.reshape(b * wq), k, sketchlen)
    feats = feats.reshape(b, wq * sketchlen)
    tgts, wins = zip(*(probe_rows(feats, t, pack_bits=pack_bits)
                       for t in parts))
    tgt = torch.cat(tgts, dim=1)
    win = tgt if pack_bits else torch.cat(wins, dim=1)   # (pk, pk)
    t0 = parts[0]
    return rows_to_result(
        tgt, win, mwir, t0.merge_tax,
        t0.lineages, hits_min, hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2,
        fused_candidates=fused_candidates, emit_hits=emit_hits,
        pack_bits=pack_bits)


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


def _stage1(windows, valid, tables, k: int, sketchlen: int,
            infeed_packed: bool):
    """The sketch and bucket-probe stage of one batch -> (feats (B, F),
    idx (B*F,)): the rows (classed: cell addresses) that ``probe_rows``
    and ``probe_rows_head`` take as ``idx_pre``."""
    feats = _sketch_stage(windows, valid, k, sketchlen, infeed_packed)
    return feats, _bucket_idx(feats.reshape(-1), tables)


def _prefetched(windows_k, valid_k, tables, side, k: int, sketchlen: int,
                infeed_packed: bool):
    """Stage 1 of the pipelined scan (rows.py:1028-1060, JAX's prefetch
    carry) for each stacked batch: its sketch and bucket probe, issued on
    the ``side`` stream (device.SideStream) one batch ahead of the
    caller's stage 2. Yields (i, feats (B, F), idx (B*F,)) of batch i
    once batch i+1's stage 1 is issued and the current stream is ordered
    after batch i's; the caller has made the side stream follow the
    inputs (``side.follow``)."""
    def stage1(i):
        with side.run():
            return (*_stage1(windows_k[i], valid_k[i], tables, k, sketchlen,
                             infeed_packed), side.mark())

    nk = windows_k.shape[0]
    nxt = stage1(0)
    for i in range(nk):
        feats, idx, ev = nxt
        side.join(ev, feats, idx)
        if i + 1 < nk:
            nxt = stage1(i + 1)
        yield i, feats, idx


def _side(side, device):
    """The caller's side stream, or one of the device's own."""
    return side if side is not None else SideStream(device)


def query_step_rows_scan(windows_k, valid_k, mwir_k, tables, hits_min,
                         hits_diff_frac, highest_rank, merge_rank, *,
                         k: int, sketchlen: int, windows_per_query: int,
                         max_candidates: int, walk_elems: int = 0,
                         dedup_walk: int = 0, fast_top2: bool = False,
                         fused_candidates: bool = True, pack_bits: int = 0,
                         infeed_packed: bool = False, prefetch: bool = False,
                         side: SideStream | None = None) -> torch.Tensor:
    """K stacked row batches -> (K, B) int32 classified taxon ids
    (rows.py:958). ``infeed_packed``: windows_k holds 2-bit codes, four
    bases per byte, low bits first, unpacked here; valid_k and mwir_k
    may arrive as uint8. ``prefetch`` (JAX's software-pipelined scan, on
    a row layout; a CSR part ignores it, as JAX's does): batch i+1's
    sketch and bucket probe run on the ``side`` stream (the caller's, or
    a new one of the tables' device) while batch i's probe rows and
    candidates run on the current stream; the same results."""
    wq = windows_k.shape[2]
    fused, alt = route(fused_candidates, fast_top2, max_candidates,
                        walk_elems, dedup_walk, False, wq * sketchlen,
                        tables.spf)

    def stage2(i, feats, idx=None):
        tgt, win = probe_rows(feats, tables, alt_runs=alt,
                              pack_bits=pack_bits, idx_pre=idx)
        return rows_to_result(
            tgt, win, mwir_k[i], tables.merge_tax, tables.lineages, hits_min,
            hits_diff_frac, highest_rank, merge_rank,
            max_candidates=max_candidates, walk_elems=walk_elems,
            dedup_walk=dedup_walk, fast_top2=fast_top2,
            fused_candidates=fused, presorted_runs=alt,
            pack_bits=pack_bits).cls_tax

    if prefetch and not tables.csr:
        side = _side(side, windows_k.device)
        side.follow(windows_k, valid_k)
        return torch.stack([
            stage2(i, feats, idx) for i, feats, idx in _prefetched(
                windows_k, valid_k, tables, side, k, sketchlen,
                infeed_packed)])
    return torch.stack([
        stage2(i, _sketch_stage(windows_k[i], valid_k[i], k, sketchlen,
                                infeed_packed))
        for i in range(windows_k.shape[0])])


def _pack_bits32(over: torch.Tensor) -> torch.Tensor:
    """(B,) bool -> (ceil(B/32),) int32, read i in bit i % 32 of word
    i // 32 (rows.py:1379-1383)."""
    b = over.shape[0]
    nw = -(-b // 32)
    ob = torch.zeros(nw * 32, dtype=torch.int32, device=over.device)
    ob[:b] = over.to(torch.int32)
    sh = torch.arange(32, dtype=torch.int32, device=over.device)
    return (ob.reshape(nw, 32) << sh).sum(dim=1, dtype=torch.int32)


def _head_result(feats, idx, mwir, tables, hits_min, hits_diff_frac,
                 highest_rank, merge_rank, *, max_candidates: int,
                 walk_elems: int, dedup_walk: int, fast_top2: bool,
                 fused_candidates: bool, pack_bits: int):
    """Escalation phase 1 of one batch on its sketches and bucket probes
    (rows.py:1260-1275, :1364-1383): the head-only probe (B6) and its
    candidates -> (cls (B,), over (ceil(B/32),) bit words). Runs of rl =
    pow2(hsl) lanes, which B4 takes as presorted where they fill its
    padded row."""
    rl = 1 << max(int(tables.head_slots - 1).bit_length(), 0)
    presorted = rl if padded_width(feats.shape[1] * rl) == \
        feats.shape[1] * rl else 0
    pk, ov = probe_rows_head(feats, tables, alt_runs=rl,
                             pack_bits=pack_bits, idx_pre=idx)
    res = rows_to_result(
        pk, pk, mwir, tables.merge_tax, tables.lineages, hits_min,
        hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2,
        fused_candidates=fused_candidates, presorted_runs=presorted,
        pack_bits=pack_bits)
    return res.cls_tax, _pack_bits32(ov)


def query_step_rows_scan_head(windows_k, valid_k, mwir_k, tables, hits_min,
                              hits_diff_frac, highest_rank, merge_rank, *,
                              k: int, sketchlen: int, max_candidates: int,
                              walk_elems: int = 0, dedup_walk: int = 0,
                              fast_top2: bool = True,
                              fused_candidates: bool = True,
                              pack_bits: int = 0,
                              infeed_packed: bool = False,
                              prefetch: bool = False,
                              side: SideStream | None = None):
    """Escalation phase 1 (rows.py:1314-1430): the scan of
    ``query_step_rows_scan`` with one head row per probe (B6) and runs of
    rl = pow2(hsl) lanes, so the slot sort works on F*rl lanes instead of
    F*pow2(spf). -> (cls (K, B) int32, over (K, ceil(B/32)) int32 bit
    words, feats (K, B, F) int32, idx (K, B, F) int32): reads whose bit
    is set touched a bucket deeper than the head and must be redone at
    full depth (``query_step_rows_redo_scan`` on their saved feats and
    idx); the others are exact. ``prefetch``: stage 1 (sketch and bucket
    probe) of batch i+1 on the ``side`` stream beside batch i's phase 1,
    as ``query_step_rows_scan`` pipelines it. The JAX function returns
    feats and idx only with prefetch on, its device default; here they
    cost nothing."""
    nk, b, wq = windows_k.shape[:3]
    f = wq * sketchlen
    kw = dict(max_candidates=max_candidates, walk_elems=walk_elems,
              dedup_walk=dedup_walk, fast_top2=fast_top2,
              fused_candidates=fused_candidates, pack_bits=pack_bits)
    if prefetch:
        side = _side(side, windows_k.device)
        side.follow(windows_k, valid_k)
        stage1 = _prefetched(windows_k, valid_k, tables, side, k, sketchlen,
                             infeed_packed)
    else:
        stage1 = ((i, *_stage1(windows_k[i], valid_k[i], tables, k,
                               sketchlen, infeed_packed))
                  for i in range(nk))
    cls, over, feats_k, idx_k = [], [], [], []
    for i, feats, idx in stage1:
        c, o = _head_result(feats, idx, mwir_k[i], tables, hits_min,
                            hits_diff_frac, highest_rank, merge_rank, **kw)
        cls.append(c)
        over.append(o)
        feats_k.append(feats)
        idx_k.append(idx.reshape(b, f))
    return (torch.stack(cls), torch.stack(over), torch.stack(feats_k),
            torch.stack(idx_k))


def query_step_rows_scan_head_fused(windows_k, valid_k, mwir_k, redo_feats_k,
                                    redo_idx_k, redo_mwir_k, tables,
                                    hits_min, hits_diff_frac, highest_rank,
                                    merge_rank, *, k: int, sketchlen: int,
                                    max_candidates: int, walk_elems: int = 0,
                                    fast_top2: bool = True,
                                    fused_candidates: bool = True,
                                    pack_bits: int = 0,
                                    infeed_packed: bool = False,
                                    side: SideStream | None = None):
    """Escalation phases 1 and 2 in one dispatch (rows.py:1192-1305, JAX's
    fused escalation): iteration i classifies fresh batch i head-only on
    the current stream, with batch i+1's stage 1 prefetched on the
    ``side`` stream, and redoes slice i of earlier flagged reads at full
    depth (``query_step_rows_redo``: B7, then B4, on their saved feats
    and idx, redo_feats_k and redo_idx_k (K, B2, F), redo_mwir_k (K, B2))
    on the side stream too, after that stage 1, so that the redo runs
    beside phase 1. -> (cls1 (K, B), over (K, ceil(B/32)), feats (K, B,
    F), idx (K, B, F), cls2 (K, B2)), all ordered on the current
    stream."""
    nk, b, wq = windows_k.shape[:3]
    if wq != 1:
        raise ValueError("the fused escalation is the short-read scan path")
    kw = dict(max_candidates=max_candidates, walk_elems=walk_elems,
              fast_top2=fast_top2, fused_candidates=fused_candidates,
              pack_bits=pack_bits)
    side = _side(side, windows_k.device)
    side.follow(windows_k, valid_k, redo_feats_k, redo_idx_k, redo_mwir_k)
    cls1, over, feats_k, idx_k, cls2 = [], [], [], [], []
    for i, feats, idx in _prefetched(windows_k, valid_k, tables, side, k,
                                     sketchlen, infeed_packed):
        with side.run():
            cls2.append(query_step_rows_redo(
                redo_feats_k[i], redo_idx_k[i], redo_mwir_k[i], tables,
                hits_min, hits_diff_frac, highest_rank, merge_rank, **kw))
        c, o = _head_result(feats, idx, mwir_k[i], tables, hits_min,
                            hits_diff_frac, highest_rank, merge_rank,
                            dedup_walk=0, **kw)
        cls1.append(c)
        over.append(o)
        feats_k.append(feats)
        idx_k.append(idx.reshape(b, sketchlen))
    side.join(side.mark(), *cls2)
    return (torch.stack(cls1), torch.stack(over), torch.stack(feats_k),
            torch.stack(idx_k), torch.stack(cls2))


def query_step_rows_redo(feats, idx_c, mwir, tables, hits_min,
                         hits_diff_frac, highest_rank, merge_rank, *,
                         max_candidates: int, walk_elems: int = 0,
                         dedup_walk: int = 0, fast_top2: bool = True,
                         fused_candidates: bool = True,
                         pack_bits: int = 0) -> torch.Tensor:
    """Escalation phase 2 (rows.py:1079-1117, the body of
    ``_redo_body`` :1157): full-depth classification of (B, F) features
    whose feature rows phase 1 already found, so neither the sketch nor
    the bucket probe runs again. -> (B,) int32 classified taxa."""
    fused, alt = route(fused_candidates, fast_top2, max_candidates,
                        walk_elems, dedup_walk, False, feats.shape[1],
                        tables.spf)
    tgt, win = probe_rows(feats, tables, alt_runs=alt, pack_bits=pack_bits,
                          idx_pre=idx_c)
    return rows_to_result(
        tgt, win, mwir.to(torch.int32), tables.merge_tax, tables.lineages,
        hits_min, hits_diff_frac, highest_rank, merge_rank,
        max_candidates=max_candidates, walk_elems=walk_elems,
        dedup_walk=dedup_walk, fast_top2=fast_top2, fused_candidates=fused,
        presorted_runs=alt, pack_bits=pack_bits).cls_tax


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
