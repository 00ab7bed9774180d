"""Query results and the ranked-LCA classification of candidates.

Port of metacache_tpu/ops/pipeline.py: ``QueryResult`` (:64) and
``classify_candidates`` (:317-361),
with the same float32 threshold, cumprod include mask and first-index
argmax rank picks; ``classify_with_taxa`` also does the candidate-taxon
lookup before it (metacache_tpu/ops/rows.py:171-173).

CUDA tensors launch the hand-written kernel classify_lca
(csrc/classify.cu); CPU tensors take the plain versions below. The
kernel reads the lineage table in place at its row stride, a strided
(T, R) view included.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels


class QueryResult(NamedTuple):
    cand_tgt: torch.Tensor    # (B, K) i32, -1 = none
    cand_tax: torch.Tensor    # (B, K) i32 taxon id of candidate
    cand_hits: torch.Tensor   # (B, K) i32
    cand_beg: torch.Tensor    # (B, K) i32 window range begin
    cand_end: torch.Tensor    # (B, K) i32 window range end (inclusive)
    cls_tax: torch.Tensor     # (B,) i32 classified taxon id (0 = none)
    # the sorted slots, flat, for -allhits; (1,) zeros when not asked for
    hit_qid: torch.Tensor     # (B * L,) i32 row index (B = padding)
    hit_tgt: torch.Tensor     # (B * L,) i32
    hit_win: torch.Tensor     # (B * L,) i32


def _first_true(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 when none), as jnp.argmax
    of a bool array."""
    return torch.argmax(mask.to(torch.uint8), dim=1).to(torch.int32)


def _check_lca(cand_tgt, cand_hits, lineages, cand_tax=None,
               merge_tax=None):
    ts = [cand_tgt, cand_hits] + [t for t in (cand_tax,) if t is not None]
    if any(t.dtype != torch.int32 or t.dim() != 2 or t.shape != ts[0].shape
           for t in ts) or ts[0].shape[1] < 1:
        raise ValueError("cand_tgt, cand_hits and cand_tax must be int32 "
                         "tensors of one (B, K) shape, K >= 1")
    if lineages.dtype != torch.int32 or lineages.dim() != 2 or \
            lineages.shape[0] < 1 or not 1 <= lineages.shape[1] <= 32:
        raise ValueError(f"lineages must be an int32 (T, R) table, T >= 1, "
                         f"R <= 32: {tuple(lineages.shape)}")
    if merge_tax is not None and (merge_tax.dtype != torch.int32 or
                                  merge_tax.dim() != 1 or
                                  merge_tax.shape[0] < 1):
        raise ValueError("merge_tax must be a non-empty int32 vector")
    devs = {t.device for t in ts + [lineages] +
            [t for t in (merge_tax,) if t is not None]}
    if len(devs) != 1:
        raise ValueError("the candidates and tables must share one device")


def _launch_lca(cand_tgt, cand_hits, cand_tax, merge_tax, lineages,
                hits_min, hits_diff_frac, highest_rank, merge_rank):
    """classify_lca on CUDA tensors; ``cand_tax`` None: the lookup form,
    -> (cand_tax, cls_tax). ``lineages`` is read in place, strided rows
    included (copied only where a row's ranks are not adjacent or rows
    overlap)."""
    b, k = cand_tgt.shape
    dev = cand_tgt.device
    cand_tgt, cand_hits = cand_tgt.contiguous(), cand_hits.contiguous()
    if lineages.stride(1) != 1 or lineages.stride(0) < lineages.shape[1]:
        lineages = lineages.contiguous()
    cls = torch.empty((b,), dtype=torch.int32, device=dev)
    if cand_tax is None:
        merge_tax = merge_tax.contiguous()
        cand_tax = torch.empty((b, k), dtype=torch.int32, device=dev)
        tax_in, lookup = None, (merge_tax.data_ptr(), merge_tax.shape[0],
                                cand_tax.data_ptr())
    else:
        cand_tax = cand_tax.contiguous()
        tax_in, lookup = cand_tax.data_ptr(), (None, 0, None)
    if b:
        mt, ntax, tax_out = lookup
        kernels.CLASSIFY_LCA(
            cand_tgt.data_ptr(), cand_hits.data_ptr(), tax_in, mt, ntax,
            lineages.data_ptr(), lineages.shape[0], lineages.shape[1],
            lineages.stride(0), b, k, int(hits_min), float(hits_diff_frac),
            int(highest_rank), int(merge_rank), tax_out, cls.data_ptr())
    return cand_tax, cls


def classify_candidates(cand_tgt, cand_tax, cand_hits, lineages,
                        hits_min: int, hits_diff_frac: float,
                        highest_rank: int, merge_rank: int) -> torch.Tensor:
    """Ranked LCA of the top candidates (reference: classify,
    src/classification.cpp:146-189): the lowest rank >= rank(cand0.tax)
    at which all included candidates' lineages agree with candidate 0's.
    (B, K) int32 candidates, (T, R) int32 lineages -> (B,) int32 taxa."""
    _check_lca(cand_tgt, cand_hits, lineages, cand_tax=cand_tax)
    if not cand_tgt.is_cuda:
        return classify_candidates_plain(
            cand_tgt, cand_tax, cand_hits, lineages, hits_min,
            hits_diff_frac, highest_rank, merge_rank)
    return _launch_lca(cand_tgt, cand_hits, cand_tax, None, lineages,
                       hits_min, hits_diff_frac, highest_rank,
                       merge_rank)[1]


def classify_with_taxa(cand_tgt, cand_hits, merge_tax, lineages,
                       hits_min: int, hits_diff_frac: float,
                       highest_rank: int, merge_rank: int) -> tuple:
    """The candidates' taxa, ``merge_tax`` of each target where it is one
    (cand_tgt >= 0, clamped into the table), else 0, and their
    classify_candidates -> (cand_tax, cls_tax)."""
    _check_lca(cand_tgt, cand_hits, lineages, merge_tax=merge_tax)
    if not cand_tgt.is_cuda:
        return classify_with_taxa_plain(
            cand_tgt, cand_hits, merge_tax, lineages, hits_min,
            hits_diff_frac, highest_rank, merge_rank)
    return _launch_lca(cand_tgt, cand_hits, None, merge_tax, lineages,
                       hits_min, hits_diff_frac, highest_rank, merge_rank)


def classify_with_taxa_plain(cand_tgt, cand_hits, merge_tax, lineages,
                             hits_min: int, hits_diff_frac: float,
                             highest_rank: int, merge_rank: int) -> tuple:
    """classify_with_taxa in torch ops (the plain version of
    classify_lca's lookup form)."""
    ntax = merge_tax.shape[0]
    cand_tax = torch.where(
        cand_tgt >= 0,
        merge_tax[torch.clamp(cand_tgt, 0, ntax - 1).to(torch.int64)], 0)
    return cand_tax, classify_candidates_plain(
        cand_tgt, cand_tax, cand_hits, lineages, hits_min, hits_diff_frac,
        highest_rank, merge_rank)


def classify_candidates_plain(cand_tgt, cand_tax, cand_hits, lineages,
                              hits_min: int, hits_diff_frac: float,
                              highest_rank: int,
                              merge_rank: int) -> torch.Tensor:
    """classify_candidates in torch ops (the plain version of
    classify_lca)."""
    num_ranks = lineages.shape[1]
    dev = cand_tgt.device
    exists = cand_tax != 0
    hits0 = cand_hits[:, 0]
    valid0 = exists[:, 0] & (hits0 >= hits_min)
    # a fill, not a host copy: the summary path copies nothing pageable
    frac = torch.full((), hits_diff_frac, dtype=torch.float32, device=dev)
    threshold = torch.where(hits0 > hits_min,
                            (hits0 - hits_min).to(torch.float32) * frac,
                            torch.zeros((), dtype=torch.float32, device=dev))
    include = cand_hits.to(torch.float32) > threshold[:, None]
    include[:, 0] = True
    include = torch.cumprod((include & exists).to(torch.int32),
                            dim=1).to(torch.bool)

    tgt0 = torch.clamp(cand_tgt, min=0).to(torch.int64)
    lin = lineages[tgt0]                          # (B, K, R)
    lin = torch.where(exists[:, :, None], lin, 0)
    lin0 = lin[:, 0, :]                           # (B, R)

    ranks = torch.arange(num_ranks, dtype=torch.int32, device=dev)[None, :]
    elig0 = (lin0 != 0) & (ranks >= merge_rank)
    r0 = torch.where(elig0.any(dim=1), _first_true(elig0), num_ranks)

    agree = (lin == lin0[:, None, :]) | ~include[:, :, None]
    all_agree = agree.all(dim=1) & (lin0 != 0)
    eligible = all_agree & (ranks >= r0[:, None])
    has = eligible.any(dim=1)
    lca_rank = torch.where(has, _first_true(eligible), num_ranks)
    lca_tax = lin0.gather(
        1, torch.clamp(lca_rank, max=num_ranks - 1)[:, None].to(torch.int64)
    )[:, 0]
    ok = valid0 & has & (lca_rank <= highest_rank)
    return torch.where(ok, lca_tax, 0).to(torch.int32)


def concat_results(results, per_launch: int, rows: int) -> QueryResult:
    """The QueryResults of launches of ``per_launch`` rows (the last may
    be shorter), in row order, as one of ``rows`` rows: the per-hit
    lists' row ids move by each launch's first row, and their padding
    id (a launch's row count) becomes ``rows``. The per-row fields of
    every result must lie on one device, and so must the per-hit lists."""
    qids = []
    for i, res in enumerate(results):
        b = res.cls_tax.shape[0]
        q = res.hit_qid
        qids.append(torch.where(q == b, rows, q + i * per_launch))
    return QueryResult(*(torch.cat(x) for x in zip(*(
        r[:6] for r in results))), torch.cat(qids),
        torch.cat([r.hit_tgt for r in results]),
        torch.cat([r.hit_win for r in results]))
