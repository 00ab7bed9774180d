# copied from metacache_tpu/classify/classification.py
"""Host-side classification: ranked-LCA over candidates, ground truth.

Port of classify / ground_truth (src/classification.cpp:105-295). The hot
path classifies on device (ops.pipeline.classify_candidates); this host
version serves the merge mode, the coverage-percentile re-classification
pass, and as a cross-check oracle for the device implementation.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from ..seqio.ids import (SequenceIdType, extract_accession_string,
                         extract_taxon_id)
from ..taxonomy.model import Rank, Taxon, TaxonomyCache, ranked_lca
from ..config import ClassificationOptions


@dataclasses.dataclass
class HostCandidate:
    tax: Optional[Taxon]
    tgt: int
    hits: int
    beg: int = 0
    end: int = 0


def classify(taxonomy: TaxonomyCache, opt: ClassificationOptions,
             hits_min: int, candidates: list[HostCandidate],
             lowest: Rank, highest: Rank) -> Optional[Taxon]:
    """Reference: classify (src/classification.cpp:146-189)."""
    if not candidates or candidates[0].tax is None:
        return None
    if candidates[0].hits < hits_min:
        return None
    lca = candidates[0].tax
    threshold = (candidates[0].hits - hits_min) * opt.hits_diff_fraction \
        if candidates[0].hits > hits_min else 0.0

    top_ranks = (taxonomy.cached_ranks_of_target(candidates[0].tgt)
                 if 0 <= candidates[0].tgt < taxonomy.target_count
                 else taxonomy.cached_ranks(candidates[0].tax))
    for c in candidates[1:]:
        if c.hits > threshold:
            cand_ranks = (taxonomy.cached_ranks_of_target(c.tgt)
                          if 0 <= c.tgt < taxonomy.target_count
                          else taxonomy.cached_ranks(c.tax))
            lca = ranked_lca(top_ranks, cand_ranks, Rank(lca.rank))
            if lca is None or lca.rank > highest:
                return None
        else:
            break
    return lca if (lca is not None and lca.rank <= highest) else None


def ground_truth(taxonomy: TaxonomyCache, header: str) -> Optional[Taxon]:
    """Reference: ground_truth (src/classification.cpp:105-137)."""
    tax = taxonomy.taxon_with_name(
        extract_accession_string(header, SequenceIdType.NCBI_ACC_VER))
    if tax:
        return taxonomy.cached_next_ranked_ancestor(tax)
    tax = taxonomy.taxon_with_similar_name(
        extract_accession_string(header, SequenceIdType.NCBI_ACC))
    if tax:
        return taxonomy.cached_next_ranked_ancestor(tax)
    tax = taxonomy.taxon_with_id(extract_taxon_id(header))
    if tax:
        return taxonomy.cached_next_ranked_ancestor(tax)
    tax = taxonomy.taxon_with_name(header)
    if tax:
        return taxonomy.cached_next_ranked_ancestor(tax)
    tax = taxonomy.taxon_with_name(
        extract_accession_string(header, SequenceIdType.LEADING_WORD))
    if tax:
        return taxonomy.cached_next_ranked_ancestor(tax)
    tax = taxonomy.taxon_with_name(
        extract_accession_string(header, SequenceIdType.FILENAME))
    if tax:
        return taxonomy.cached_next_ranked_ancestor(tax)
    return None


def evaluate_classification(best: Optional[Taxon],
                            truth: Optional[Taxon],
                            taxonomy: TaxonomyCache,
                            precision: bool, taxon_coverage: bool,
                            statistics) -> None:
    """Reference: evaluate_classification (src/classification.cpp:272-295)."""
    if precision:
        lca = taxonomy.cached_ranked_lca(best, truth)
        lowest_correct = Rank(lca.rank) if lca is not None else Rank.NONE
        statistics.assign_known_correct(
            Rank(best.rank) if best is not None else Rank.NONE,
            Rank(truth.rank) if truth is not None else Rank.NONE,
            lowest_correct)
        if taxon_coverage:
            update_coverage_statistics(taxonomy, best, truth, statistics)
    else:
        statistics.assign(Rank(best.rank) if best is not None else Rank.NONE)


def update_coverage_statistics(taxonomy: TaxonomyCache,
                               best: Optional[Taxon],
                               truth: Optional[Taxon], statistics) -> None:
    """Reference: update_coverage_statistics
    (src/classification.cpp:233-263)."""
    if truth is None:
        return
    for tax in taxonomy.cached_ranks(truth):
        if tax is None:
            continue
        r = Rank(tax.rank)
        covered = taxonomy.covers(tax)
        unclassified_on_rank = best is None or r < best.rank
        cov = statistics.coverage(r)
        if covered:
            if unclassified_on_rank:
                cov.fn += 1
            else:
                cov.tp += 1
        else:
            if unclassified_on_rank:
                cov.tn += 1
            else:
                cov.fp += 1
