# copied from metacache_tpu/classify/abundance.py
"""Taxon read-count maps and abundance estimation.

Mirrors the reference exactly (src/classification.cpp:300-374), including
its iteration orders and integer weight truncation, so estimated counts are
bit-identical:

- the count map is ordered by (rank DESC, taxon id ASC)
  (rank_higher, src/classification.hpp:47-53);
- taxa below the estimation rank are pruned upward into their lowest ranked
  ancestor at/above the rank;
- sub-tree weights accumulate leaf->root with *integer* (query_id) weights;
- parent counts are distributed to children proportionally to
  (child count + child subtree weight) / parent subtree weight,
  traversing root->leaf.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ..taxonomy.model import NUM_RANKS, Rank, Taxon, TaxonomyCache


def sort_tax_counts(tax_counts: Dict[Taxon, float]
                    ) -> List[Tuple[Taxon, float]]:
    """Order like taxon_count_map: rank desc, id asc."""
    return sorted(tax_counts.items(),
                  key=lambda tc: (-int(tc[0].rank), tc[0].id))


def estimate_abundance(taxonomy: TaxonomyCache,
                       tax_counts: Dict[Taxon, float],
                       rank: Rank) -> Dict[Taxon, float]:
    """Reference: estimate_abundance (src/classification.cpp:304-374)."""
    counts = dict(tax_counts)

    if rank != Rank.SEQUENCE:
        # prune taxa below the estimation rank (map order: rank desc, so
        # "below rank" sorts after lower_bound of rank-1)
        for tax in [t for t in _ordered(counts) if int(t.rank) < int(rank)]:
            lineage = taxonomy.cached_ranks(tax)
            ancestor = None
            idx = int(rank)
            while ancestor is None and idx < NUM_RANKS:
                ancestor = lineage[idx]
                idx += 1
            if ancestor is not None:
                counts[ancestor] = counts.get(ancestor, 0.0) + counts[tax]
                del counts[tax]

    tax_children: Dict[Taxon, List[Taxon]] = {}
    tax_weights: Dict[Taxon, int] = {t: 0 for t in counts}

    # leaf -> root (reverse of rank-desc order = rank asc)
    for tax in reversed(_ordered(counts)):
        lineage = taxonomy.cached_ranks(tax)
        idx = int(tax.rank) + 1
        while idx < NUM_RANKS:
            parent = lineage[idx]
            idx += 1
            if parent is not None and parent in tax_weights:
                # integer truncation matches the reference's query_id weights
                tax_weights[parent] += int(tax_weights[tax] + counts[tax])
                tax_children.setdefault(parent, []).append(tax)
                break

    # root -> leaf: distribute parent counts to children, erase parents
    for tax in _ordered(counts):
        if tax not in counts:
            continue
        children = tax_children.get(tax)
        if children:
            sum_children = tax_weights[tax]
            for child in children:
                counts[child] += counts[tax] * \
                    (counts[child] + tax_weights[child]) / sum_children
            del counts[tax]
    return counts


def _ordered(counts: Dict[Taxon, float]) -> List[Taxon]:
    return [t for t, _ in sorted(counts.items(),
                                 key=lambda tc: (-int(tc[0].rank), tc[0].id))]
