# copied from metacache_tpu/core/candidates.py
"""NumPy/scalar oracle for candidate generation.

Mirrors the reference's contiguous-window-range sweep and top-k candidate
insertion (src/candidate_generation.hpp:47-252) exactly, including
tie-breaking: the best range for a target is the *first* range achieving the
maximal hit count, and equal-hit candidates keep insertion order (targets are
encountered in ascending (tgt, win) order of the sorted match list).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterable, Optional

import numpy as np


@dataclasses.dataclass
class WindowRange:
    """Inclusive [beg, end] window index range
    (reference: window_range, src/candidate_structs.hpp:42-71)."""
    beg: int = 0
    end: int = 0

    @property
    def size(self) -> int:
        return self.end - self.beg + 1


@dataclasses.dataclass
class MatchCandidate:
    """Reference: match_candidate (src/candidate_structs.hpp:80-104)."""
    tax: object = None          # taxonomy node (or None)
    tgt: int = 0xFFFFFFFF
    hits: int = 0
    pos: WindowRange = dataclasses.field(default_factory=WindowRange)


@dataclasses.dataclass
class CandidateGenerationRules:
    """Reference: candidate_generation_rules (src/candidate_structs.hpp:113-125)."""
    max_windows_in_range: int = 3
    max_candidates: int = 2 ** 62       # "unlimited"
    merge_below_is_sequence: bool = True
    # resolver: tgt -> taxon for merge at/below sequence rank
    taxon_of_target: Optional[Callable[[int], object]] = None
    # resolver: tgt -> lowest ranked ancestor >= mergeBelow rank
    lowest_ranked_ancestor: Optional[Callable[[int], object]] = None


def contiguous_window_ranges(matches: Iterable[tuple[int, int]],
                             num_windows: int):
    """Best contiguous window range per target.

    `matches` must be sorted by (tgt, win); duplicates count as extra hits.
    Yields one MatchCandidate per target, in target order
    (reference: for_all_contiguous_window_ranges,
    src/candidate_generation.hpp:47-108).
    """
    matches = list(matches)
    if not matches:
        return
    fst = 0
    cur = MatchCandidate(tgt=matches[0][0], hits=1,
                         pos=WindowRange(matches[0][1], matches[0][1]))
    hits = 1
    for lst in range(1, len(matches)):
        tgt, win = matches[lst]
        if tgt == cur.tgt:
            hits += 1
            while fst != lst and (win - matches[fst][1]) >= num_windows:
                hits -= 1
                fst += 1
            if hits > cur.hits:
                cur.hits = hits
                cur.pos = WindowRange(matches[fst][1], win)
        else:
            yield cur
            fst = lst
            hits = 1
            cur = MatchCandidate(tgt=tgt, hits=1, pos=WindowRange(win, win))
    yield cur


class BestDistinctCandidates:
    """Top candidates sorted by hits, distinct targets (or distinct taxa when
    merging below a rank).

    Reference: best_distinct_matches_in_contiguous_window_ranges
    (src/candidate_generation.hpp:136-252).
    """

    def __init__(self, rules: CandidateGenerationRules):
        self.rules = rules
        self.top: list[MatchCandidate] = []

    def insert_matches(self, matches: Iterable[tuple[int, int]]):
        for cand in contiguous_window_ranges(
                matches, self.rules.max_windows_in_range):
            self.insert(cand)

    def insert(self, cand: MatchCandidate):
        rules = self.rules
        top = self.top
        # early exit (reference :178)
        if len(top) == rules.max_candidates and top and \
                top[-1].hits >= cand.hits:
            return
        if cand.tax is None:
            if not rules.merge_below_is_sequence:
                cand.tax = rules.lowest_ranked_ancestor(cand.tgt)
            else:
                cand.tax = rules.taxon_of_target(cand.tgt)
        if cand.tax is None:
            return

        if rules.merge_below_is_sequence:
            # upper_bound on hits descending => stable insert after equals
            i = _upper_bound_desc(top, cand.hits)
            if i != len(top) or len(top) < rules.max_candidates:
                top.insert(i, cand)
                del top[rules.max_candidates:]
        else:
            # above sequence level a taxon may come from several targets
            for i, c in enumerate(top):
                if c.tax is cand.tax:
                    if cand.hits > c.hits:
                        top[i] = cand
                        # re-sort the prefix [0, i] by hits descending (stable)
                        pre = top[:i + 1]
                        pre.sort(key=lambda c: -c.hits)
                        top[:i + 1] = pre
                    return
            j = _upper_bound_desc(top, cand.hits)
            if j != len(top) or len(top) < rules.max_candidates:
                top.insert(j, cand)
                del top[rules.max_candidates:]


def _upper_bound_desc(top: list[MatchCandidate], hits: int) -> int:
    """First index whose hits < `hits` (list is sorted descending)."""
    lo, hi = 0, len(top)
    while lo < hi:
        mid = (lo + hi) // 2
        if top[mid].hits >= hits:
            lo = mid + 1
        else:
            hi = mid
    return lo


def generate_candidates(matches, rules: CandidateGenerationRules):
    """Sorted top candidates for one query's (tgt, win)-sorted match list."""
    gen = BestDistinctCandidates(rules)
    gen.insert_matches(matches)
    return gen.top
