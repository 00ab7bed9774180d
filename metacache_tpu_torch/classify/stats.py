# copied from metacache_tpu/classify/stats.py
"""Per-rank classification statistics.

Mirrors classification_statistics (src/classification_statistics.hpp:41-238):
cumulative counts "on rank r and below", precision/sensitivity, plus the
taxon-coverage confusion counts (src/stat_confusion.hpp).
"""
from __future__ import annotations

import numpy as np

from ..taxonomy.model import NUM_RANKS, Rank


class ConfusionStatistics:
    """Reference: confusion_statistics (src/stat_confusion.hpp)."""

    def __init__(self):
        self.tp = 0
        self.fp = 0
        self.tn = 0
        self.fn = 0

    def total(self) -> int:
        return self.tp + self.fp + self.tn + self.fn


class ClassificationStatistics:
    def __init__(self):
        n = NUM_RANKS + 1
        self.assigned_ = np.zeros(n, dtype=np.int64)
        self.known_ = np.zeros(n, dtype=np.int64)
        self.correct_ = np.zeros(n, dtype=np.int64)
        self.wrong_ = np.zeros(n, dtype=np.int64)
        self.coverage_ = [ConfusionStatistics() for _ in range(n)]

    # -- counting --------------------------------------------------------
    def assign(self, assigned: Rank):
        self.assigned_[int(assigned)] += 1

    def assign_known_correct(self, assigned: Rank, known: Rank,
                             correct: Rank):
        """Reference: :88-107."""
        self.assign(assigned)
        if correct < assigned:
            correct = assigned
        if correct < known:
            correct = known
        self.known_[int(known)] += 1
        if known != Rank.NONE:
            self.correct_[int(correct)] += 1
            if correct > known and correct > assigned:
                self.wrong_[int(correct) - 1] += 1

    # -- aggregates ------------------------------------------------------
    def assigned(self, r: Rank | None = None) -> int:
        hi = int(Rank.ROOT) if r is None else int(r)
        return int(self.assigned_[:hi + 1].sum())

    def unassigned(self) -> int:
        return int(self.assigned_[int(Rank.NONE)])

    def total(self) -> int:
        return self.assigned() + self.unassigned()

    def known(self, r: Rank | None = None) -> int:
        hi = int(Rank.ROOT) if r is None else int(r)
        return int(self.known_[:hi + 1].sum())

    def unknown(self) -> int:
        return int(self.known_[int(Rank.NONE)])

    def correct(self, r: Rank | None = None) -> int:
        hi = int(Rank.ROOT) if r is None else int(r)
        return int(self.correct_[:hi + 1].sum())

    def wrong(self, r: Rank) -> int:
        return int(self.wrong_[int(r):int(Rank.ROOT) + 1].sum())

    # -- rates -----------------------------------------------------------
    def classification_rate(self, r: Rank) -> float:
        t = self.total()
        return self.assigned(r) / t if t else 0.0

    def unclassified_rate(self) -> float:
        t = self.total()
        return self.unassigned() / t if t else 0.0

    def known_rate(self, r: Rank | None = None) -> float:
        t = self.total()
        return (self.known(r) / t) if t else 0.0

    def unknown_rate(self) -> float:
        t = self.total()
        return self.unknown() / t if t else 0.0

    def sensitivity(self, r: Rank) -> float:
        k = self.known(r)
        return self.correct(r) / k if k else 0.0

    def precision_(self, r: Rank) -> float:
        tot = self.correct(r) + self.wrong(r)
        return self.correct(r) / tot if tot else 0.0

    def coverage(self, r: Rank) -> ConfusionStatistics:
        return self.coverage_[int(r)]
