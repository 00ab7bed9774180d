# copied from metacache_tpu/utils/moments.py:1-252 (the accumulators)
"""Statistical moment accumulators.

Faithful re-implementation of the reference's accumulator suite
(src/stat_moments.hpp:373-1044, src/stat_combined.hpp:36-112): running
power sums (s, s2, s3, s4) with push/pop/merge and the exact moment
formulas the reference prints (sample variance with the n-1 divisor,
skewness = cm3 / cm2^1.5, kurtosis = cm4 / cm2^2). Division by zero is
left to IEEE semantics on purpose — degenerate inputs print inf/-nan
exactly like the C++ binary does.

The reference also ships a GPU twin with atomic device-side updates
(src/stat_combined.cuh:41-120). Here the device-side equivalent is
``MomentsAccumulator.push_array`` / ``StatisticsAccumulator.push_array``:
bulk NumPy power-sum reductions over arrays that may have been computed
on-device (bucket sizes etc.) — one vectorized pass instead of atomics.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["MomentsAccumulator", "StatisticsAccumulator"]

_NEG_NAN = -float("nan")


def _div(a: float, b: float) -> float:
    """IEEE float division (0/0 = nan, x/0 = ±inf) — matches C++."""
    try:
        return a / b
    except ZeroDivisionError:
        if a == 0:
            return _NEG_NAN
        return math.inf if a > 0 else -math.inf


class MomentsAccumulator:
    """Running moments up to ``order`` (1..4).

    Reference: moments_accumulator<real_t, order>
    (src/stat_moments.hpp:373-1044). Push/pop/merge operate on plain
    power sums, so merging two accumulators is exact.
    """

    __slots__ = ("order", "n_", "s1", "s2", "s3", "s4")

    def __init__(self, order: int = 3, init: float | None = None):
        if not 1 <= order <= 4:
            raise ValueError("order must be in 1..4")
        self.order = order
        self.clear()
        if init is not None:
            # reference ctor moments_accumulator(t): sum_ = t, n_ = 0
            self.s1 = float(init)

    def clear(self):
        self.n_ = 0
        self.s1 = self.s2 = self.s3 = self.s4 = 0.0

    # -- collect ----------------------------------------------------------
    def push(self, x: float):
        x = float(x)
        self.n_ += 1
        self.s1 += x
        if self.order >= 2:
            x2 = x * x
            self.s2 += x2
            if self.order >= 3:
                self.s3 += x2 * x
                if self.order >= 4:
                    self.s4 += x2 * x2

    def pop(self, x: float):
        x = float(x)
        self.n_ -= 1
        self.s1 -= x
        if self.order >= 2:
            x2 = x * x
            self.s2 -= x2
            if self.order >= 3:
                self.s3 -= x2 * x
                if self.order >= 4:
                    self.s4 -= x2 * x2

    def push_array(self, xs):
        """Bulk push (vectorized twin of the GPU atomic_update loop,
        src/stat_combined.cu)."""
        xs = np.asarray(xs, dtype=np.float64).ravel()
        self.n_ += xs.size
        self.s1 += float(xs.sum())
        if self.order >= 2:
            x2 = xs * xs
            self.s2 += float(x2.sum())
            if self.order >= 3:
                self.s3 += float((x2 * xs).sum())
                if self.order >= 4:
                    self.s4 += float((x2 * x2).sum())

    def merge(self, other: "MomentsAccumulator"):
        self.n_ += other.n_
        self.s1 += other.s1
        self.s2 += other.s2
        self.s3 += other.s3
        self.s4 += other.s4

    # -- size -------------------------------------------------------------
    def size(self) -> int:
        return self.n_

    def empty(self) -> bool:
        return self.n_ < 1

    # -- results (reference formulas, incl. <1 / <2 guards) ---------------
    def sum(self) -> float:
        return self.s1

    def sum_2(self) -> float:
        return self.s2

    def sum_3(self) -> float:
        return self.s3

    def sum_4(self) -> float:
        return self.s4

    def raw_moment_1(self) -> float:
        return self.s1 if self.n_ < 1 else self.s1 / self.n_

    def mean(self) -> float:
        return self.raw_moment_1()

    def raw_moment_2(self) -> float:
        return self.s2 if self.n_ < 1 else self.s2 / self.n_

    def raw_moment_3(self) -> float:
        return self.s3 if self.n_ < 1 else self.s3 / self.n_

    def central_moment_2(self) -> float:
        if self.n_ < 1:
            return 0.0
        n = float(self.n_)
        return _div(self.s2 - (self.s1 * self.s1) / n, n - 1.0)

    def variance(self) -> float:
        return self.central_moment_2()

    def stddev(self) -> float:
        v = self.central_moment_2()
        # C++ sqrt(negative) = -nan; only degenerate pops can get here
        return math.sqrt(v) if v >= 0 else _NEG_NAN

    def central_moment_3(self) -> float:
        if self.n_ < 2:
            return 0.0
        n = float(self.n_)
        n2 = n * n
        return (n2 * self.s3 - 3.0 * n * (self.s1 * self.s2)
                + 2.0 * (self.s1 ** 3)) / (n * n2)

    def skewness(self) -> float:
        """cm3 / cm2^1.5 (reference: src/stat_moments.hpp:825-845).
        Degenerate distributions (cm2 == 0) follow IEEE: 0/0 = -nan."""
        if self.n_ < 2:
            return 0.0
        cm2 = self.central_moment_2()
        denom = cm2 ** 1.5 if cm2 >= 0 else float("nan")
        return _div(self.central_moment_3(), denom)

    def central_moment_4(self) -> float:
        if self.n_ < 2:
            return 0.0
        n = float(self.n_)
        n2 = n * n
        ss = self.s1 * self.s1
        return (n2 * n * self.s4 - 4.0 * n2 * self.s1 * self.s3
                + 6.0 * n * ss * self.s2 - 3.0 * ss * ss) / (n2 * n2)

    def kurtosis(self) -> float:
        n = float(self.n_)
        if self.n_ < 2:
            return 0.0
        cm2 = self.central_moment_2()
        ss = self.s1 * self.s1
        n2 = n * n
        cm4 = (n2 * n * self.s4 - 4.0 * n2 * self.s1 * self.s3
               + 6.0 * n * ss * self.s2 - 3.0 * ss * ss) / (n2 * n2)
        return _div(cm4, cm2 * cm2)

    def kurtosis_excess(self) -> float:
        return self.kurtosis() - 3.0


class StatisticsAccumulator:
    """max + 3rd-order moments (reference: statistics_accumulator,
    src/stat_combined.hpp:36-112) — the accumulator behind the
    bucket-size statistics in ``info statistics``."""

    __slots__ = ("max_", "moments_")

    def __init__(self, init: float | None = None):
        self.max_ = -math.inf if init is None else float(init)
        self.moments_ = MomentsAccumulator(3, init)

    def push(self, x: float):
        x = float(x)
        if x > self.max_:
            self.max_ = x
        self.moments_.push(x)

    def push_array(self, xs):
        xs = np.asarray(xs, dtype=np.float64).ravel()
        if xs.size:
            m = float(xs.max())
            if m > self.max_:
                self.max_ = m
        self.moments_.push_array(xs)

    def merge(self, other: "StatisticsAccumulator"):
        if other.max_ > self.max_:
            self.max_ = other.max_
        self.moments_.merge(other.moments_)

    def size(self) -> int:
        return self.moments_.size()

    def empty(self) -> bool:
        return self.moments_.empty()

    def max(self) -> float:
        return self.max_

    def sum(self) -> float:
        return self.moments_.sum()

    def mean(self) -> float:
        return self.moments_.mean()

    def stddev(self) -> float:
        return self.moments_.stddev()

    def variance(self) -> float:
        return self.moments_.variance()

    def skewness(self) -> float:
        return self.moments_.skewness()
