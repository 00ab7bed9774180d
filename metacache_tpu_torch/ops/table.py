# copied from metacache_tpu/ops/table.py (prefix_index cut: it reaches
# the JAX probe)
"""Feature -> location store, TPU-native layout.

The reference uses a pointer-chasing open-addressing multimap on CPU
(src/hash_multimap.hpp) and warpcore tables on GPU (src/gpu_hashmap.cu).
The TPU-native equivalent is two flat HBM arrays in CSR form — a
generalization of the reference's own GPU *query* table layout
(feature -> packed offset|size into one flat locations array,
src/gpu_hashmap.cu:647-661, 757-764):

  unique_features : (F,)   u32, ascending
  offsets         : (F+1,) i64
  locations       : (L,)   u64 packed (target_id << 32) | window_id

Locations within a bucket are ascending — the (tgt, win) sort invariant the
query path requires (location::operator<, src/database.hpp:151-156; the
post-merge per-bucket sort, src/host_hashmap.hpp:347-352).

Construction is sort-based (sort all (feature, location) pairs, then
run-length segment) — deterministic, TPU/XLA-friendly, and it yields the
sorted-bucket invariant for free. Probing is a vectorized branchless binary
search (device) instead of open-addressing pointer chases.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..config import MAX_SUPPORTED_LOCATIONS_PER_FEATURE

LOC_SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)


def _segment_sorted(sorted_keys: np.ndarray):
    """(unique keys, run lengths) of an ascending-sorted array, without
    np.unique's internal re-sort."""
    n = len(sorted_keys)
    if n == 0:
        return sorted_keys[:0], np.zeros(0, np.int64)
    new = np.empty(n, bool)
    new[0] = True
    np.not_equal(sorted_keys[1:], sorted_keys[:-1], out=new[1:])
    starts = np.nonzero(new)[0]
    counts = np.empty(len(starts), np.int64)
    counts[:-1] = np.diff(starts)
    counts[-1] = n - starts[-1]
    return sorted_keys[starts], counts


def pack_locations(targets: np.ndarray, wins: np.ndarray) -> np.ndarray:
    return (targets.astype(np.uint64) << np.uint64(32)) | \
        wins.astype(np.uint64)


def unpack_locations(locs: np.ndarray):
    return (locs >> np.uint64(32)).astype(np.uint32), \
        (locs & np.uint64(0xFFFFFFFF)).astype(np.uint32)


@dataclasses.dataclass
class FeatureTable:
    unique_features: np.ndarray   # (F,) u32 ascending
    offsets: np.ndarray           # (F+1,) i64
    locations: np.ndarray         # (L,) u64, ascending within each bucket
    max_locations_per_feature: int = MAX_SUPPORTED_LOCATIONS_PER_FEATURE

    @property
    def num_features(self) -> int:
        return len(self.unique_features)

    @property
    def num_locations(self) -> int:
        return len(self.locations)

    @property
    def max_bucket_size(self) -> int:
        if self.num_features == 0:
            return 0
        return int(np.max(np.diff(self.offsets)))

    def bucket_sizes(self) -> np.ndarray:
        return np.diff(self.offsets).astype(np.int64)

    # ------------------------------------------------------------------
    @staticmethod
    def build(features: np.ndarray, locations: np.ndarray,
              max_locations_per_feature: int =
              MAX_SUPPORTED_LOCATIONS_PER_FEATURE,
              presorted_within_feature: bool = False) -> "FeatureTable":
        """Sort-based construction from parallel (feature, location) arrays.

        Per-bucket truncation keeps the `max_locations_per_feature` smallest
        locations, i.e. the lowest (tgt, win). For a sequential build this
        equals the reference's insertion-order cap (targets are inserted in
        ascending id order; hash_multimap::shrink keeps the first entries,
        src/host_hashmap.hpp:598-603).

        `presorted_within_feature=True` asserts that for every feature its
        locations already appear in ascending order in the input stream —
        true for any build accumulation (targets are sketched in ascending
        (tgt, win) order). Then one radix sort of a packed
        (feature << 32 | index) u64 key replaces the full lexsort (~3x).
        """
        fdt = np.uint64 if np.asarray(features).dtype == np.uint64 \
            else np.uint32
        features = np.ascontiguousarray(features, dtype=fdt)
        locations = np.ascontiguousarray(locations, dtype=np.uint64)
        n = len(features)
        if presorted_within_feature and fdt == np.uint32 and \
                n < (1 << 32):
            key = (features.astype(np.uint64) << np.uint64(32)) \
                | np.arange(n, dtype=np.uint64)
            key = np.sort(key)
            order = (key & np.uint64(0xFFFFFFFF)).astype(np.int64)
            features = (key >> np.uint64(32)).astype(np.uint32)
            locations = locations[order]
        elif presorted_within_feature:
            order = np.argsort(features, kind="stable")
            features = features[order]
            locations = locations[order]
        else:
            order = np.lexsort((locations, features))
            features = features[order]
            locations = locations[order]

        cap = int(max_locations_per_feature)
        uniq, counts = _segment_sorted(features)
        if len(counts) and counts.max() > cap:
            # vectorized per-bucket truncation: keep positions < cap
            starts = np.zeros(len(counts), np.int64)
            np.cumsum(counts[:-1], out=starts[1:])
            within = np.arange(n, dtype=np.int64) - np.repeat(starts, counts)
            keep = within < cap
            features = features[keep]
            locations = locations[keep]
            uniq, counts = _segment_sorted(features)
        offsets = np.zeros(len(uniq) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return FeatureTable(uniq, offsets, locations, cap)

    # ------------------------------------------------------------------
    def merge(self, other: "FeatureTable") -> "FeatureTable":
        """Merge two tables (reference: hash_multimap bulk insert + per-
        bucket location sort, src/hash_multimap.hpp:636-680 +
        src/host_hashmap.hpp:347-352)."""
        f = np.concatenate([
            np.repeat(self.unique_features, np.diff(self.offsets)),
            np.repeat(other.unique_features, np.diff(other.offsets))])
        l = np.concatenate([self.locations, other.locations])
        return FeatureTable.build(f, l, self.max_locations_per_feature)

    # ------------------------------------------------------------------
    def remove_features_with_more_locations_than(self, n: int) -> int:
        """Reference: remove over-populated features
        (host_hashmap.hpp:480-502). Returns number of removed features."""
        sizes = np.diff(self.offsets)
        kill = sizes > n
        removed = int(np.count_nonzero(kill))
        if removed:
            self._remove_buckets(kill)
        return removed

    def remove_ambiguous_features(self, max_taxa: int,
                                  target_taxa_at_rank: np.ndarray) -> int:
        """Remove features whose locations span more than `max_taxa`
        distinct taxa at a rank (reference: host_hashmap.hpp:505-541).

        `target_taxa_at_rank` maps target_id -> taxon id at the chosen rank
        (0 = none).
        """
        tgts, _ = unpack_locations(self.locations)
        taxa = target_taxa_at_rank[tgts]
        sizes = np.diff(self.offsets)
        bucket_ids = np.repeat(np.arange(self.num_features), sizes)
        # count distinct taxa per bucket
        order = np.lexsort((taxa, bucket_ids))
        b = bucket_ids[order]
        t = taxa[order]
        newpair = np.ones(len(b), dtype=bool)
        newpair[1:] = (b[1:] != b[:-1]) | (t[1:] != t[:-1])
        distinct = np.bincount(b[newpair], minlength=self.num_features)
        kill = distinct > max_taxa
        removed = int(np.count_nonzero(kill))
        if removed:
            self._remove_buckets(kill)
        return removed

    def _remove_buckets(self, kill: np.ndarray):
        sizes = np.diff(self.offsets)
        keep_loc = np.repeat(~kill, sizes)
        self.locations = self.locations[keep_loc]
        self.unique_features = self.unique_features[~kill]
        sizes = sizes[~kill]
        self.offsets = np.zeros(len(sizes) + 1, dtype=np.int64)
        np.cumsum(sizes, out=self.offsets[1:])

    def shrink_all(self, n: int):
        """Truncate every bucket to its first n locations
        (reference: hash_multimap::shrink_all via
        host_hashmap::max_locations_per_feature, src/host_hashmap.hpp:454-466)."""
        sizes = np.diff(self.offsets)
        if not len(sizes) or sizes.max() <= n:
            return
        keep_counts = np.minimum(sizes, n)
        starts = self.offsets[:-1]
        keep = np.zeros(len(self.locations), bool)
        rows = np.repeat(np.arange(self.num_features), keep_counts)
        cols = np.arange(int(keep_counts.sum())) - np.repeat(
            np.cumsum(keep_counts) - keep_counts, keep_counts)
        keep[np.repeat(starts, keep_counts) + cols] = True
        self.locations = self.locations[keep]
        self.offsets = np.zeros(self.num_features + 1, np.int64)
        np.cumsum(keep_counts, out=self.offsets[1:])

    # ------------------------------------------------------------------
    def dense_locations(self, width: int):
        """Padded 2D location matrix (F, width) for row-gather probing.

        TPU gathers of whole rows lower ~1000x better than per-element
        gathers, so when F*width is affordable the locations are stored
        densely; buckets larger than `width` are truncated to their first
        `width` (lowest (tgt,win)) entries — callers choose
        width >= max_bucket to keep exactness.
        """
        from .table import unpack_locations as _up
        f = self.num_features
        lt2 = np.zeros((max(f, 1), width), np.int32)
        lw2 = np.zeros((max(f, 1), width), np.int32)
        ltgt, lwin = _up(self.locations)
        sizes = np.minimum(np.diff(self.offsets), width).astype(np.int64)
        if f and sizes.sum():
            rows = np.repeat(np.arange(f, dtype=np.int64), sizes)
            starts = np.zeros(f, np.int64)
            np.cumsum(sizes[:-1], out=starts[1:])
            cols = np.arange(int(sizes.sum()), dtype=np.int64) - \
                np.repeat(starts, sizes)
            src = np.repeat(self.offsets[:-1], sizes) + cols
            lt2[rows, cols] = ltgt[src]
            lw2[rows, cols] = lwin[src]
        return lt2, lw2

    def _fill_rows(self, out, col_t: int, col_w: int, width: int,
                   skip: int = 0, rows_sel=None, slot_bits: int = 0):
        """Scatter CSR locations [skip, skip+width) of selected buckets
        into out[:, col_t:...] / out[:, col_w:...] without materializing
        a full (F, max_bucket) dense matrix (RefSeq-scale tables would
        need tens of GB of host scratch otherwise).

        ``slot_bits > 0``: write packed pk = (tgt << bits) | win into
        col_t lanes only (col_w ignored) — one lane per slot."""
        if not self.num_features:
            return
        ltgt, lwin = unpack_locations(self.locations)
        all_sizes = np.diff(self.offsets)
        if rows_sel is None:
            rows_sel = np.arange(self.num_features, dtype=np.int64)
        sizes = np.clip(all_sizes[rows_sel] - skip, 0, width).astype(
            np.int64)
        total = int(sizes.sum())
        if not total:
            return
        rows = np.repeat(np.arange(len(rows_sel), dtype=np.int64), sizes)
        starts = np.zeros(len(rows_sel), np.int64)
        np.cumsum(sizes[:-1], out=starts[1:])
        cols = np.arange(total, dtype=np.int64) - np.repeat(starts, sizes)
        src = np.repeat(self.offsets[:-1][rows_sel] + skip, sizes) + cols
        if slot_bits:
            out[rows, col_t + cols] = ((ltgt[src].astype(np.int64)
                                        << slot_bits)
                                       | lwin[src]).astype(np.int32)
        else:
            out[rows, col_t + cols] = ltgt[src]
            out[rows, col_w + cols] = lwin[src]

    def fused_rows(self, width: int, slot_bits: int = 0):
        """One gatherable row per feature: [feature, count, tgt*W, win*W]
        — or [feature, count, pk*W] when ``slot_bits > 0`` (packed
        single-lane slots, half the row bytes).

        A single row gather then yields everything the probe needs —
        membership check, bucket size and all locations — instead of
        5+ separate small gathers (each near-serial on TPU).
        Row width = 2 + 2*width, padded to a multiple of 8 lanes.
        """
        assert self.unique_features.dtype != np.uint64, \
            "fused rows are 32-bit-feature layouts (u64 DBs probe CSR)"
        f = max(self.num_features, 1)
        spl = 1 if slot_bits else 2
        cols = 2 + spl * width
        # XLA's TPU row gather has a fast path only at >= 64 lanes
        # (measured: width 32 costs 3.4x width 64 for the same rows)
        cols_pad = max(64, ((cols + 7) // 8) * 8)
        out = np.zeros((f, cols_pad), np.int32)
        if self.num_features:
            out[:, 0] = self.unique_features.view(np.int32)
            out[:, 1] = np.minimum(np.diff(self.offsets),
                                   width).astype(np.int32)
            self._fill_rows(out, 2, 2 + width, width,
                            slot_bits=slot_bits)
        return out

    def fused_rows_two_tier(self, width: int, head_width: int,
                            slot_bits: int = 0):
        """Two-tier fused rows for skewed bucket-size distributions.

        Head: one row per feature [feature, count, ovf_idx, tgt*H, win*H]
        (H = head_width, count = FULL min(bucket, width) count).
        Overflow: one row per feature whose bucket exceeds H, holding
        locations H..width as [tgt*(W-H), win*(W-H)]; row 0 is a dummy
        all features without overflow point at. Memory is proportional
        to actual locations instead of F * max-bucket, which keeps the
        row-gather probe affordable for 100GB+ databases where the
        worst bucket (width up to 254) is ~100x the median.
        -> (head (F, pad8(3+2H)) i32, overflow (F_o+1, pad8(2(W-H))) i32)
        """
        assert self.unique_features.dtype != np.uint64, \
            "fused rows are 32-bit-feature layouts (u64 DBs probe CSR)"
        h = head_width
        f = max(self.num_features, 1)
        spl = 1 if slot_bits else 2
        cols_pad = max(64, ((3 + spl * h + 7) // 8) * 8)
        head = np.zeros((f, cols_pad), np.int32)
        sizes = np.minimum(np.diff(self.offsets), width).astype(np.int32) \
            if self.num_features else np.zeros(1, np.int32)
        if self.num_features:
            head[:, 0] = self.unique_features.view(np.int32)
            head[:, 1] = sizes
            self._fill_rows(head, 3, 3 + h, h, slot_bits=slot_bits)
        over = np.nonzero(sizes > h)[0]
        ow = width - h
        ocols_pad = max(64, ((spl * ow + 7) // 8) * 8)
        ovf = np.zeros((len(over) + 1, ocols_pad), np.int32)
        if len(over) and ow > 0:
            head[over, 2] = np.arange(1, len(over) + 1, dtype=np.int32)
            self._fill_rows(ovf[1:], 0, ow, ow, skip=h,
                            rows_sel=over.astype(np.int64),
                            slot_bits=slot_bits)
        return head, ovf

    def prefix_index(self, bits: int | None = None):
        """Prefix-offset acceleration for device probing: the CSR probe
        layout is not ported (the port probes through the bucket-row
        index of ops/probe.py::make_bucket_index)."""
        raise NotImplementedError(
            "the CSR probe's prefix index is not ported yet (ROADMAP "
            "queue A10)")

    def layout_bytes(self, kind, head: int, width: int) -> int:
        """Device bytes a staged layout would occupy (without building it)."""
        f = max(self.num_features, 1)
        if kind == "dense":
            return f * max(64, ((2 + 2 * width + 7) // 8) * 8) * 4
        if kind == "two_tier":
            sizes = np.diff(self.offsets) if self.num_features else \
                np.zeros(1, np.int64)
            n_over = int(np.count_nonzero(
                np.minimum(sizes, width) > head))
            ow = width - head
            return (f * max(64, ((3 + 2 * head + 7) // 8) * 8) * 4 +
                    (n_over + 1) * max(64, ((2 * ow + 7) // 8) * 8) * 4)
        # csr: features + offsets + unpacked tgt/win i32 arrays
        return f * 4 + (f + 1) * 4 + 2 * self.num_locations * 4

    def choose_layout(self, width: int, budget_bytes: int,
                      allow_dense: bool = True):
        """Pick the probe layout that fits a device-memory budget.

        -> ("dense", 0) | ("two_tier", head) | ("csr", 0); raises
        MemoryError when even CSR exceeds the budget (caller should
        advise -table-shards / -parts / -remove-overpopulated-features).

        The reference sizes its GPU tables from free VRAM minus a
        reserve (src/gpu_hashmap.cu:1101-1141); here the same budget
        instead selects among row layouts:
        - dense (1 fused row gather/probe) whenever it fits;
        - else two-tier (head + overflow row gathers): any head <= 30
          pads to the same 64-lane row, so candidate heads start at 30
          and step the pad boundaries; among fitting candidates the
          smallest total bytes wins (probe cost is gather-count-bound,
          identical for all heads);
        - else plain CSR (per-slot gathers — slow but minimal memory).
        """
        if allow_dense and \
                self.layout_bytes("dense", 0, width) <= budget_bytes:
            return ("dense", 0)
        best = None
        h = min(30, width - 1) if width > 1 else 1
        while 0 < h < width:
            b = self.layout_bytes("two_tier", h, width)
            if b <= budget_bytes and (best is None or b < best[0]):
                best = (b, h)
            h += 16           # next 64-lane pad boundary of 3+2h
        if best is not None:
            return ("two_tier", best[1])
        if self.layout_bytes("csr", 0, width) <= budget_bytes:
            return ("csr", 0)
        raise MemoryError(
            f"database part needs more device memory than the "
            f"{budget_bytes / 2**30:.1f} GiB budget even in CSR layout "
            f"({self.layout_bytes('csr', 0, width) / 2**30:.1f} GiB); "
            "use -table-shards N (shard over devices), -parts N + "
            "per-part query & merge, or cull with "
            "-remove-overpopulated-features / -max-locations-per-feature")

    def location_list_size_statistics(self):
        """(mean, stddev, skewness, max) of bucket sizes (reference:
        host_hashmap.hpp:376-409 via statistics_accumulator,
        src/stat_combined.hpp:36-112 — exact formulas incl. the n-1
        variance divisor)."""
        from ..utils.moments import StatisticsAccumulator
        s = np.diff(self.offsets).astype(np.float64)
        if len(s) == 0:
            return 0.0, 0.0, 0.0, 0
        acc = StatisticsAccumulator()
        acc.push_array(s)
        return acc.mean(), acc.stddev(), acc.skewness(), int(acc.max())
