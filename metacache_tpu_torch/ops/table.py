# copied from metacache_tpu/ops/table.py: the host CSR table (build,
# merge, culls) and the host rows that MC_DEVICE_LAYOUT=0 stages; the
# device layout rule is table_device.py's in the port's bytes
# (device_layout below), with the CSR layout where no row layout fits.
# Cut: prefix_index (no runtime path of JAX reaches the 1-D prefix
# probe), the host choose_layout rule and the helpers nothing calls.
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

    def dense_rows_bytes(self, width: int) -> int:
        """Bytes of the dense rows of ``width`` (tgt, win) lane pairs, as
        metacache_tpu's layout_bytes("dense") counts them: the measure
        MC_DENSE_LIMIT caps (runner.py:541-542)."""
        return max(self.num_features, 1) * \
            max(64, ((2 + 2 * width + 7) // 8) * 8) * 4


# ---------------------------------------------------------------------
# The device layout rule of metacache_tpu/ops/table_device.py
# (_layout_and_fill, :975-991), with the port's row bytes: the card has
# no 128-lane tiling, so a row of c lanes occupies 4 * pad64(c) bytes
# whether or not it is pair-packed. The device builder
# (ops/table_device.py) and the host rows of MC_DEVICE_LAYOUT=0
# (device_layout below) both choose by it.

# copied from metacache_tpu/ops/table_device.py:688-689
def _pad64(c: int) -> int:
    return max(64, ((c + 7) // 8) * 8)


# copied from metacache_tpu/ops/table_device.py:790-797
def _quantize(n: int, min_bits: int) -> int:
    """Round n up to ~3 significant bits so static shapes (and their
    multi-minute remote compiles) are shared across database sizes;
    padding elements/rows are sentinels that never match a probe."""
    if n <= 0:
        return 1 << min_bits
    q = 1 << max(min_bits, n.bit_length() - 4)
    return -(-n // q) * q


# copied from metacache_tpu/ops/table_device.py:801-815, with row_b the
# port's unpadded, unpaired row bytes and without the u64 meta lane. JAX's
# row bytes equal these for rows of at most 64 lanes and for multiples of
# 128; for other widths above 64 lanes a budget can pick another head or
# layout than JAX does.
def _bytes_for_fn(nf_pad, spf, spl, wide: bool = False):
    """Layout bytes for head width hd + n_over overflow rows; spl =
    lanes per slot (1 when slot-packed, 2 otherwise); wide = u64
    features (two meta lanes for the feature value,
    table_device.py:801-805)."""
    ex = 1 if wide else 0

    def row_b(c):
        return c * 4

    def bytes_for(hd, n_over):
        if hd == spf:                              # dense layout
            return nf_pad * row_b(_pad64(2 + ex + spl * spf)) + 512
        return (nf_pad * row_b(_pad64(3 + ex + spl * hd)) +
                (_quantize(n_over, 10) + 1) *
                row_b(_pad64(spl * (spf - hd))))
    return bytes_for


# copied from metacache_tpu/ops/table_device.py:759-787
def _choose_head(spf, cum_over, bytes_for, budget_bytes, what,
                 slot_packed: bool = False):
    """Smallest-footprint two-tier head width that fits the budget.

    Sweeps narrow heads as well as a row-width ladder (61 + 32k slots
    when slot-packed: 3 meta lanes + H slots fill 64-lane rows exactly;
    30 + 16k otherwise) so a tight HBM budget can still fit a layout
    instead of erroring."""
    if slot_packed:
        cands = [h for h in (13, 29, 45) if 0 < h < spf]
        hcand, step = min(61, spf - 1), 32
    else:
        cands = [h for h in (6, 14, 22) if 0 < h < spf]
        hcand, step = min(30, spf - 1), 16
    while 0 < hcand < spf:
        cands.append(hcand)
        hcand += step
    best = None
    for hcand in cands:
        n_over = int(cum_over[hcand + 1])
        b = bytes_for(hcand, n_over)
        if b <= budget_bytes and (best is None or b < best[0]):
            best = (b, hcand)
    if best is None:
        raise MemoryError(
            f"device {what} needs more HBM than the "
            f"{budget_bytes/2**30:.1f} GiB budget at any head "
            "width; use -table-shards / -parts or cull features")
    return best[1]


def csr_bytes(table: FeatureTable, index_bytes: int = 0) -> int:
    """Device bytes of the CSR layout (db/state.py::tables_csr) in the
    port's types: features at 4 bytes (u32) or 8 (u64), int64 offsets,
    an int32 target and window a location, plus ``index_bytes`` of the
    u32 bucket-row index, counted beside the table as the u64 rows count
    theirs (JAX's layout_bytes("csr"), table.py:357-360, counts int32
    offsets and no index)."""
    fb = 8 if table.unique_features.dtype == np.uint64 else 4
    return (table.num_features * fb + (table.num_features + 1) * 8 +
            table.num_locations * 8 + index_bytes)


def device_layout(table: FeatureTable, spf: int, slot_bits: int,
                  budget_bytes: int, allow_dense: bool = True,
                  index_bytes: int = 0):
    """The layout of the host rows that ``MC_DEVICE_LAYOUT=0`` stages
    (``fused_rows``/``fused_rows_two_tier``), chosen by the device
    builder's rule (table_device.py:975-983) in the port's bytes, or the
    CSR layout where no two-tier head fits (JAX's choose_layout,
    table.py:392-394). -> (head, dense bytes, staged bytes): head == spf
    for the dense layout, 0 for CSR (``csr_bytes`` with the bucket
    index's ``index_bytes``), else the two-tier head width. The host rows
    have no size-classed cells. Raises MemoryError with JAX's advice
    where even CSR exceeds the budget."""
    nf = max(table.num_features, 1)
    bytes_for = _bytes_for_fn(nf, spf, 1 if slot_bits else 2)
    dense_b = bytes_for(spf, 0)
    if allow_dense and dense_b <= budget_bytes:
        return spf, dense_b, dense_b
    sizes = np.minimum(table.bucket_sizes(), spf) if table.num_features \
        else np.zeros(1, np.int64)
    hist = np.bincount(sizes, minlength=spf + 2)
    cum_over = np.cumsum(hist[::-1])[::-1]      # #buckets size >= idx
    try:
        head = _choose_head(spf, cum_over, bytes_for, budget_bytes,
                            "layout", slot_packed=bool(slot_bits))
    except MemoryError:
        csr_b = csr_bytes(table, index_bytes)
        if csr_b > budget_bytes:
            # the advice of metacache_tpu/ops/table.py:395-400
            raise MemoryError(
                f"database part needs more device memory than the "
                f"{budget_bytes / 2**30:.1f} GiB budget even in CSR layout "
                f"({csr_b / 2**30:.1f} GiB); "
                "use -table-shards N (shard over devices), -parts N + "
                "per-part query & merge, or cull with "
                "-remove-overpopulated-features / "
                "-max-locations-per-feature") from None
        return 0, dense_b, csr_b
    return head, dense_b, bytes_for(head, int(cum_over[head + 1]))
