"""Feature probing through the bucket-row index.

Port of metacache_tpu/ops/probe.py: ``make_bucket_index`` builds the
host's 64-lane bucket rows of u32 features in numpy; the device builder
(ops/table_device.py) builds them pair-packed, two a 128-lane row. For
u64 features (k > 16) ``make_bucket_index64`` builds them in numpy from
the top bits and the low 32 bits of each feature, and
``probe_bucket64`` probes them with int64 bit patterns.
``probe_bucket`` finds each feature's row in the sorted feature array
from its bucket row and an in-lane match, through kernel B9 (on every
index width, u32 and u64); ``probe_bucket_classed`` finds its cell in
the size-classed layout through kernel classed_bucket. Features are
int32 tensors of u32 bit patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from .probe_decode import (bucket_decode, classed_bucket,  # noqa: F401
                           high32, low32, shift_right_logical)


# copied from metacache_tpu/ops/probe.py:36-69 (numpy, no JAX)
def make_bucket_index(features: np.ndarray, bits: int | None = None):
    """-> ((2^bits, 1+S) i32 bucket rows, bits).

    Row h = [start, f_0 .. f_{S-1}]: the sorted features whose top `bits`
    equal h, padded with 0xFFFFFFFF, plus their start offset in the
    feature array. S is the max bucket span rounded up to a power of
    two; `bits` defaults to ~log2(F) - 2 (avg span ~4) within [12, 24].
    """
    nf = len(features)
    if bits is None:
        bits = min(24, max(12, int(max(nf, 1)).bit_length() - 2))
    nbuckets = 1 << bits
    bounds = (np.arange(nbuckets, dtype=np.uint64) <<
              np.uint64(32 - bits)).astype(np.uint32)
    starts = np.searchsorted(features, bounds).astype(np.int64)
    ends = np.append(starts[1:], np.int64(nf))
    spans = ends - starts
    max_span = int(spans.max()) if nf else 1
    s = 1 << max(0, int(max_span - 1).bit_length())
    s = max(s, 1)
    w = 1 + s
    if w < 64 and nbuckets * 64 * 4 <= (1 << 30):
        w = 64          # gather fast path needs >= 64 lanes (measured)
    rows = np.full((nbuckets, w), -1, np.int32)
    rows[:, 0] = starts.astype(np.int32)
    if nf:
        h = (features >> np.uint32(32 - bits)).astype(np.int64)
        col = np.arange(nf, dtype=np.int64) - starts[h]
        rows[h, 1 + col] = features.view(np.int32)
    return rows, bits


# after metacache_tpu/ops/probe.py:72-112 (numpy, no JAX); the collision
# check sorts one packed key where JAX's lexsorts two keys (the same
# answer, a fraction of the time)
def make_bucket_index64(features: np.ndarray, bits: int | None = None):
    """u64-feature bucket-row index: row h (hash = top `bits` of the
    64-bit feature) = [start, low32(f_0) .. low32(f_{S-1})].

    The probe compares only the LOW 32 bits in-lane and verifies the
    full feature against the fused head row's two meta lanes, exact as
    long as no two features in one bucket share their low 32 bits.
    Returns None when such a collision exists (JAX's runner then takes
    its CSR probe; the port's staging widens the index,
    ops/table_device.py::device_layout_from_csr)."""
    nf = len(features)
    assert features.dtype == np.uint64
    if bits is None:
        bits = min(24, max(12, int(max(nf, 1)).bit_length() - 2))
    while True:
        nbuckets = 1 << bits
        bounds = (np.arange(nbuckets, dtype=np.uint64)
                  << np.uint64(64 - bits))
        starts = np.searchsorted(features, bounds).astype(np.int64)
        ends = np.append(starts[1:], np.int64(nf))
        max_span = int((ends - starts).max()) if nf else 1
        if max_span <= 63 or bits >= 26:
            break
        bits += 1
    if max_span > 63:
        return None
    low = (features & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    h = (features >> np.uint64(64 - bits)).astype(np.int64)
    # collision check: duplicate low-32 within one bucket, adjacent once
    # (bucket << 32 | low 32) is sorted (bits <= 26: the key fits)
    if nf:
        key = np.sort((h.astype(np.uint64) << np.uint64(32)) | low)
        if bool((key[1:] == key[:-1]).any()):
            return None
    w = max(64, 1 + (1 << max(0, int(max_span - 1).bit_length())))
    rows = np.full((nbuckets, w), -1, np.int32)
    rows[:, 0] = starts.astype(np.int32)
    if nf:
        col = np.arange(nf, dtype=np.int64) - starts[h]
        rows[h, 1 + col] = low.view(np.int32)
    return rows, bits


def collision_free_bits64(features: np.ndarray) -> int:
    """The least bucket width at which no two of the sorted distinct u64
    ``features`` share both their top bits and their low 32 bits
    (make_bucket_index64's condition), 0 when no two share their low 32
    bits: one more than the longest common top-bit prefix of two features
    of equal low 32 bits, found between neighbours in (low 32, value)
    order (the features whose low 32 bits no other feature shares are
    left out first: neighbours of equal low 32 bits stay neighbours)."""
    low = (features & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    sl = np.sort(low)
    dup = np.unique(sl[1:][sl[1:] == sl[:-1]])
    if not len(dup):
        return 0
    at = np.minimum(np.searchsorted(dup, low), len(dup) - 1)
    sel = dup[at] == low
    features, low = features[sel], low[sel]
    order = np.lexsort((features, low))
    f, lo = features[order], low[order]
    same = lo[1:] == lo[:-1]
    if not same.any():
        return 0
    x = f[1:][same] ^ f[:-1][same]          # distinct features: x != 0
    hi = (x >> np.uint64(32)).astype(np.float64)
    lo32 = (x & np.uint64(0xFFFFFFFF)).astype(np.float64)
    # bit length, exact: each half is below 2^53
    blen = np.where(hi > 0, 33 + np.floor(np.log2(np.maximum(hi, 1))),
                    1 + np.floor(np.log2(np.maximum(lo32, 1))))
    return int((64 - blen).max()) + 1


# metacache_tpu/ops/probe.py:115-135
def probe_bucket64(flat: torch.Tensor, bucket_rows: torch.Tensor,
                   bits: int, hi: int | None = None):
    """(N,) int64 u64-bit features -> (idx int32, found bool) through B9:
    the host index's bucket row of the top `bits` bits (a logical shift),
    an in-lane match of the LOW 32 bits (make_bucket_index64 keeps them
    distinct within a bucket); the caller verifies the full feature
    against the head row's two meta lanes. The sentinel (-1) is never
    found. ``hi``: idx clamped into [0, hi]."""
    if flat.dtype != torch.int64:
        raise ValueError("probe_bucket64 takes int64 u64 bit patterns")
    return bucket_decode(bucket_rows, flat, bits, hi)


# metacache_tpu/ops/probe.py:138-164
def probe_bucket(flat: torch.Tensor, bucket_rows: torch.Tensor, bits: int,
                 hi: int | None = None):
    """(N,) int32 features -> (idx int32, found bool) through B9: the
    bucket row of the top `bits` bits and an in-lane match. A 128-wide
    bucket_rows array is the device builder's pair-packed layout, the
    same memory as its 64-lane logical rows (host widths are 64, 65 or
    1+2^k, never 128). ``hi``: idx clamped into [0, hi]."""
    if flat.dtype != torch.int32:
        raise ValueError("probe_bucket takes int32 u32 bit patterns")
    return bucket_decode(bucket_rows, flat, bits, hi)


# metacache_tpu/ops/probe.py:167-212
def probe_bucket_classed(flat: torch.Tensor, brows: torch.Tensor, bits: int):
    """Classed bucket-row probe -> (pidx int32, found bool) through
    classed_bucket.

    brows logical row h (64 lanes, pair-packed) = [a16_A, a16_B, a16_C,
    61 x packed-entry lanes]; each lane holds two entries (low/high 16
    bits), entry = (cls << 14 | feat_low) + 1 and 0 = empty
    (ops/table_device.py::_brows_build_classed). The cell address is
    a16_cls + (#earlier same-class entries) * w16(cls); ``pidx`` packs it
    with the class: (addr16 << 2) | cls."""
    return classed_bucket(brows, flat, bits)
