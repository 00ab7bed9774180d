"""Feature probing through the bucket-row index.

Port of metacache_tpu/ops/probe.py for u32 features: ``make_bucket_index``
builds the host's 64-lane bucket rows in numpy; the device builder
(ops/table_device.py) builds them pair-packed, two a 128-lane row.
``probe_bucket`` finds each feature's row in the sorted feature array
with one row gather and an in-lane match, or through kernel B9 when
``MC_PROBE_PALLAS`` names its stage; ``probe_bucket_classed`` finds its
cell in the size-classed layout. Features are int32 tensors of u32 bit
patterns.
"""
from __future__ import annotations

import numpy as np
import torch

from .probe_decode import bucket_decode, probe_pallas_enabled


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


def shift_right_logical(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Logical right shift of int32 u32-bit patterns."""
    if bits == 0:
        return x
    return (x >> bits) & ((1 << (32 - bits)) - 1)


def probe_bucket(flat: torch.Tensor, bucket_rows: torch.Tensor, bits: int):
    """(N,) int32 features -> (idx int32, found bool) via one bucket-row
    gather + lane match (metacache_tpu/ops/probe.py:138-164). A 128-wide
    bucket_rows array is the device builder's pair-packed layout, the
    same memory as its 64-lane logical rows (host widths are 64, 65 or
    1+2^k, never 128); kernel B9 decodes it when the "bucket" stage is
    named."""
    if bucket_rows.shape[1] == 128:
        if probe_pallas_enabled("bucket"):
            return bucket_decode(bucket_rows, flat, bits)
        bucket_rows = bucket_rows.view(-1, 64)
    h = shift_right_logical(flat, 32 - bits).to(torch.int64)
    row = bucket_rows[h]                      # ONE row gather
    match = row[:, 1:] == flat[:, None]
    lanes = torch.arange(match.shape[1], dtype=torch.int32,
                         device=flat.device)
    local = torch.where(match, lanes, 0).sum(dim=1, dtype=torch.int32)
    idx = row[:, 0] + local
    found = match.any(dim=1) & (flat != -1)
    return idx, found


# metacache_tpu/ops/probe.py:167-212 as torch ops
def probe_bucket_classed(flat: torch.Tensor, brows: torch.Tensor, bits: int):
    """Classed bucket-row probe -> (pidx int32, found bool).

    brows logical row h (64 lanes, pair-packed) = [a16_A, a16_B, a16_C,
    61 x packed-entry lanes]; each lane holds two entries (low/high 16
    bits), entry = (cls << 14 | feat_low) + 1 and 0 = empty
    (ops/table_device.py::_brows_build_classed). The cell address is
    a16_cls + (#earlier same-class entries) * w16(cls); ``pidx`` packs it
    with the class: (addr16 << 2) | cls."""
    h = shift_right_logical(flat, 32 - bits).to(torch.int64)
    row = brows.reshape(-1, 64)[h]
    key_low = flat & ((1 << (32 - bits)) - 1)
    ent = row[:, 3:64]
    lanes = torch.arange(61, dtype=torch.int32, device=flat.device)
    halves = []
    for x, idx2 in ((ent & 0xFFFF, lanes * 2),
                    (shift_right_logical(ent, 16), lanes * 2 + 1)):
        valid = x != 0
        e = x - 1
        m = valid & ((e & 0x3FFF) == key_low[:, None])
        halves.append((m, e >> 14, valid, idx2))
    found = torch.zeros(flat.shape, dtype=torch.bool, device=flat.device)
    j = torch.zeros(flat.shape, dtype=torch.int32, device=flat.device)
    cls = torch.zeros_like(j)
    for m, c, _v, idx2 in halves:
        found |= m.any(dim=1)
        j += torch.where(m, idx2, 0).sum(dim=1, dtype=torch.int32)
        cls += torch.where(m, c, 0).sum(dim=1, dtype=torch.int32)
    pre = torch.zeros_like(j)
    for m, c, v, idx2 in halves:
        pre += (v & (c == cls[:, None]) & (idx2 < j[:, None])).sum(
            dim=1, dtype=torch.int32)
    w16 = torch.where(cls == 0, 1, torch.where(cls == 1, 2, 4))
    base = torch.where(cls == 0, row[:, 0],
                       torch.where(cls == 1, row[:, 1], row[:, 2]))
    addr16 = base + pre * w16
    found &= flat != -1
    return torch.where(found, (addr16 << 2) | cls, 0).to(torch.int32), found
