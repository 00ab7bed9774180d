"""Device-resident query state of one database part.

``DeviceTables`` holds the probe layout and the taxonomy arrays as
module buffers, so ``.to(device)`` moves them together. The layout is
the dense fused-row table of metacache_tpu/ops/table.py::fused_rows
(one row per feature: [feature, count, slots...]) plus the 64-lane
bucket-row index of ops/probe.py::make_bucket_index.
"""
from __future__ import annotations

import numpy as np
import torch


class DeviceTables(torch.nn.Module):
    def __init__(self, fused_rows: torch.Tensor, bucket_rows: torch.Tensor,
                 lineages: torch.Tensor, merge_tax: torch.Tensor, *,
                 num_features: int, bucket_bits: int, spf: int,
                 slot_bits: int):
        super().__init__()
        self.register_buffer("fused_rows", fused_rows)
        self.register_buffer("bucket_rows", bucket_rows)
        self.register_buffer("lineages", lineages)
        self.register_buffer("merge_tax", merge_tax)
        self.num_features = num_features
        self.bucket_bits = bucket_bits
        self.spf = spf              # slots per feature (row depth)
        self.slot_bits = slot_bits  # pk window bits of the row slots

    @property
    def dense(self):
        """metacache_tpu's probe layout tag: True for (tgt, win) lanes,
        "pk<bits>" for packed slots."""
        return f"pk{self.slot_bits}" if self.slot_bits else True

    @property
    def device(self) -> torch.device:
        return self.fused_rows.device

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers())


def _i32(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def tables_from_numpy(unique_features: np.ndarray, offsets: np.ndarray,
                      fused_rows: np.ndarray, bucket_rows: np.ndarray,
                      bucket_bits: int, lineages: np.ndarray,
                      merge_tax: np.ndarray, spf: int, pack_bits: int,
                      device: torch.device) -> DeviceTables:
    """Carry the database's host state (numpy arrays; u32 seen as
    int32 bit patterns) to the device. ``fused_rows`` must be
    ``FeatureTable.fused_rows(spf, slot_bits=pack_bits)``: packed slots
    when ``pack_bits > 0``, (tgt, win) lanes when 0. The dense layout
    reads only the feature count, not the feature and offset arrays."""
    nf = len(unique_features)
    if len(offsets) != nf + 1:
        raise ValueError("offsets must have one entry per feature plus one")
    t = DeviceTables(_i32(fused_rows), _i32(bucket_rows), _i32(lineages),
                     _i32(merge_tax), num_features=nf,
                     bucket_bits=bucket_bits, spf=spf, slot_bits=pack_bits)
    return t.to(device)
