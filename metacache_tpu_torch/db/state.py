"""Device-resident query state of one database part.

``DeviceTables`` holds the probe layout and the taxonomy arrays as
module buffers, so ``.to(device)`` moves them together. Two layouts of
metacache_tpu/ops/table.py, each probed through the 64-lane bucket-row
index of ops/probe.py::make_bucket_index:

- dense: ``fused_rows`` from ``fused_rows``, one row per feature
  [feature, count, slots...];
- two-tier (``head_slots`` > 0): ``fused_rows`` holds the head rows of
  ``fused_rows_two_tier``, [feature, count, ovf_idx, hsl slots...], and
  ``ovf_rows`` the overflow rows of the features whose buckets are
  deeper than the head (row 0 a dummy).
"""
from __future__ import annotations

import numpy as np
import torch


class DeviceTables(torch.nn.Module):
    def __init__(self, fused_rows: torch.Tensor, bucket_rows: torch.Tensor,
                 lineages: torch.Tensor, merge_tax: torch.Tensor, *,
                 num_features: int, bucket_bits: int, spf: int,
                 slot_bits: int, ovf_rows: torch.Tensor | None = None,
                 head_slots: int = 0):
        super().__init__()
        if (ovf_rows is None) != (head_slots == 0):
            raise ValueError("two-tier tables need both overflow rows and "
                             "a head width")
        self.register_buffer("fused_rows", fused_rows)
        self.register_buffer("ovf_rows", ovf_rows)
        self.register_buffer("bucket_rows", bucket_rows)
        self.register_buffer("lineages", lineages)
        self.register_buffer("merge_tax", merge_tax)
        self.num_features = num_features
        self.bucket_bits = bucket_bits
        self.spf = spf              # slots per feature (row depth)
        self.slot_bits = slot_bits  # pk window bits of the row slots
        self.head_slots = head_slots  # two-tier head slots, 0 = dense

    @property
    def dense(self):
        """metacache_tpu's probe layout tag: True for dense (tgt, win)
        lanes, "pk<bits>" for dense packed slots, ("two_tier", hsl,
        False, False, bits) for unpaired two-tier rows (runner.py:297-312)."""
        if self.head_slots:
            return ("two_tier", self.head_slots, False, False,
                    self.slot_bits)
        return f"pk{self.slot_bits}" if self.slot_bits else True

    @property
    def device(self) -> torch.device:
        return self.fused_rows.device

    def nbytes(self) -> int:
        return sum(b.numel() * b.element_size() for b in self.buffers())

    def cpu_copy(self) -> "DeviceTables":
        """The same tables on the CPU, for holding a query on the card
        against the plain versions."""
        return DeviceTables(
            self.fused_rows.cpu(), self.bucket_rows.cpu(),
            self.lineages.cpu(), self.merge_tax.cpu(),
            num_features=self.num_features, bucket_bits=self.bucket_bits,
            spf=self.spf, slot_bits=self.slot_bits,
            ovf_rows=None if self.ovf_rows is None else self.ovf_rows.cpu(),
            head_slots=self.head_slots)


def _i32(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a.astype(np.int32, copy=False))


def tables_from_numpy(unique_features: np.ndarray, offsets: np.ndarray,
                      fused_rows: np.ndarray, bucket_rows: np.ndarray,
                      bucket_bits: int, lineages: np.ndarray,
                      merge_tax: np.ndarray, spf: int, pack_bits: int,
                      device: torch.device, ovf_rows: np.ndarray | None = None,
                      head_slots: int = 0) -> DeviceTables:
    """Carry the database's host state (numpy arrays; u32 seen as
    int32 bit patterns) to the device. ``fused_rows`` must be
    ``FeatureTable.fused_rows(spf, slot_bits=pack_bits)``, or with
    ``head_slots = hsl`` the head rows of
    ``fused_rows_two_tier(spf, hsl, slot_bits=pack_bits)`` whose
    overflow rows are ``ovf_rows``: packed slots when ``pack_bits > 0``,
    (tgt, win) lanes when 0. The row layouts read only the feature
    count, not the feature and offset arrays."""
    nf = len(unique_features)
    if len(offsets) != nf + 1:
        raise ValueError("offsets must have one entry per feature plus one")
    t = DeviceTables(_i32(fused_rows), _i32(bucket_rows), _i32(lineages),
                     _i32(merge_tax), num_features=nf,
                     bucket_bits=bucket_bits, spf=spf, slot_bits=pack_bits,
                     ovf_rows=None if ovf_rows is None else _i32(ovf_rows),
                     head_slots=head_slots)
    return t.to(device)
