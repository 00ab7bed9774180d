"""Device-resident query state of one database part.

``DeviceTables`` holds the probe layout and the taxonomy arrays as
module buffers, so ``.to(device)`` moves them together. The layouts, as
the device builder (ops/table_device.py) stages them, or the host rows
of ops/table.py under ``MC_DEVICE_LAYOUT=0``:

- dense: ``fused_rows`` holds one row per feature [feature, count,
  slots...];
- two-tier (``head_slots`` > 0): ``fused_rows`` holds the head rows
  [feature, count, ovf_idx, hsl slots...] and ``ovf_rows`` the overflow
  rows of the features whose buckets are deeper than the head (row 0 a
  dummy);
- size-classed (``classed``): ``fused_rows`` is the (P, 128) array of
  16/32/64-lane cells, [feature, count(, ovf_idx), slots...], and
  ``ovf_rows`` the overflow rows of the class-C features deeper than
  ``head_slots``.

Rows the builder pair-packs (two 64-lane rows a 128-lane row) are kept
as their 64-lane view, the same memory; ``packed``/``ovf_packed`` only
record it for the layout tag. ``bucket_rows`` is the host's 64-lane
bucket-row index or the builder's pair-packed (2^bits / 2, 128) one.
"""
from __future__ import annotations

import numpy as np
import torch


class DeviceTables(torch.nn.Module):
    def __init__(self, fused_rows: torch.Tensor, bucket_rows: torch.Tensor,
                 lineages: torch.Tensor, merge_tax: torch.Tensor, *,
                 num_features: int, bucket_bits: int, spf: int,
                 slot_bits: int, ovf_rows: torch.Tensor | None = None,
                 head_slots: int = 0, packed: bool = False,
                 ovf_packed: bool = False, classed: bool = False):
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
        self.packed = packed
        self.ovf_packed = ovf_packed
        self.classed = classed

    @property
    def dense(self):
        """metacache_tpu's probe layout tag (runner.py:297-312): True or
        "packed" for dense (tgt, win) lanes, "pk<bits>" or "pk<bits>p"
        for dense packed slots, ("two_tier", hsl, hpack, opack, bits) or
        ("classed", hsl, False, opack, bits)."""
        p = "p" if self.packed else ""
        if self.classed:
            return ("classed", self.head_slots, False, self.ovf_packed,
                    self.slot_bits)
        if self.head_slots:
            return ("two_tier", self.head_slots, self.packed,
                    self.ovf_packed, self.slot_bits)
        if self.slot_bits:
            return f"pk{self.slot_bits}{p}"
        return "packed" if self.packed else True

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
            head_slots=self.head_slots, packed=self.packed,
            ovf_packed=self.ovf_packed, classed=self.classed)


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
    """Carry the database's host rows (numpy arrays; u32 seen as int32
    bit patterns) to the device. ``fused_rows`` must be
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


def tables_from_device(dt, lineages: np.ndarray,
                       merge_tax: np.ndarray) -> DeviceTables:
    """DeviceTables over a DeviceTable's arrays (ops/table_device.py),
    on their device, without a copy: pair-packed rows as their 64-lane
    views, the dense layout without overflow rows."""
    def logical(rows, pack):
        return rows.view(-1, 64) if pack else rows
    dev = dt.head.device
    two_tier = not dt.dense
    return DeviceTables(
        dt.head if dt.classed else logical(dt.head, dt.packed), dt.brows,
        _i32(lineages).to(dev), _i32(merge_tax).to(dev), num_features=dt.nf,
        bucket_bits=dt.bbits, spf=dt.spf, slot_bits=dt.slot_bits,
        ovf_rows=logical(dt.ovf, dt.ovf_packed) if two_tier else None,
        head_slots=dt.head_slots if two_tier else 0, packed=dt.packed,
        ovf_packed=dt.ovf_packed, classed=dt.classed)
