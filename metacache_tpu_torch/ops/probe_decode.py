"""Probe decode: kernels B6 (two-tier head only), B7 (full depth), B8
(overflow-row id) and B9 (bucket-row index).

Port of metacache_tpu/ops/probe_pallas.py::head_decode, ::full_decode,
::oidx_decode and ::bucket_decode. The two-tier layout
(ops/table_device.py, or ops/table.py::fused_rows_two_tier on the host,
slot-packed) holds one head row per feature, [feature, count, ovf_idx,
pk * hsl, ...], and overflow rows [pk * (c - hsl)] for the features
whose buckets are deeper than the head (row 0: a dummy); the bucket-row
index holds, per hash prefix h, the logical 64-lane row [start,
features...]. The device builder pair-packs 64-lane rows two a 128-lane
row; on the card that is the same memory as (2R, 64), and these kernels
read the 64-lane view.

The Pallas kernels decode rows that XLA gathered into device memory
first; the port's kernels take the tables and the probe indices and
read the rows themselves. Their contracts at that boundary:

- ``head_decode(head, idx, flat, hsl, rl, f)`` equals JAX
  ``head_decode(pairpack(head)[idx >> 1], idx & 1, flat, hsl, rl, f)``;
- ``full_decode(head, ovf, idx, flat, hsl, c, rl, f)`` equals JAX
  ``full_decode(pairpack(head)[idx >> 1], ovf[oidx], idx & 1, flat,
  hsl, c, rl, f)`` with oidx = head lane 2 of a matching row, else 0,
  or the ``oidx`` given (B8's output);
- ``oidx_decode(head, idx, flat)`` equals JAX
  ``oidx_decode(pairpack(head)[idx >> 1], idx & 1, flat)``: lane 2 of
  the logical head row when its lane 0 is the feature and the feature is
  not the sentinel, else 0;
- ``bucket_decode(brows, flat, bits)`` equals JAX
  ``bucket_decode(brows[h >> 1], h & 1, flat)`` with h = flat >>> (32 -
  bits): (start + the in-bucket ranks of the lanes that hold the
  feature, found = some lane holds it and it is not the sentinel);

where pairpack views the (F, 64) rows as (F / 2, 128). Probe indices
and overflow ids are clamped into their tables, as XLA's gathers do.
Odd features ((probe index % f) & 1) get their rl-lane run reversed;
f = 1 reverses nothing.

CUDA tensors launch the kernels (csrc/probe_decode.cu); CPU tensors take
the plain versions below. B6 and B7 run wherever their layouts are
probed; B8 and B9 are off unless ``MC_PROBE_PALLAS`` names them, as in
JAX (probe_pallas_enabled).
"""
from __future__ import annotations

import os

import torch

from .. import kernels

I32_MAX = 2**31 - 1


# metacache_tpu/ops/probe_pallas.py:43-61 for the two stages the port
# gates; head and full (B6, B7) always run
def probe_pallas_enabled(stage: str) -> bool:
    """Gate of the off-by-default decode kernels, ``stage`` "bucket"
    (B9) or "oidx" (B8). MC_PROBE_PALLAS: 0 or unset = off, 1 = all
    stages, or a comma list of stage names ("bucket,head,full,oidx")."""
    v = os.environ.get("MC_PROBE_PALLAS", "")
    if v in ("", "0"):
        return False
    return v == "1" or stage in {s.strip() for s in v.split(",")}


def _check(t: torch.Tensor, name: str, ndim: int):
    if t.dtype != torch.int32 or t.dim() != ndim:
        raise ValueError(f"{name} must be an int32 tensor of {ndim} dims")


def _rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    i = torch.clamp(idx.to(torch.int64), 0, table.shape[0] - 1)
    return table[i]


def _reverse_odd(pk: torch.Tensor, f: int) -> torch.Tensor:
    odd = ((torch.arange(pk.shape[0], device=pk.device) % f) & 1) == 1
    return torch.where(odd[:, None], pk.flip(1), pk)


def _padded(x: torch.Tensor, rl: int) -> torch.Tensor:
    if x.shape[1] >= rl:
        return x[:, :rl]
    pad = torch.full((x.shape[0], rl - x.shape[1]), I32_MAX,
                     dtype=torch.int32, device=x.device)
    return torch.cat([x, pad], dim=1)


def head_decode_plain(head, idx, flat, hsl: int, rl: int, f: int):
    """Plain version of B6: (pk (N, rl), cnt (N,)) int32."""
    rows = _rows(head, idx)
    found = (rows[:, 0] == flat) & (flat != -1)
    cnt = torch.where(found, rows[:, 1], 0)
    j = torch.arange(rl, dtype=torch.int32, device=head.device)[None, :]
    pk = torch.where(j < torch.clamp(cnt, max=hsl)[:, None],
                     _padded(rows[:, 3:3 + hsl], rl), I32_MAX)
    return _reverse_odd(pk, f), cnt


def full_decode_plain(head, ovf, idx, flat, hsl: int, c: int, rl: int,
                      f: int, oidx=None):
    """Plain version of B7: pk (N, rl) int32."""
    rows = _rows(head, idx)
    found = (rows[:, 0] == flat) & (flat != -1)
    cnt = torch.where(found, rows[:, 1], 0)
    if oidx is None:
        oidx = torch.where(found, rows[:, 2], 0)
    orow = _rows(ovf, oidx)
    slots = torch.cat([rows[:, 3:3 + hsl], orow[:, :c - hsl]], dim=1)
    j = torch.arange(rl, dtype=torch.int32, device=head.device)[None, :]
    pk = torch.where(j < cnt[:, None], _padded(slots, rl), I32_MAX)
    return _reverse_odd(pk, f)


def _check_probe(head, idx, flat, hsl: int, rl: int, f: int):
    _check(head, "head", 2)
    _check(idx, "idx", 1)
    _check(flat, "flat", 1)
    if idx.shape != flat.shape or len({head.device, idx.device,
                                       flat.device}) != 1:
        raise ValueError("idx and flat must match and share the table's "
                         "device")
    if not 0 <= hsl <= head.shape[1] - 3 or rl < hsl or rl < 1 or f < 1:
        raise ValueError(f"bad decode shape: head width {head.shape[1]}, "
                         f"hsl {hsl}, rl {rl}, f {f}")
    if head.shape[0] == 0:
        raise ValueError("empty head table")


def head_decode(head: torch.Tensor, idx: torch.Tensor, flat: torch.Tensor,
                hsl: int, rl: int, f: int):
    """(F, W) head rows, (N,) row indices and features (int32 bit
    patterns) -> (pk (N, rl) int32 masked to min(count, hsl) and
    odd-run-reversed, cnt (N,) int32 bucket counts, 0 on a miss) (B6)."""
    _check_probe(head, idx, flat, hsl, rl, f)
    if not head.is_cuda:
        return head_decode_plain(head, idx, flat, hsl, rl, f)
    head, idx, flat = head.contiguous(), idx.contiguous(), flat.contiguous()
    n = idx.shape[0]
    pk = torch.empty((n, rl), dtype=torch.int32, device=head.device)
    cnt = torch.empty((n,), dtype=torch.int32, device=head.device)
    if n:
        kernels.HEAD_DECODE(head.data_ptr(), head.shape[0], head.shape[1],
                            idx.data_ptr(), flat.data_ptr(), n, hsl, rl, f,
                            pk.data_ptr(), cnt.data_ptr())
    return pk, cnt


def full_decode(head: torch.Tensor, ovf: torch.Tensor, idx: torch.Tensor,
                flat: torch.Tensor, hsl: int, c: int, rl: int, f: int,
                oidx: torch.Tensor | None = None) -> torch.Tensor:
    """Head rows, (NOVF + 1, OW) overflow rows, (N,) row indices and
    features -> pk (N, rl) int32: head slots [0, hsl) then overflow slots
    [0, c - hsl), masked to the count and odd-run-reversed (B7). ``oidx``:
    the probes' overflow rows, from B8; None reads them from head lane 2."""
    _check_probe(head, idx, flat, hsl, rl, f)
    _check(ovf, "ovf", 2)
    if ovf.device != head.device or ovf.shape[0] == 0 or \
            ovf.shape[1] < c - hsl or c < hsl or rl < c:
        raise ValueError(f"bad overflow rows {tuple(ovf.shape)} for hsl "
                         f"{hsl}, c {c}, rl {rl}")
    if oidx is not None:
        _check(oidx, "oidx", 1)
        if oidx.shape != idx.shape or oidx.device != head.device:
            raise ValueError("oidx must match idx")
    if not head.is_cuda:
        return full_decode_plain(head, ovf, idx, flat, hsl, c, rl, f, oidx)
    head, ovf = head.contiguous(), ovf.contiguous()
    idx, flat = idx.contiguous(), flat.contiguous()
    if oidx is not None:
        oidx = oidx.contiguous()
    n = idx.shape[0]
    pk = torch.empty((n, rl), dtype=torch.int32, device=head.device)
    if n:
        kernels.FULL_DECODE(head.data_ptr(), head.shape[0], head.shape[1],
                            ovf.data_ptr(), ovf.shape[0], ovf.shape[1],
                            idx.data_ptr(), flat.data_ptr(),
                            None if oidx is None else oidx.data_ptr(), n,
                            hsl, c, rl, f, pk.data_ptr())
    return pk


def oidx_decode_plain(head, idx, flat) -> torch.Tensor:
    """Plain version of B8: (N,) int32 overflow-row ids."""
    rows = _rows(head, idx)
    found = (rows[:, 0] == flat) & (flat != -1)
    return torch.where(found, rows[:, 2], 0)


def oidx_decode(head: torch.Tensor, idx: torch.Tensor,
                flat: torch.Tensor) -> torch.Tensor:
    """(F, W) head rows, W >= 3 (the 64-lane view of pair-packed rows),
    (N,) row indices and features -> (N,) int32: head lane 2 (the
    overflow row) of each probe's row where its lane 0 is the feature
    and the feature is not the sentinel, else 0 (B8)."""
    _check_probe(head, idx, flat, 0, 1, 1)
    if not head.is_cuda:
        return oidx_decode_plain(head, idx, flat)
    head, idx, flat = head.contiguous(), idx.contiguous(), flat.contiguous()
    n = idx.shape[0]
    oidx = torch.empty((n,), dtype=torch.int32, device=head.device)
    if n:
        kernels.OIDX_DECODE(head.data_ptr(), head.shape[0], head.shape[1],
                            idx.data_ptr(), flat.data_ptr(), n,
                            oidx.data_ptr())
    return oidx


def _bucket_prefix(flat: torch.Tensor, bits: int) -> torch.Tensor:
    """h = flat >>> (32 - bits) of int32 bit patterns, int64."""
    return (flat.to(torch.int64) & 0xFFFFFFFF) >> (32 - bits)


def bucket_decode_plain(brows, flat, bits: int):
    """Plain version of B9: (idx (N,) int32, found (N,) bool)."""
    row = brows.reshape(-1, 64)[_bucket_prefix(flat, bits)]
    match = row[:, 1:] == flat[:, None]
    lanes = torch.arange(63, dtype=torch.int32, device=flat.device)
    local = torch.where(match, lanes, 0).sum(dim=1, dtype=torch.int32)
    return row[:, 0] + local, match.any(dim=1) & (flat != -1)


def bucket_decode(brows: torch.Tensor, flat: torch.Tensor, bits: int):
    """(2^bits / 2, 128) pair-packed bucket rows and (N,) features
    (int32 bit patterns) -> (idx (N,) int32 = start + the in-bucket ranks
    of the lanes of row h = flat >>> (32 - bits) that hold the feature,
    found (N,) bool) (B9)."""
    _check(brows, "brows", 2)
    _check(flat, "flat", 1)
    if brows.shape[1] != 128 or brows.shape[0] * 2 != 1 << bits or \
            flat.device != brows.device:
        raise ValueError(f"bucket rows {tuple(brows.shape)} are not the "
                         f"pair-packed index of {bits} bits on the "
                         "features' device")
    if not brows.is_cuda:
        return bucket_decode_plain(brows, flat, bits)
    brows, flat = brows.contiguous(), flat.contiguous()
    n = flat.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    found = torch.empty((n,), dtype=torch.bool, device=flat.device)
    if n:
        kernels.BUCKET_DECODE(brows.data_ptr(), bits, flat.data_ptr(), n,
                              idx.data_ptr(), found.data_ptr())
    return idx, found
