"""Two-tier probe decode: kernels B6 (head only) and B7 (full depth).

Port of metacache_tpu/ops/probe_pallas.py::head_decode and
::full_decode. The two-tier layout (ops/table.py::fused_rows_two_tier,
slot-packed) holds one head row per feature, [feature, count, ovf_idx,
pk * hsl, ...], and overflow rows [pk * (c - hsl)] for the features
whose buckets are deeper than the head (row 0: a dummy).

The Pallas kernels decode rows that XLA gathered into device memory
first; the port's kernels take the tables and the probe indices and
read the rows themselves. Their contracts at that boundary:

- ``head_decode(head, idx, flat, hsl, rl, f)`` equals JAX
  ``head_decode(pairpack(head)[idx >> 1], idx & 1, flat, hsl, rl, f)``;
- ``full_decode(head, ovf, idx, flat, hsl, c, rl, f)`` equals JAX
  ``full_decode(pairpack(head)[idx >> 1], ovf[oidx], idx & 1, flat,
  hsl, c, rl, f)`` with oidx = head lane 2 of a matching row, else 0;

where pairpack views the (F, 64) rows as (F / 2, 128). Probe indices
and overflow ids are clamped into their tables, as XLA's gathers do.
Odd features ((probe index % f) & 1) get their rl-lane run reversed;
f = 1 reverses nothing.

CUDA tensors launch the kernels (csrc/probe_decode.cu); CPU tensors take
the plain versions below.
"""
from __future__ import annotations

import torch

from .. import kernels

I32_MAX = 2**31 - 1


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
                      f: int):
    """Plain version of B7: pk (N, rl) int32."""
    rows = _rows(head, idx)
    found = (rows[:, 0] == flat) & (flat != -1)
    cnt = torch.where(found, rows[:, 1], 0)
    orow = _rows(ovf, torch.where(found, rows[:, 2], 0))
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
                flat: torch.Tensor, hsl: int, c: int, rl: int,
                f: int) -> torch.Tensor:
    """Head rows, (NOVF + 1, OW) overflow rows, (N,) row indices and
    features -> pk (N, rl) int32: head slots [0, hsl) then overflow slots
    [0, c - hsl), masked to the count and odd-run-reversed (B7)."""
    _check_probe(head, idx, flat, hsl, rl, f)
    _check(ovf, "ovf", 2)
    if ovf.device != head.device or ovf.shape[0] == 0 or \
            ovf.shape[1] < c - hsl or c < hsl or rl < c:
        raise ValueError(f"bad overflow rows {tuple(ovf.shape)} for hsl "
                         f"{hsl}, c {c}, rl {rl}")
    if not head.is_cuda:
        return full_decode_plain(head, ovf, idx, flat, hsl, c, rl, f)
    head, ovf = head.contiguous(), ovf.contiguous()
    idx, flat = idx.contiguous(), flat.contiguous()
    n = idx.shape[0]
    pk = torch.empty((n, rl), dtype=torch.int32, device=head.device)
    if n:
        kernels.FULL_DECODE(head.data_ptr(), head.shape[0], head.shape[1],
                            ovf.data_ptr(), ovf.shape[0], ovf.shape[1],
                            idx.data_ptr(), flat.data_ptr(), n, hsl, c, rl,
                            f, pk.data_ptr())
    return pk
