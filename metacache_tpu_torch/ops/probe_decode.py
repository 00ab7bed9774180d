"""Probe decode: kernels B6 (two-tier head only), B7 (full depth), B8
(overflow-row id), B9 (bucket-row index), csr_decode (the CSR layout's
per-slot gathers), dense_decode (dense and two-tier lane rows),
classed_bucket and classed_decode (the size-classed cells).

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
  bits) on pair-packed rows, and JAX's ``probe_bucket`` and
  ``probe_bucket64`` (probe.py:115-164) on every index: (start + the
  in-bucket ranks of the lanes that hold the feature, found = some lane
  holds it and it is not the sentinel);
- ``classed_bucket(brows, flat, bits)`` equals JAX's
  ``probe_bucket_classed`` (probe.py:167-212), and ``classed_decode``
  the classed branches of its ``probe_rows`` and ``probe_rows_head``
  from the cell addresses on (rows.py:469-575): the cell's window, the
  meta check, the mask to the count, the overflow row of class C, the
  caller's encoding, the pad to rl and the reversed odd runs. Neither
  has a Pallas counterpart: JAX leaves these steps to XLA.

- ``csr_decode(idx, found, offsets, loc_tgt, loc_win, c, rl, f,
  pack_bits)`` equals the CSR branch of JAX's ``probe_rows``
  (rows.py:784-838) after its row search, per probe: slots j <
  min(offsets[i + 1] - offsets[i], c) where found, else none, read at
  offsets[i] + j from loc_tgt and loc_win, I32_MAX past the count and
  up to rl lanes; (pk,) = (tgt << pack_bits) | win where pack_bits > 0,
  else (tgt, win). It has no Pallas counterpart: JAX leaves these
  gathers to XLA.

- ``dense_decode(rows, ovf, idx, flat, hsl, c, rl, f, slot_bits,
  pack_bits)`` equals the dense and two-tier branches of JAX's
  ``probe_rows`` (rows.py:699-838) from its feature rows ``idx_c`` on:
  the row (and overflow row) gathers, the meta check (two lanes for u64
  features), the mask to the count, the caller's slot encoding, the pad
  to rl and the reversal of odd features' runs. It has no Pallas
  counterpart: JAX leaves these steps to XLA.

where pairpack views the (F, 64) rows as (F / 2, 128). Probe indices
and overflow ids are clamped into their tables, as XLA's gathers do.
Odd features ((probe index % f) & 1) get their rl-lane run reversed;
f = 1 reverses nothing.

CUDA tensors launch the kernels (csrc/probe_decode.cu); CPU tensors take
the plain versions below, whatever ``MC_PROBE_PALLAS`` says (it is
checked, check_probe_pallas). B9 is the bucket probe of every row
layout and of a u32 CSR part, classed_bucket and classed_decode the
probe of the classed cells; B6 and B7 run wherever their layouts are
probed. B8's work is folded into B7 on the query path:
B7 without ``oidx`` reads the overflow row from the head row it holds,
where JAX's oidx stage had to find the rows before XLA's gather
(metacache_tpu/ops/rows.py:716-738). ``oidx_decode`` stays as the
counterpart of JAX's kernel, held against its plain version. csr_decode
runs wherever a CSR part is probed, dense_decode wherever dense rows, or
two-tier rows that B7 does not take ((tgt, win) lanes, u64 features),
are probed at full depth.
"""
from __future__ import annotations

import os

import torch

from .. import kernels

I32_MAX = 2**31 - 1


PROBE_STAGES = ("bucket", "head", "full", "oidx")


# metacache_tpu/ops/probe_pallas.py:43-61 reads MC_PROBE_PALLAS to pick
# the stages its Pallas kernels take; every stage's kernel always runs
# on the card here (B9, B6, B7; B7 does the oidx stage's work)
def check_probe_pallas():
    """Refuse an MC_PROBE_PALLAS other than unset, 0, 1 or a comma list
    of stage names from ``PROBE_STAGES``; no value changes a route."""
    v = os.environ.get("MC_PROBE_PALLAS", "")
    if v in ("", "0", "1"):
        return
    bad = {x.strip() for x in v.split(",")} - set(PROBE_STAGES)
    if bad:
        raise ValueError(f"MC_PROBE_PALLAS={v!r}: expected 0, 1 or a comma "
                         f"list of {','.join(PROBE_STAGES)}")


def low32(flat: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of int64 u64-bit patterns, as int32 bits."""
    return ((flat & 0xFFFFFFFF) - ((flat & 0x80000000) << 1)).to(torch.int32)


def high32(flat: torch.Tensor) -> torch.Tensor:
    """The high 32 bits of int64 u64-bit patterns, as int32 bits."""
    return (flat >> 32).to(torch.int32)


def shift_right_logical(x: torch.Tensor, bits: int) -> torch.Tensor:
    """Logical right shift of int32 u32-bit patterns."""
    if bits == 0:
        return x
    return (x >> bits) & ((1 << (32 - bits)) - 1)


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


def bucket_decode_plain(brows, flat, bits: int, hi: int | None = None):
    """Plain version of B9: (idx (N,) int32, found (N,) bool)."""
    if flat.dtype == torch.int64:
        h = (flat >> (64 - bits)) & ((1 << bits) - 1)
        key = low32(flat)
    else:
        h = (flat.to(torch.int64) & 0xFFFFFFFF) >> (32 - bits)
        key = flat
    # the pair-packed (R, 128) rows are the logical rows (2R, 64)
    row = (brows.reshape(-1, 64) if brows.shape[1] == 128 else brows)[h]
    match = row[:, 1:] == key[:, None]
    lanes = torch.arange(match.shape[1], dtype=torch.int32,
                         device=flat.device)
    local = torch.where(match, lanes, 0).sum(dim=1, dtype=torch.int32)
    idx = row[:, 0] + local
    if hi is not None:
        idx = torch.clamp(idx, 0, max(hi, 0))
    return idx, match.any(dim=1) & (flat != -1)


def bucket_decode(brows: torch.Tensor, flat: torch.Tensor, bits: int,
                  hi: int | None = None):
    """A bucket-row index of 2^bits logical rows [start, features...]
    (-1 pads): the device builder's pair-packed (2^bits / 2, 128) rows
    (64 lanes a logical row) or the host's (2^bits, W) rows, W = 64, 65
    or 1 + 2^k; and (N,) features, int32 u32 bit patterns or int64 u64
    ones -> (idx (N,) int32 = start + the in-bucket ranks of every lane
    of row h that holds the feature (u64: its low 32 bits), found (N,)
    bool = some lane holds it and it is not the sentinel) (B9). h =
    flat >>> (32 - bits), or >>> (64 - bits) for u64 features. ``hi``:
    idx clamped into [0, hi] (the feature table's last row)."""
    _check(brows, "brows", 2)
    check_probe_pallas()
    w = brows.shape[1]
    lanes = 64 if w == 128 else w
    if flat.dim() != 1 or flat.dtype not in (torch.int32, torch.int64) or \
            flat.device != brows.device:
        raise ValueError("flat must be a 1-dim int32 or int64 tensor on the "
                         "bucket rows' device")
    wide = flat.dtype == torch.int64
    if lanes < 2 or not 1 <= bits <= (63 if wide else 31) or \
            brows.shape[0] * w != lanes << bits:
        raise ValueError(f"bucket rows {tuple(brows.shape)} are not an "
                         f"index of 2^{bits} rows")
    if not brows.is_cuda:
        return bucket_decode_plain(brows, flat, bits, hi)
    brows, flat = brows.contiguous(), flat.contiguous()
    n = flat.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    found = torch.empty((n,), dtype=torch.bool, device=flat.device)
    if n:
        kernels.BUCKET_DECODE(brows.data_ptr(), 1 << bits, lanes, bits,
                              flat.data_ptr(), int(wide), n,
                              -1 if hi is None else max(hi, 0),
                              idx.data_ptr(), found.data_ptr())
    return idx, found


def classed_bucket_plain(brows, flat, bits: int):
    """Plain version of classed_bucket: (pidx (N,) int32, found (N,)
    bool), as JAX's XLA ops compute them (probe.py:167-212)."""
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


def classed_bucket(brows: torch.Tensor, flat: torch.Tensor, bits: int):
    """The size-classed bucket probe (classed_bucket): pair-packed
    (2^bits / 2, 128) bucket rows, logical row h = [a16_A, a16_B, a16_C,
    61 lanes of two 16-bit entries], entry = ((cls << 14) | feat_low) +
    1, 0 = empty (ops/table_device.py::_brows_build_classed), and (N,)
    int32 features -> (pidx (N,) int32 = ((a16_cls + (the valid entries
    of class cls before the feature's) * w16(cls)) << 2) | cls where
    found, else 0; found (N,) bool). j and cls are the sums over the
    entries that hold the feature's low 32 - bits bits, as in JAX. On the
    card the kernel reads the rows in 16-byte loads: a view of them must
    start 16-byte aligned (the launch is refused otherwise)."""
    _check(brows, "brows", 2)
    _check(flat, "flat", 1)
    check_probe_pallas()
    if brows.shape[1] != 128 or brows.shape[0] * 2 != 1 << bits or \
            flat.device != brows.device:
        raise ValueError(f"classed bucket rows {tuple(brows.shape)} are not "
                         f"the pair-packed index of {bits} bits on the "
                         "features' device")
    if not brows.is_cuda:
        return classed_bucket_plain(brows, flat, bits)
    brows, flat = brows.contiguous(), flat.contiguous()
    n = flat.shape[0]
    pidx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    found = torch.empty((n,), dtype=torch.bool, device=flat.device)
    if n:
        kernels.CLASSED_BUCKET(brows.data_ptr(), 1 << bits, bits,
                               flat.data_ptr(), n, pidx.data_ptr(),
                               found.data_ptr())
    return pidx, found


# metacache_tpu/ops/rows.py:469-494
def _classed_window(cells: torch.Tensor, pidx: torch.Tensor):
    """Each probe's classed cell as a 64-lane window -> (window, cls).

    pidx = (addr16 << 2) | cls; cells = the (P, 128) cell array. Cell
    bases are 8-unit aligned per class and widths 1/2/4 units at
    width-aligned offsets, so no cell crosses a 64-lane half: read the
    half, then shift it left by the cell's 16-lane offset, zero filled.
    Lanes past the cell's width hold neighbour cells; callers mask by
    the bucket count, which never exceeds the cell's slots."""
    a16 = shift_right_logical(pidx, 2)
    row = cells.view(-1, 64)[(a16 >> 2).to(torch.int64)]
    src = torch.arange(64, device=pidx.device)[None, :] + \
        16 * (a16 & 3).to(torch.int64)[:, None]
    window = torch.where(src < 64,
                         torch.gather(row, 1, torch.clamp(src, max=63)), 0)
    return window, pidx & 3


# metacache_tpu/ops/rows.py:497-515
def _classed_head_slots(flat, cells, hsl: int, pidx):
    """One classed head cell per probe -> (window (N, 64), found, cnt,
    isC class-C mask, slots (N, hsl) head slot lanes); hsl <= 61."""
    window, clsv = _classed_window(cells, pidx)
    found = (window[:, 0] == flat) & (flat != -1)
    cnt = torch.where(found, window[:, 1], 0)
    isC = clsv == 2
    slots = torch.where(isC[:, None], window[:, 3:3 + hsl],
                        window[:, 2:2 + hsl])
    return window, found, cnt, isC, slots


# metacache_tpu/ops/rows.py:518-542
def _classed_probe(flat, cells, ovf, hsl: int, c: int, pidx):
    """Classed head + overflow slots -> pks (N, c) packed slots masked
    to the bucket count."""
    window, found, cnt, isC, slots = _classed_head_slots(flat, cells, hsl,
                                                         pidx)
    if c > hsl:
        orow = _rows(ovf, torch.where(found & isC, window[:, 2], 0))
        pks = torch.cat([slots, orow[:, :c - hsl]], dim=1)
    else:
        pks = slots[:, :c]
    j = torch.arange(c, dtype=torch.int32, device=flat.device)[None, :]
    return torch.where(j < cnt[:, None], pks, I32_MAX)


def classed_decode_plain(cells, ovf, pidx, flat, hsl: int, c: int, rl: int,
                         f: int, slot_bits: int, pack_bits: int,
                         head: bool = False):
    """Plain version of classed_decode, as JAX's XLA ops compute it
    (rows.py:469-575): the (N, rl) int32 lanes, (pk,) or (tgt, win);
    ``head``: (pk, cnt)."""
    if head:
        _w, _found, cnt, _isC, slots = _classed_head_slots(flat, cells, hsl,
                                                           pidx)
        j = torch.arange(hsl, dtype=torch.int32, device=flat.device)
        pk = torch.where(j[None, :] < torch.clamp(cnt, max=hsl)[:, None],
                         slots, I32_MAX)
        return _reverse_odd(_padded(pk, rl), f), cnt
    pks = _classed_probe(flat, cells, ovf, hsl, c, pidx)
    return tuple(_reverse_odd(_padded(x, rl), f)
                 for x in _encode((pks,), slot_bits, pack_bits))


def classed_decode(cells: torch.Tensor, ovf: torch.Tensor | None,
                   pidx: torch.Tensor, flat: torch.Tensor, hsl: int, c: int,
                   rl: int, f: int, slot_bits: int, pack_bits: int,
                   head: bool = False):
    """The (P, 128) classed cells, the (NOVF + 1, OW) overflow rows of
    the class-C cells deeper than the head, (N,) cell addresses pidx =
    (a16 << 2) | cls (classed_bucket) and int32 features -> the probes'
    slots as (N, rl) int32 lanes in the caller's encoding, (pk,) with
    pack_bits > 0, else (tgt, win): the cell's first min(count, c) slots,
    hsl from the cell (lane 3 on for class C, lane 2 on for the others)
    and the rest from the overflow row that class C keeps in lane 2;
    I32_MAX past the count and up to rl, odd features' runs reversed
    ((probe index % f) & 1; f = 1 reverses none). ``head``: the first
    min(count, hsl) slots only (pack_bits must equal slot_bits) -> (pk
    (N, rl), cnt (N,) int32 bucket counts, 0 on a miss); on the card the
    head form copies 16-byte quads where rl is a multiple of 4 and the
    cells and pk start 16-byte aligned, else 4 bytes at a time."""
    _check(cells, "cells", 2)
    _check(pidx, "pidx", 1)
    _check(flat, "flat", 1)
    width = hsl if head else c
    if cells.shape[1] != 128 or cells.shape[0] == 0 or \
            pidx.shape != flat.shape or \
            len({cells.device, pidx.device, flat.device}) != 1 or \
            not 1 <= hsl <= 61 or c < 1 or rl < width or f < 1 or \
            not 0 < slot_bits < 31 or not 0 <= pack_bits < 31 or \
            (head and pack_bits != slot_bits):
        raise ValueError(f"bad classed decode shape: cells "
                         f"{tuple(cells.shape)}, hsl {hsl}, c {c}, rl {rl}, "
                         f"f {f}, slot_bits {slot_bits}, pack_bits "
                         f"{pack_bits}, head {head}")
    if not head and c > hsl:
        if ovf is None:
            raise ValueError("the full-depth classed decode needs the "
                             "overflow rows")
        _check(ovf, "ovf", 2)
        if ovf.device != cells.device or ovf.shape[0] == 0 or \
                ovf.shape[1] < c - hsl:
            raise ValueError(f"bad overflow rows {tuple(ovf.shape)} for "
                             f"hsl {hsl}, c {c}")
    if not cells.is_cuda:
        return classed_decode_plain(cells, ovf, pidx, flat, hsl, c, rl, f,
                                    slot_bits, pack_bits, head)
    cells, pidx, flat = cells.contiguous(), pidx.contiguous(), \
        flat.contiguous()
    use_ovf = not head and c > hsl
    if use_ovf:
        ovf = ovf.contiguous()
    n = pidx.shape[0]
    dev = cells.device
    outs = tuple(torch.empty((n, rl), dtype=torch.int32, device=dev)
                 for _ in range(1 if pack_bits else 2))
    cnt = torch.empty((n,), dtype=torch.int32, device=dev) if head else None
    if n:
        kernels.CLASSED_DECODE(
            cells.data_ptr(), cells.shape[0] * 2,
            ovf.data_ptr() if use_ovf else None,
            ovf.shape[0] if use_ovf else 0, ovf.shape[1] if use_ovf else 0,
            pidx.data_ptr(), flat.data_ptr(), n, hsl, c, rl, f, slot_bits,
            pack_bits, int(head), outs[0].data_ptr(),
            None if pack_bits else outs[1].data_ptr(),
            cnt.data_ptr() if head else None)
    return (outs[0], cnt) if head else outs


def csr_decode_plain(idx, found, offsets, loc_tgt, loc_win, c: int, rl: int,
                     f: int, pack_bits: int):
    """Plain version of csr_decode: the (N, rl) int32 lanes, (pk,) or
    (tgt, win), as JAX's XLA ops compute them (rows.py:784-838)."""
    nf = offsets.shape[0] - 1
    i = torch.clamp(idx.to(torch.int64), 0, max(nf - 1, 0))
    if nf > 0:
        beg = offsets[i]
        cnt = torch.where(found, torch.clamp(offsets[i + 1] - beg, max=c), 0)
        beg = torch.where(found, beg, 0)
    else:
        cnt = beg = torch.zeros_like(i)
    j = torch.arange(c, device=idx.device)[None, :]
    hit = j < cnt[:, None]
    nloc = loc_tgt.shape[0]
    li = torch.clamp(beg[:, None] + j, max=max(nloc - 1, 0))
    if nloc == 0:
        loc_tgt = loc_win = torch.full((1,), I32_MAX, dtype=torch.int32,
                                       device=idx.device)
    tgts = torch.where(hit, loc_tgt[li], I32_MAX)
    wins = torch.where(hit, loc_win[li], I32_MAX)
    if pack_bits:
        lanes = (torch.where(hit, (tgts << pack_bits) | wins, I32_MAX),)
    else:
        lanes = (tgts, wins)
    return tuple(_reverse_odd(_padded(x, rl), f) for x in lanes)


def csr_decode(idx: torch.Tensor, found: torch.Tensor, offsets: torch.Tensor,
               loc_tgt: torch.Tensor, loc_win: torch.Tensor, c: int, rl: int,
               f: int, pack_bits: int) -> tuple:
    """(N,) feature rows and found flags, a CSR's (F + 1,) int64 offsets
    and its (L,) int32 targets and windows -> the probes' slots as (N,
    rl) int32 lanes: (pk,) with pk = (tgt << pack_bits) | win when
    ``pack_bits`` > 0, else (tgt, win); the first min(count, c) slots of
    each found feature, I32_MAX past them, odd features' runs reversed
    ((probe index % f) & 1; f = 1 reverses none)."""
    _check(idx, "idx", 1)
    _check(loc_tgt, "loc_tgt", 1)
    _check(loc_win, "loc_win", 1)
    if found.dtype != torch.bool or offsets.dtype != torch.int64 or \
            found.shape != idx.shape or offsets.dim() != 1 or \
            loc_win.shape != loc_tgt.shape or len(
                {t.device for t in (idx, found, offsets, loc_tgt,
                                    loc_win)}) != 1:
        raise ValueError("found must be bool and match idx, offsets int64, "
                         "loc_tgt and loc_win match; all on one device")
    if offsets.shape[0] < 1 or c < 1 or rl < c or f < 1 or \
            not 0 <= pack_bits < 31:
        raise ValueError(f"bad CSR decode shape: {offsets.shape[0]} "
                         f"offsets, c {c}, rl {rl}, f {f}, pack_bits "
                         f"{pack_bits}")
    if not offsets.is_cuda:
        return csr_decode_plain(idx, found, offsets, loc_tgt, loc_win, c, rl,
                                f, pack_bits)
    idx, found, offsets = idx.contiguous(), found.contiguous(), \
        offsets.contiguous()
    loc_tgt, loc_win = loc_tgt.contiguous(), loc_win.contiguous()
    n = idx.shape[0]
    outs = tuple(torch.empty((n, rl), dtype=torch.int32, device=idx.device)
                 for _ in range(1 if pack_bits else 2))
    if n:
        kernels.CSR_DECODE(idx.data_ptr(), found.data_ptr(),
                           offsets.data_ptr(), offsets.shape[0] - 1,
                           loc_tgt.data_ptr(), loc_win.data_ptr(),
                           loc_tgt.shape[0], n, c, rl, f, pack_bits,
                           outs[0].data_ptr(),
                           outs[-1].data_ptr() if not pack_bits else None)
    return outs


def _encode(lanes, slot_bits: int, pack_bits: int):
    """Slots as stored -> the caller's encoding: (pk,) packed with
    ``pack_bits``, or (tgt, win) when 0 (rows.py:798-815)."""
    if slot_bits:
        pks = lanes[0]
        if pack_bits == slot_bits:
            return (pks,)
        pad_ = pks == I32_MAX
        tgts = torch.where(pad_, I32_MAX, shift_right_logical(pks, slot_bits))
        wins = torch.where(pad_, I32_MAX, pks & ((1 << slot_bits) - 1))
    else:
        tgts, wins = lanes
    if pack_bits:
        return (torch.where(tgts != I32_MAX, (tgts << pack_bits) | wins,
                            I32_MAX),)
    return tgts, wins


def meta_match(rows: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    """Fused-row feature verification (rows.py:65-77): one meta lane for
    u32 features, two (lo, hi) for u64 ones (int64 bit patterns)."""
    if flat.dtype == torch.int64:
        return (rows[:, 0] == low32(flat)) & (rows[:, 1] == high32(flat)) & \
            (flat != -1)
    return (rows[:, 0] == flat) & (flat != -1)


def dense_decode_plain(rows, ovf, idx, flat, hsl: int, c: int, rl: int,
                       f: int, slot_bits: int, pack_bits: int):
    """Plain version of dense_decode: the (N, rl) int32 lanes, (pk,) or
    (tgt, win), as JAX's XLA ops compute them (rows.py:699-838)."""
    nm = 2 if flat.dtype == torch.int64 else 1
    r = _rows(rows, idx)
    found = meta_match(r, flat)
    cnt = torch.where(found, r[:, nm], 0)
    j = torch.arange(c, dtype=torch.int32, device=rows.device)[None, :]
    hit = j < cnt[:, None]
    nl = 1 if slot_bits else 2
    if ovf is not None:
        # two-tier: head [meta, count, ovf_idx, lane*H ...], overflow
        # [lane*(C-H) ...]
        ow, hb = c - hsl, nm + 2
        orow = _rows(ovf, torch.where(found, r[:, nm + 1], 0))
        lanes = tuple(torch.cat([r[:, hb + k * hsl:hb + (k + 1) * hsl],
                                 orow[:, k * ow:(k + 1) * ow]], dim=1)
                      for k in range(nl))
    else:
        hb = nm + 1
        lanes = tuple(r[:, hb + k * c:hb + (k + 1) * c] for k in range(nl))
    lanes = tuple(torch.where(hit, x, I32_MAX) for x in lanes)
    return tuple(_reverse_odd(_padded(x, rl), f)
                 for x in _encode(lanes, slot_bits, pack_bits))


def dense_decode(rows: torch.Tensor, ovf: torch.Tensor | None,
                 idx: torch.Tensor, flat: torch.Tensor, hsl: int, c: int,
                 rl: int, f: int, slot_bits: int, pack_bits: int) -> tuple:
    """(F, W) dense rows, or two-tier head rows with their (NOVF + 1, OW)
    overflow rows ``ovf`` (None: dense), (N,) int32 row indices and
    features (int32 bit patterns; int64 for u64 features, two meta
    lanes) -> the probes' first min(count, c) slots as (N, rl) int32
    lanes in the caller's encoding, (pk,) with pack_bits > 0, else (tgt,
    win); I32_MAX past the count and up to rl, odd features' runs
    reversed ((probe index % f) & 1; f = 1 reverses none). Slots are
    stored as one pk lane each with ``slot_bits`` window bits, or as tgt
    lanes then win lanes (slot_bits = 0): c of them in a dense row, hsl
    in a head and c - hsl in an overflow row."""
    _check(rows, "rows", 2)
    _check(idx, "idx", 1)
    wide = flat.dtype == torch.int64
    if flat.dim() != 1 or flat.dtype not in (torch.int32, torch.int64) or \
            idx.shape != flat.shape or \
            len({rows.device, idx.device, flat.device}) != 1:
        raise ValueError("flat must be int32 or int64 and match idx, on "
                         "the rows' device")
    nl = 1 if slot_bits else 2
    meta = (2 if wide else 1) + (1 if ovf is None else 2)
    hs = c if ovf is None else hsl
    if rows.shape[0] == 0 or c < 1 or rl < c or f < 1 or \
            not 0 <= hs <= c or rows.shape[1] < meta + nl * hs or \
            not 0 <= slot_bits < 31 or not 0 <= pack_bits < 31:
        raise ValueError(f"bad dense decode shape: rows "
                         f"{tuple(rows.shape)}, hsl {hsl}, c {c}, rl {rl}, "
                         f"f {f}, slot_bits {slot_bits}, pack_bits "
                         f"{pack_bits}")
    if ovf is not None:
        _check(ovf, "ovf", 2)
        if ovf.device != rows.device or ovf.shape[0] == 0 or \
                ovf.shape[1] < nl * (c - hsl):
            raise ValueError(f"bad overflow rows {tuple(ovf.shape)} for "
                             f"hsl {hsl}, c {c}")
    if not rows.is_cuda:
        return dense_decode_plain(rows, ovf, idx, flat, hsl, c, rl, f,
                                  slot_bits, pack_bits)
    rows, idx, flat = rows.contiguous(), idx.contiguous(), flat.contiguous()
    if ovf is not None:
        ovf = ovf.contiguous()
    n = idx.shape[0]
    outs = tuple(torch.empty((n, rl), dtype=torch.int32, device=rows.device)
                 for _ in range(1 if pack_bits else 2))
    if n:
        kernels.DENSE_DECODE(
            rows.data_ptr(), rows.shape[0], rows.shape[1],
            None if ovf is None else ovf.data_ptr(),
            0 if ovf is None else ovf.shape[0],
            0 if ovf is None else ovf.shape[1], idx.data_ptr(),
            flat.data_ptr(), int(wide), n, hsl if ovf is not None else 0, c,
            rl, f, slot_bits, pack_bits, outs[0].data_ptr(),
            None if pack_bits else outs[1].data_ptr())
    return outs
