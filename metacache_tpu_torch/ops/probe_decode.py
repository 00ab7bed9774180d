"""Probe decode: kernels B6 (two-tier head only), B7 (full depth), B8
(overflow-row id), B9 (bucket-row index) and csr_decode (the CSR
layout's per-slot gathers).

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
the plain versions below. B6 and B7 run wherever their layouts are
probed; B9 is off unless ``MC_PROBE_PALLAS`` names it, as in JAX
(probe_pallas_enabled). B8's work is folded into B7 on the query path:
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


# metacache_tpu/ops/probe_pallas.py:43-61 for the stage the port gates;
# head and full (B6, B7) always run, and B7 does the oidx stage's work
def probe_pallas_enabled(stage: str) -> bool:
    """Gate of the off-by-default decode kernel, ``stage`` "bucket"
    (B9). MC_PROBE_PALLAS: 0 or unset = off, 1 = all stages, or a comma
    list of stage names ("bucket,head,full,oidx")."""
    v = os.environ.get("MC_PROBE_PALLAS", "")
    if v in ("", "0"):
        return False
    return v == "1" or stage in {s.strip() for s in v.split(",")}


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
