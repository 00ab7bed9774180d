"""On-card feature-table construction and staging.

Port of metacache_tpu/ops/table_device.py as torch ops on an explicit
device. The (feature, target, window) stream of a build stays on the
card from the sketch kernel on, and a saved CSR table stages onto it as
probe rows filled there:

  1. the stream's chunks are placed into G = 2^gbits feature-range group
     buffers (quantile bounds from a 12-bit histogram of the features'
     top bits); each source chunk is freed once it is placed, and (tgt,
     win) packs to one pk lane here when the slots fit int32;
  2. each group is stably sorted by feature in place and contributes its
     distinct features and capped bucket sizes to the global uniq/sizes
     arrays at a running row offset;
  3. segment scans (cumsum, cummax, a reverse cummin) give each element
     its bucket row, in-bucket column and overflow row;
  4. scatters to unique destinations fill the probe layouts group by
     group: dense rows, two-tier head and overflow rows, or the
     size-classed cells, and the bucket-row index.

The arrays equal the JAX builder's bit for bit, with the same shapes,
for the same stream (tests/test_torch_table_device.py): pair-packed
arrays keep JAX's (R, 128) shape, two logical 64-lane rows a physical
row, which on the card is the same memory as (2R, 64), so the probe
reads them through a 64-lane ``view``. Features are int64 values in
0 .. 2^32 - 1 while they are sorted and compared (the sentinel
0xFFFFFFFF sorts last); the stored arrays are int32 bit patterns.
u64 features (k > 16) stage from a CSR only, as in JAX ("query-staging
only", table_device.py:1055-1056): ``device_layout_from_csr`` takes
them as int64 bit patterns, the sentinel -1, fills rows with two meta
lanes [flo, fhi] and takes the host's bucket index
(ops/probe.py::make_bucket_index64); the classed cells are u32 only.

Where the JAX builder weighs layouts in the TPU's row bytes (128-lane
tiles, pair-packed 64-lane rows), this one weighs them in the card's:
a row of c lanes is 4c bytes (ops/table.py::_bytes_for_fn). The two
agree on every row of at most 64 lanes and every width that is a
multiple of 128; for other widths above 64 lanes the budget can pick
another head or layout than JAX does.
"""
from __future__ import annotations

import os
import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import hbm_budget_bytes
from .probe import (collision_free_bits64, high32, low32,
                    make_bucket_index64)
from .table import _bytes_for_fn, _choose_head, _pad64, _quantize

IMAX = 2**31 - 1
SENT = 0xFFFFFFFF      # sentinel feature (empty sketch slots), as a value
HIST_BITS = 12         # top-bits histogram resolution for group bounds
_SCATTER_CHUNK = 1 << 24   # elements a scatter takes at a time


# copied from metacache_tpu/ops/table_device.py:45-65; arrays are torch
# tensors, features int32 bit patterns
class DeviceTable(NamedTuple):
    """Probe-ready device arrays (single part)."""
    uniq: torch.Tensor       # (F,) sorted distinct features, SENT padded
    #                          (int32 bits; int64 bits for u64 features)
    offsets: torch.Tensor    # (F+1,) i32 capped CSR offsets
    head: torch.Tensor       # (F, 64+) i32 fused head rows
    ovf: torch.Tensor        # (NOVF+1, ...) i32 overflow rows (row 0 dummy)
    brows: torch.Tensor      # (2^bits / 2, 128) i32 bucket-row probe index
    bbits: int
    nf: int                  # distinct features
    spf: int                 # slots per feature (= min(max bucket, cap))
    head_slots: int          # H (== spf when dense)
    num_locations: int       # total capped locations
    dense: bool = False      # head rows are the 1-gather dense layout
    layout_bytes: int = 0    # device bytes of head+ovf rows
    packed: bool = False     # head: two 64-lane rows per 128-lane row
    ovf_packed: bool = False  # overflow rows likewise
    max_win: int = 0         # max window index over all locations
    slot_bits: int = 0       # >0: rows store pk = (tgt << bits) | win
    classed: bool = False    # head = size-classed unified cell array


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in 0 .. 2^32 - 1."""
    return x.to(torch.int64) & 0xFFFFFFFF


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values -> int32 bit patterns (wrapping, as JAX's i32)."""
    return (((x + 2**31) & 0xFFFFFFFF) - 2**31).to(torch.int32)


def _put(flat: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor):
    """flat[idx] = vals for unique, in-range destinations (the callers
    drop the out-of-range ones JAX's mode="drop" scatters skip), a slice
    at a time so the index temporaries stay bounded."""
    for s in range(0, idx.shape[0], _SCATTER_CHUNK):
        e = s + _SCATTER_CHUNK
        flat[idx[s:e].to(torch.int64)] = vals[s:e].to(flat.dtype)


# copied from metacache_tpu/ops/table_device.py:90-105 and :256-271
def _marks_segments(marks: torch.Tensor):
    """Segment scans over a feature-sorted stream (int64 values,
    sentinel last) or over bucket-start flags (bool, the CSR path)
    -> (newf, r bucket id, col in-bucket position, size_el bucket
    size), the scans int64."""
    n = marks.shape[0]
    if marks.dtype == torch.bool:
        newf = marks
    else:
        prev = torch.cat([marks[:1] ^ 1, marks[:-1]])
        newf = marks != prev
    i = torch.arange(n, device=marks.device)
    r = torch.cumsum(newf, 0) - 1
    first = torch.cummax(torch.where(newf, i, -1), 0).values
    col = i - first
    # next bucket's start (this bucket's end), via a reverse cummin
    nxt = torch.cat([torch.where(newf, i, IMAX)[1:],
                     torch.full((1,), n, device=marks.device)])
    nxt = torch.cummin(nxt.flip(0), 0).values.flip(0)
    return newf, r, col, nxt - first


# copied from metacache_tpu/ops/table_device.py:111-135
def _chunk_stats(acc: torch.Tensor, f, t, w):
    """Accumulate one chunk into acc = [hist(2^HIST_BITS) | nsent | maxw
    | maxt] (int64, on the card; one fetch for the whole phase)."""
    fv = _u32(f)
    valid = fv != SENT
    nb = 1 << HIST_BITS
    bins = torch.where(valid, fv >> (32 - HIST_BITS), nb)
    acc[:nb + 1] += torch.bincount(bins, minlength=nb + 1)
    acc[nb + 1] = torch.maximum(acc[nb + 1],
                                torch.where(valid, w.to(torch.int64), 0).max())
    acc[nb + 2] = torch.maximum(acc[nb + 2],
                                torch.where(valid, t.to(torch.int64), 0).max())


# copied from metacache_tpu/ops/table_device.py:138-157
def _group_bounds(hist: np.ndarray, nsent: int, G: int):
    """Quantile group boundaries (G-1 ascending u32 values, bin-
    aligned, < SENT) over the REAL feature mass; group g = features in
    [bounds[g-1], bounds[g]); sentinels always land in the last group.
    -> (bounds (G-1,) u32, per-group element counts (G,))."""
    nb = len(hist)
    csum = np.cumsum(hist)
    total = int(csum[-1])
    edges = [0]
    for g in range(1, G):
        b = int(np.searchsorted(csum, g * total / G)) + 1
        edges.append(max(min(b, nb - 1), edges[-1]))
    edges.append(nb)
    bnds = (np.asarray(edges[1:G], np.uint64)
            << np.uint64(32 - HIST_BITS)).astype(np.uint32)
    counts = np.asarray(
        [int(hist[edges[g]:edges[g + 1]].sum()) for g in range(G)],
        np.int64)
    counts[G - 1] += int(nsent)
    return bnds, counts


# table_device.py:160-196
def _place_chunk(bufF, bufV, offs: list, f, t, w, bnds, slot_bits: int):
    """Append one chunk's elements to the (G, S) group buffers at the
    running per-group offsets ``offs`` (updated), in stream order; group
    = the quantile range of the feature value. ``slot_bits > 0`` packs
    (tgt, win) to pk = (tgt << bits) | win in bufV[0] here."""
    fv = _u32(f)
    t = t.to(torch.int32)
    w = w.to(torch.int32)
    vals = [(t << slot_bits) | w] if slot_bits else [t, w]
    grp = torch.searchsorted(bnds, fv, right=True)
    counts = torch.bincount(grp, minlength=len(offs)).tolist()
    order = torch.argsort(grp, stable=True)
    beg = 0
    for g, c in enumerate(counts):
        if c:
            sel = order[beg:beg + c]
            o = offs[g]
            bufF[g, o:o + c] = fv[sel]
            for v, vv in enumerate(vals):
                bufV[v, g, o:o + c] = vv[sel]
            offs[g] += c
            beg += c


# table_device.py:199-230
def _sort_group(bufF, bufV, g: int, presorted: bool):
    """Sort group row g by feature in place, stably when ``presorted``
    (the stream is ascending in (tgt, win) within each feature), else by
    (feature, pk) or (feature, tgt, win); -> (nf_g distinct real
    features, maxb_g max bucket size)."""
    fr = bufF[g]
    if presorted:
        order = torch.argsort(fr, stable=True)
    elif bufV.shape[0] == 1:
        # pk < 2^31 for every real element, so the key fits int64
        order = torch.argsort(fr * 2**31 + bufV[0, g].to(torch.int64))
    else:
        order = torch.argsort(bufV[1, g], stable=True)
        order = order[torch.argsort(bufV[0, g][order], stable=True)]
        order = order[torch.argsort(fr[order], stable=True)]
    fs = fr[order]
    bufF[g] = fs
    for v in range(bufV.shape[0]):
        bufV[v, g] = bufV[v, g][order]
    newf, _r, col, _ = _marks_segments(fs)
    valid = fs != SENT
    nf_g = int((newf & valid).sum())
    maxb_g = int(torch.where(valid, col, -1).max()) + 1
    return nf_g, maxb_g


# table_device.py:233-253
def _group_meta(uniq, sizes, fs, nf_off: int, nf_g: int, cap: int):
    """Write group fs's distinct features and capped bucket sizes into
    the global uniq/sizes arrays at row nf_off; -> the group's bucket-
    size histogram (cap + 1,)."""
    newf, _r, _col, size_el = _marks_segments(fs)
    m = newf & (fs != SENT)
    capped = torch.clamp(size_el[m], max=cap)
    uniq[nf_off:nf_off + nf_g] = fs[m]
    sizes[nf_off:nf_off + nf_g] = capped.to(torch.int32)
    return torch.bincount(capped, minlength=cap + 1)[:cap + 1].cpu().numpy()


# table_device.py:289-327
def _fill_span_g(rows, marks, vals, nf_off: int, novf_off: int, nf_g: int,
                 *, kind: str, colbase: int, head: int, cap: int):
    """One scatter pass writing a group's ``vals`` into ``rows`` (the
    logical 2-D view: 64 lanes a row when pair-packed). kind="head":
    bucket columns [0, head) at colbase+col of global row nf_off+r;
    kind="ovf": columns [head, cap) of oversized buckets at
    colbase+(col-head) of global overflow row novf_off+ovfid. Buckets at
    local r >= nf_g (sentinels, padding) are dropped."""
    newf, r, col, size_el = _marks_segments(marks)
    ok = r < nf_g
    if kind == "head":
        ok &= col < head
        rr, cc = nf_off + r, colbase + col
    else:
        over_el = torch.clamp(size_el, max=cap) > head
        ovfid_el = torch.cumsum(newf & over_el, 0)
        ok &= (col >= head) & (col < cap) & over_el
        rr, cc = novf_off + ovfid_el, colbase + col - head
    _put(rows.view(-1), (rr * rows.shape[1] + cc)[ok], vals[ok])


# table_device.py:330-365
def _head_init(sizes, uniq, hw: int, dense: bool, head: int,
               pack: bool = False, wide: bool = False):
    """Feature-row headers [f, count(, ovfid)] + zeroed slot lanes;
    (nf / 2, 128) when pair-packed, else (nf, hw). u64 features
    (``wide``, int64 bit patterns) take two meta lanes [flo, fhi,
    count(, ovfid)]: the probe verifies both after the row gather (the
    bucket index matches only the low 32 bits)."""
    nf = sizes.shape[0]
    rows = torch.zeros((nf // 2, 128) if pack else (nf, hw),
                       dtype=torch.int32, device=sizes.device)
    lg = rows.view(nf, 64) if pack else rows
    if wide:
        lg[:, 0] = low32(uniq)
        lg[:, 1] = high32(uniq)
    else:
        lg[:, 0] = _i32(uniq)
    nx = 2 if wide else 1
    lg[:, nx] = sizes
    if not dense:
        over_f = sizes > head
        lg[:, nx + 1] = torch.where(over_f, torch.cumsum(over_f, 0), 0)
    return rows


# copied from metacache_tpu/ops/table_device.py:368-378
def slot_pack_bits(maxwin: int, maxtgt: int) -> int:
    """wbits for the packed slot encoding, or 0 when it cannot fit i32.

    One extra bit of window headroom keeps the inter-target gap larger
    than any clamped mwir (see ops/candidates.py). MC_PACK_STORE=0 keeps
    (tgt, win) lane pairs."""
    if os.environ.get("MC_PACK_STORE", "1") == "0":
        return 0
    wbits = max(1, (2 * maxwin).bit_length())
    pkmax = (maxtgt << wbits) | maxwin
    return wbits if pkmax < 2**31 - 1 else 0


def _bucket_locals(uniq, bits: int):
    """-> (h bucket of each feature, newh first of its bucket, local
    position in its bucket), int64."""
    fi = torch.arange(uniq.shape[0], device=uniq.device)
    h = uniq >> (32 - bits)
    newh = h != torch.cat([torch.full((1,), -1, device=uniq.device), h[:-1]])
    firsth = torch.cummax(torch.where(newh, fi, -1), 0).values
    return h, newh, fi - firsth


# table_device.py:381-415
def _brows_build(uniq, bits: int):
    """Bucket-row probe index (logical row h = [start, features...],
    64 lanes, pair-packed two a physical row), -1 padded."""
    nb = 1 << bits
    h, newh, local = _bucket_locals(uniq, bits)
    fi = torch.arange(uniq.shape[0], device=uniq.device)
    bstart = torch.full((nb + 1,), IMAX, dtype=torch.int64,
                        device=uniq.device)
    bstart[h[newh]] = fi[newh]
    # empty buckets point at the next nonempty one (== searchsorted);
    # sentinel padding rows land in the last bucket, whose scattered
    # value (-1) equals the empty-lane fill
    bstart = torch.cummin(bstart.flip(0), 0).values.flip(0)[:nb]
    bstart = torch.clamp(bstart, max=int((uniq != SENT).sum()))
    brows = torch.full((nb // 2, 128), -1, dtype=torch.int32,
                       device=uniq.device)
    lg = brows.view(nb, 64)
    lg[:, 0] = bstart.to(torch.int32)
    keep = local < 63
    _put(brows.view(-1), (h * 64 + 1 + local)[keep], _i32(uniq)[keep])
    return brows


CLASS_LADDER = (13, 29, 61)   # slots per cell class (16/32/64 lanes), :420


# copied from metacache_tpu/ops/table_device.py:423-442
def _want_classed(head: int, spf: int, dense: bool, slot_bits: int):
    """Layout policy for the size-classed head array: MC_CLASSED=0
    never, =1 always (budget permitting); unset: only when the budget
    pinched the two-tier head below the ladder's top class, where the
    classed cells buy head depth for the same bytes."""
    mc = os.environ.get("MC_CLASSED", "")
    if mc == "0" or dense or not slot_bits:
        return False
    if mc == "1":
        return True
    return head < min(CLASS_LADDER[2], spf)


# copied from metacache_tpu/ops/table_device.py:445-452
def _classed_total16(nA: int, nB: int, nC: int):
    """16-lane-unit extent of the unified classed head array; classes
    are grouped (A then B then C) with 8-unit (one physical row)
    aligned bases so no cell crosses a 128-lane row."""
    baseA = 0
    baseB = -(-(baseA + nA) // 8) * 8
    baseC = -(-(baseB + 2 * nB) // 8) * 8
    return baseA, baseB, baseC, baseC + 4 * nC


# table_device.py:455-475
def _classed_addr(sizes, spf: int):
    """Per-feature classed-cell addresses -> (addr16 cell offset in
    16-lane units, cls class 0/1/2, ovfid), int64."""
    hA, hB, hC = CLASS_LADDER
    cls = torch.where(sizes <= hA, 0, torch.where(sizes <= hB, 1, 2))
    isA, isB, isC = cls == 0, cls == 1, cls == 2
    nA = torch.cumsum(isA, 0)
    nB = torch.cumsum(isB, 0)
    nC = torch.cumsum(isC, 0)
    baseB = (nA[-1] + 7) // 8 * 8
    baseC = (baseB + 2 * nB[-1] + 7) // 8 * 8
    rank = torch.where(isA, nA - 1, torch.where(isB, nB - 1, nC - 1))
    w16 = torch.where(isA, 1, torch.where(isB, 2, 4))
    base = torch.where(isA, 0, torch.where(isB, baseB, baseC))
    over_f = sizes > min(hC, spf)
    ovfid = torch.where(over_f, torch.cumsum(over_f, 0), 0)
    return base + rank * w16, cls, ovfid


# table_device.py:478-490
def _classed_meta_fill(rows, uniq, sizes, addr16, cls, ovfid):
    """Write per-cell meta lanes [feat, cnt(, ovfid for class C)]."""
    flat = rows.view(-1)
    pos = addr16 * 16
    _put(flat, pos, _i32(uniq))
    _put(flat, pos + 1, sizes)
    c = cls == 2
    _put(flat, pos[c] + 2, ovfid[c])


# table_device.py:493-514
def _classed_slot_fill_g(rows, marks, vals, nf_off: int, nf_g: int,
                         addr16_f, cls_f, spf: int):
    """Scatter a group's in-head slots into classed cells (slot lanes
    start at meta+col; class C head = min(61, spf) slots). addr16_f and
    cls_f are the global per-feature arrays, read at row nf_off+r."""
    _newf, r, col, _ = _marks_segments(marks)
    rg = torch.clamp(nf_off + r, max=addr16_f.shape[0] - 1)
    a16 = addr16_f[rg]
    cl = cls_f[rg]
    meta = torch.where(cl == 2, 3, 2)
    cap = torch.where(cl == 2, min(61, spf),
                      torch.where(cl == 1, CLASS_LADDER[1], CLASS_LADDER[0]))
    ok = (col < cap) & (r < nf_g)
    _put(rows.view(-1), (a16 * 16 + meta + col)[ok], vals[ok])


# table_device.py:517-570
def _brows_build_classed(uniq, cls_f, bits: int):
    """Classed bucket-row index: logical 64-lane row h = [a16_A, a16_B,
    a16_C, 61 x packed-entry lanes], pair-packed two a 128-lane row.

    A packed-entry lane holds two features' entries (low/high 16 bits),
    each e + 1 with e = (class << 14) | (feature & low_mask); 0 means
    empty. a16_X is the cell address the bucket's first class-X feature
    would get, so the probe computes addr16 = a16_X + (#earlier
    same-class entries) * w16."""
    nb = 1 << bits
    dev = uniq.device
    h, newh, local = _bucket_locals(uniq, bits)
    brows = torch.zeros((nb // 2, 128), dtype=torch.int32, device=dev)
    flat = brows.view(-1)
    # class-start ranks at each feature (same-class features before it),
    # converted to that class's cell address (bases as _classed_addr's)
    ccum = [torch.cumsum(cls_f == c, 0) - (cls_f == c).to(torch.int64)
            for c in range(3)]
    totA = int((cls_f == 0).sum())
    totB = int((cls_f == 1).sum())
    baseB = (totA + 7) // 8 * 8
    baseC = (baseB + 2 * totB + 7) // 8 * 8
    for c, (base, w) in enumerate(((0, 1), (baseB, 2), (baseC, 4))):
        _put(flat, h[newh] * 64 + c, (base + ccum[c] * w)[newh])
    low_mask = (1 << (32 - bits)) - 1
    e1 = ((cls_f << 14) | (uniq & low_mask)) + 1
    e1 = torch.where(uniq != SENT, e1, 0)
    # two entries share a lane (halves): fold each odd-local entry into
    # its even-local predecessor before the unique-index scatter
    nxt_e1 = torch.cat([e1[1:], torch.zeros(1, dtype=e1.dtype, device=dev)])
    nxt_h = torch.cat([h[1:], torch.full((1,), -1, device=dev)])
    pair = (nxt_h == h) & ((local & 1) == 0)
    val = e1 | torch.where(pair, nxt_e1 << 16, 0)
    lane = 3 + (local >> 1)
    keep = (lane < 64) & ((local & 1) == 0)
    _put(flat, (h * 64 + lane)[keep], _i32(val[keep]))
    return brows


# table_device.py:573-582
def _max_span(uniq, bits: int) -> int:
    """Widest same-hash-prefix feature run (sentinel rows excluded)."""
    _h, _newh, local = _bucket_locals(uniq, bits)
    return int(torch.where(uniq != SENT, local, 0).max()) + 1


# copied from metacache_tpu/ops/table_device.py:585-601
def _choose_bits(uniq, bits: int, span_cap: int = 63,
                 min_bits: int = 0) -> int:
    """Smallest hash-prefix width whose widest span fits the bucket row
    (63 features, or 122 packed 16-bit entries for the classed index)."""
    bits = max(bits, min_bits)
    while bits < 26 and _max_span(uniq, bits) > span_cap:
        bits += 1
    if bits >= 26 and _max_span(uniq, bits) > span_cap:
        raise MemoryError(
            f"bucket-row span exceeds {span_cap} even at 2^{bits} "
            "prefix buckets; split the database (-parts/-table-shards)")
    return bits


# copied from metacache_tpu/ops/table_device.py:603-614
def _pack_auto(nf_rows: int) -> bool:
    """Pair-pack 64-lane rows when the TPU's tiling padding would waste
    more than 3 GiB (kept so the arrays equal JAX's; on the card a
    pair-packed array is the same memory as the unpacked one).
    MC_PACK_ROWS=0/1 overrides."""
    env = os.environ.get("MC_PACK_ROWS")
    if env in ("0", "1"):
        return env == "1"
    return nf_rows * 512 > (3 << 30)


def _ovf_shape(novf: int, ocols: int):
    """(overflow rows incl. the dummy, pair-packed) for novf rows of
    ocols lanes (table_device.py:646-650)."""
    novf_pad = _quantize(novf, 10) if novf else 0
    novf_rows = novf_pad + 2 if novf_pad % 2 else novf_pad + 1
    return novf_rows, ocols == 64 and novf_rows % 2 == 0


def _zeros_rows(nrows: int, ocols: int, pack: bool, device):
    return torch.zeros((nrows // 2, 128) if pack else (nrows, ocols),
                       dtype=torch.int32, device=device)


def _logical(rows: torch.Tensor, pack: bool) -> torch.Tensor:
    """The 64-lane logical view of pair-packed rows."""
    return rows.view(-1, 64) if pack else rows


# table_device.py:623-685
def _fill_layouts(get_mv, G: int, nf_offs, nf_gs, novf_offs, sizes, uniq,
                  *, nf_pad: int, novf: int, cap: int, head: int,
                  bits: int, dense: bool, pack_rows: bool, slot_bits: int,
                  index=None):
    """Head rows, overflow rows and the bucket index, filled group by
    group. get_mv(g) -> (marks, [value streams]) of group g. u64
    features (uniq of int64 bit patterns) come with their host-built
    bucket index, ``index`` = (rows, bits), and take an extra meta
    lane."""
    wide = index is not None
    base = (2 if dense else 3) + wide
    spl = 1 if slot_bits else 2        # lanes per slot
    hw = _pad64(base + spl * head)
    pack = pack_rows and hw == 64 and nf_pad % 2 == 0
    ow = cap - head
    ocols = _pad64(spl * ow) if ow > 0 else 64
    novf_rows, opack = _ovf_shape(novf, ocols)
    ovfrows = _zeros_rows(novf_rows, ocols, opack, sizes.device)
    headrows = _head_init(sizes, uniq, hw=hw, dense=dense, head=head,
                          pack=pack, wide=wide)
    hl, ol = _logical(headrows, pack), _logical(ovfrows, opack)
    for g in range(G):
        if nf_gs[g] == 0:
            continue
        marks, vals = get_mv(g)
        kw = dict(nf_off=int(nf_offs[g]), novf_off=int(novf_offs[g]),
                  nf_g=int(nf_gs[g]), head=head, cap=cap)
        for v, vv in enumerate(vals):
            if ow > 0 and novf > 0:
                _fill_span_g(ol, marks, vv, kind="ovf", colbase=v * ow, **kw)
            _fill_span_g(hl, marks, vv, kind="head",
                         colbase=base + v * head, **kw)
        del marks, vals
    brows = _brows_build(uniq, bits) if index is None else \
        torch.from_numpy(index[0]).to(sizes.device)
    return headrows, ovfrows, brows, pack, opack


# copied from metacache_tpu/ops/table_device.py:692-700
def _classed_counts(hist: np.ndarray, nf_pad: int):
    """(nA, nB, nC) class populations incl. sentinel padding rows
    (size 0 -> class A) from the REAL bucket-size histogram."""
    hA, hB = CLASS_LADDER[0], CLASS_LADDER[1]
    real = int(hist.sum())
    nA = int(hist[:hA + 1].sum()) + (nf_pad - real)
    nB = int(hist[hA + 1:hB + 1].sum())
    nC = nf_pad - nA - nB
    return nA, nB, nC


# copied from metacache_tpu/ops/table_device.py:703-716, with the port's
# row bytes (4 bytes a lane, no pair-packing)
def _classed_bytes(hist: np.ndarray, nf_pad: int, spf: int,
                   cum_over: np.ndarray):
    """Bytes of the classed head array + overflow rows."""
    nA, nB, nC = _classed_counts(hist, nf_pad)
    *_b, total16 = _classed_total16(nA, nB, nC)
    P = -(-_quantize(max(total16, 8), 10) // 8)
    hC = min(CLASS_LADDER[2], spf)
    b = P * 512
    if spf > hC:
        novf = int(cum_over[hC + 1])
        b += (_quantize(novf, 10) + 1) * _pad64(spf - hC) * 4
    return b


# table_device.py:719-756
def _fill_layouts_classed(get_mv, G: int, nf_offs, nf_gs, novf_offs,
                          sizes, uniq, *, novf: int, cap: int, bits: int,
                          P16: int):
    """Classed unified head cells + overflow rows + classed bucket
    index, filled group by group (slot-packed layouts only)."""
    hC = min(CLASS_LADDER[2], cap)
    ow = cap - hC
    ocols = _pad64(ow) if ow > 0 else 64
    novf_rows, opack = _ovf_shape(novf, ocols)
    addr16_f, cls_f, ovfid_f = _classed_addr(sizes, spf=cap)
    ovfrows = _zeros_rows(novf_rows, ocols, opack, sizes.device)
    headrows = torch.zeros((-(-P16 // 8), 128), dtype=torch.int32,
                           device=sizes.device)
    _classed_meta_fill(headrows, uniq, sizes, addr16_f, cls_f, ovfid_f)
    ol = _logical(ovfrows, opack)
    for g in range(G):
        if nf_gs[g] == 0:
            continue
        marks, (vals,) = get_mv(g)
        nf_off, nf_g = int(nf_offs[g]), int(nf_gs[g])
        if ow > 0 and novf > 0:
            _fill_span_g(ol, marks, vals, nf_off, int(novf_offs[g]), nf_g,
                         kind="ovf", colbase=0, head=hC, cap=cap)
        _classed_slot_fill_g(headrows, marks, vals, nf_off, nf_g,
                             addr16_f, cls_f, spf=cap)
        del marks, vals
    return headrows, ovfrows, _brows_build_classed(uniq, cls_f, bits), opack


# copied from metacache_tpu/ops/table_device.py:818-833
# table_device.py:881-887
def debug_note(msg: str):
    """Per-phase progress of the build and the staging, under
    MC_BUILD_DEBUG=1."""
    if os.environ.get("MC_BUILD_DEBUG") == "1":
        print(f"[build {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _choose_gbits(total_elems: int) -> int:
    """Feature-range group count (2^gbits) for the bounded-memory
    build: at most ~48M elements a group. MC_BUILD_GBITS overrides (0 =
    a single group)."""
    env = os.environ.get("MC_BUILD_GBITS")
    if env is not None:
        try:
            return max(0, min(4, int(env)))
        except ValueError:
            pass
    g = 0
    while (total_elems >> g) > (48 << 20) and g < 4:
        g += 1
    return g


def build_device_table(f, t, w, *, cap: int = 254,
                       budget_bytes: int | None = None,
                       presorted: bool = True) -> DeviceTable:
    """(feature, tgt, win) tensors -> probe-ready DeviceTable
    (single-chunk wrapper over the grouped builder,
    table_device.py:836-844)."""
    return build_device_table_chunked([(f, t, w)], cap=cap,
                                      budget_bytes=budget_bytes,
                                      presorted=presorted)


# table_device.py:847-962
def build_device_table_chunked(chunks: list, *, cap: int = 254,
                               budget_bytes: int | None = None,
                               presorted: bool = True,
                               gbits: int | None = None) -> DeviceTable:
    """List of (feature int32 bit patterns, tgt, win) chunk triples on
    one device -> probe-ready DeviceTable on that device. CONSUMES the
    list: each chunk frees once it is placed into the group buffers.
    Sentinel features (empty sketch lanes) may be included; they are
    dropped. The head width is chosen against ``budget_bytes``: dense
    when it fits, else the smallest fitting two-tier split or the
    size-classed cells (_want_classed).

    ``presorted=True`` asserts the concatenated stream is ascending in
    (tgt, win) within each feature (true for any sequential build)."""
    if not chunks:
        raise ValueError("no chunks: the builder takes its device from "
                         "the first")
    dev = chunks[0][0].device
    chunks[:] = [c for c in chunks if c[0].shape[0] > 0]
    if not chunks:           # empty stream: one all-sentinel element
        z = torch.zeros(1, dtype=torch.int32, device=dev)
        chunks.append((z - 1, z, z))
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(dev)
    total = sum(int(c[0].shape[0]) for c in chunks)
    G = 1 << (_choose_gbits(total) if gbits is None else gbits)

    # phase 1: value histogram (quantile group bounds), max window/target
    debug_note(f"phase1 stats: {len(chunks)} chunks, G={G}")
    acc = torch.zeros((1 << HIST_BITS) + 3, dtype=torch.int64, device=dev)
    for cf, ct, cw in chunks:
        _chunk_stats(acc, cf, ct, cw)
    acc_h = acc.cpu().numpy()
    nb = 1 << HIST_BITS
    nsent, maxw, maxt = (int(x) for x in acc_h[nb:nb + 3])
    bnds_np, counts = _group_bounds(acc_h[:nb], nsent, G)
    bnds = torch.from_numpy(bnds_np.astype(np.int64)).to(dev)
    debug_note(f"phase1 done: counts={counts.tolist()}")
    slot_bits = slot_pack_bits(maxw, maxt)
    V = 1 if slot_bits else 2

    # phase 2: place the chunks into the (G, S) group buffers, freeing
    # each source chunk after its placement
    S = _quantize(int(max(counts.max(), 1)), 14)
    debug_note(f"phase2 place: S={S} slot_bits={slot_bits}")
    bufF = torch.full((G, S), SENT, dtype=torch.int64, device=dev)
    bufV = torch.zeros((V, G, S), dtype=torch.int32, device=dev)
    offs = [0] * G
    nplaced = 0
    while chunks:
        _place_chunk(bufF, bufV, offs, *chunks.pop(0), bnds, slot_bits)
        nplaced += 1
        if nplaced % 64 == 0:
            debug_note(f"placed {nplaced}")
    debug_note("phase2 done")

    # phase 3: in-place per-group sorts
    nf_gs, maxb = [], 0
    for g in range(G):
        nf_g, maxb_g = _sort_group(bufF, bufV, g, presorted)
        nf_gs.append(nf_g)
        maxb = max(maxb, maxb_g)
        debug_note(f"sorted group {g}: nf_g={nf_g}")
    nf = sum(nf_gs)
    nf_offs = np.concatenate([[0], np.cumsum(nf_gs)]).astype(np.int64)
    spf = max(min(maxb, cap), 1)
    nf_pad = _quantize(nf, 12)

    # phase 4: global distinct-feature metadata + per-group histograms
    uniq = torch.full((nf_pad,), SENT, dtype=torch.int64, device=dev)
    sizes = torch.zeros((nf_pad,), dtype=torch.int32, device=dev)
    hists = [_group_meta(uniq, sizes, bufF[g], int(nf_offs[g]), nf_gs[g],
                         spf) for g in range(G)]
    debug_note(f"meta done: nf={nf} spf={spf}; filling layouts")
    return _layout_and_fill(
        lambda g: (bufF[g], [bufV[v, g] for v in range(V)]), G, nf_offs,
        nf_gs, hists, sizes, uniq, nf=nf, nf_pad=nf_pad, spf=spf,
        hist=np.sum(hists, axis=0), slot_bits=slot_bits, maxw=maxw,
        budget_bytes=budget_bytes, what="table")


# table_device.py:965-1038
def _layout_and_fill(get_mv, G, nf_offs, nf_gs, hists, sizes, uniq, *, nf,
                     nf_pad, spf, hist, slot_bits, maxw, budget_bytes, what,
                     allow_dense=True, index=None) -> DeviceTable:
    """Shared tail of the grouped builders: choose the layout against
    the budget, run the grouped fills, assemble the DeviceTable. u64
    features: pass the host-built bucket index as ``index`` = (rows,
    bits); its bytes count in the budget beside the rows, as it may be
    wider than JAX's (device_layout_from_csr). The classed cells are u32
    only."""
    wide = index is not None
    index_b = index[0].nbytes if wide else 0
    rows_for = _bytes_for_fn(nf_pad, spf, 1 if slot_bits else 2, wide=wide)

    def bytes_for(hd, n_over):
        return rows_for(hd, n_over) + index_b
    cum_over = np.cumsum(hist[::-1])[::-1]        # #buckets size >= idx
    if allow_dense and bytes_for(spf, 0) <= budget_bytes:
        head = spf                                 # dense: no overflow
    else:
        head = _choose_head(spf, cum_over, bytes_for, budget_bytes,
                            what, slot_packed=bool(slot_bits))
    dense = head == spf
    use_classed = not wide and _want_classed(head, spf, dense, slot_bits)
    if use_classed:
        cb = _classed_bytes(hist, nf_pad, spf, cum_over)
        use_classed = cb <= budget_bytes and \
            cb < bytes_for(head, int(cum_over[head + 1]))
    debug_note(f"layout: head {head} of {spf} slots"
          f"{' (dense)' if dense else ''}{' (classed)' if use_classed else ''}"
          f", {G} groups")
    base_bits = min(24, max(12, int(max(nf_pad, 1)).bit_length() - 4))

    def novf_offsets(h):
        """Per-group overflow-row offsets for head width h."""
        per_g = [int(hg[h + 1:].sum()) for hg in hists]
        return np.concatenate([[0], np.cumsum(per_g)]).astype(np.int64)

    offsets = torch.cat([torch.zeros(1, dtype=torch.int64,
                                     device=sizes.device),
                         torch.cumsum(sizes, 0)]).to(torch.int32)
    num_loc = int(offsets[-1])
    common = dict(uniq=uniq if wide else _i32(uniq), offsets=offsets, nf=nf,
                  spf=spf,
                  num_locations=num_loc, max_win=maxw, slot_bits=slot_bits)

    if use_classed:
        hC = min(CLASS_LADDER[2], spf)
        novf = int(cum_over[hC + 1]) if hC < spf else 0
        bits = _choose_bits(uniq, base_bits, span_cap=122, min_bits=18)
        *_bases, total16 = _classed_total16(*_classed_counts(hist, nf_pad))
        headrows, ovfrows, brows, opack = _fill_layouts_classed(
            get_mv, G, nf_offs, nf_gs, novf_offsets(hC), sizes, uniq,
            novf=novf, cap=spf, bits=bits,
            P16=_quantize(max(total16, 8), 10))
        return DeviceTable(head=headrows, ovf=ovfrows, brows=brows,
                           bbits=bits, head_slots=hC, dense=False,
                           layout_bytes=_classed_bytes(hist, nf_pad, spf,
                                                       cum_over),
                           packed=False, ovf_packed=opack, classed=True,
                           **common)

    novf = int(cum_over[head + 1]) if head < spf else 0
    bits = index[1] if wide else _choose_bits(uniq, base_bits)
    headrows, ovfrows, brows, pack, opack = _fill_layouts(
        get_mv, G, nf_offs, nf_gs, novf_offsets(head), sizes, uniq,
        nf_pad=nf_pad, novf=novf, cap=spf, head=head, bits=bits,
        dense=dense, pack_rows=_pack_auto(nf_pad), slot_bits=slot_bits,
        index=index)
    return DeviceTable(head=headrows, ovf=ovfrows, brows=brows, bbits=bits,
                       head_slots=head, dense=dense,
                       layout_bytes=bytes_for(head, novf), packed=pack,
                       ovf_packed=opack, **common)


# table_device.py:1041-1127
def export_csr(dt: DeviceTable, chunk: int = 1 << 25):
    """DeviceTable -> host CSR arrays (uniq u32, offsets i64, locations
    u64 packed (tgt << 32 | win)). The build consumed its stream, so the
    locations are read back from the probe rows: element j of bucket r
    is head slot col(j) or overflow slot col(j) - H."""
    if dt.uniq.dtype == torch.int64:
        raise ValueError("u64 tables are query-staging only (built from "
                         "a CSR save, table_device.py:1055-1056)")
    dev = dt.head.device
    nf, n, hsl = dt.nf, dt.num_locations, dt.head_slots
    uniq = dt.uniq[:nf].cpu().numpy().view(np.uint32)
    offs = dt.offsets[:nf + 1].to(torch.int64)
    base = 2 if dt.dense else 3
    ow = dt.spf - hsl
    head = dt.head.reshape(-1)
    hw = 64 if dt.packed else dt.head.shape[1]
    ovf = dt.ovf.reshape(-1)
    ovw = 64 if dt.ovf_packed else dt.ovf.shape[1]
    if dt.classed:
        # per-feature addresses follow from the bucket sizes (as built)
        sizes = torch.diff(dt.offsets.to(torch.int64))   # all nf_pad rows
        addr16_f, cls_f, _ovf = _classed_addr(sizes, dt.spf)

        def head_lane(r, lane):
            # `lane` counts from the two-tier convention (meta base 3):
            # classes A/B have no ovfid lane, so their slots shift -1
            ln = torch.where((lane >= 3) & (cls_f[r] != 2), lane - 1, lane)
            return head[addr16_f[r] * 16 + ln]
    else:
        def head_lane(r, lane):
            return head[r * hw + lane]
    locs = np.empty(n, np.uint64)
    for j0 in range(0, n, chunk):
        j = torch.arange(j0, min(j0 + chunk, n), device=dev)
        r = torch.searchsorted(offs[1:], j, right=True)
        col = j - offs[r]
        hcol = torch.clamp(col, max=hsl - 1)
        v = head_lane(r, base + hcol)
        vw = head_lane(r, base + hsl + hcol) if not dt.slot_bits else v
        if not dt.dense and ow > 0:
            # lane 2 of a class A/B cell is a slot: its overflow "row" is
            # read clamped, as JAX's gather reads it, and never used
            o = _u32(head_lane(r, torch.full_like(r, 2))) * ovw + \
                torch.clamp(col - hsl, 0, ow - 1)
            use_head = col < hsl
            v = torch.where(use_head, v,
                            ovf[torch.clamp(o, max=ovf.numel() - 1)])
            if not dt.slot_bits:
                vw = torch.where(use_head, vw,
                                 ovf[torch.clamp(o + ow, max=ovf.numel() - 1)])
        if dt.slot_bits:
            tgt = _u32(v) >> dt.slot_bits
            win = v.to(torch.int64) & ((1 << dt.slot_bits) - 1)
        else:
            tgt, win = _u32(v), _u32(vw)
        locs[j0:j0 + len(j)] = ((tgt << 32) | win).cpu().numpy() \
            .view(np.uint64)
    return uniq, offs.cpu().numpy(), locs


# table_device.py:1130-1239
def device_layout_from_csr(uniq_host: np.ndarray, offsets_host,
                           ltgt: np.ndarray, lwin: np.ndarray, *,
                           device: torch.device, cap: int = 254,
                           budget_bytes: int | None = None,
                           allow_dense: bool = True,
                           gbits: int | None = None) -> DeviceTable:
    """Stage a saved/loaded CSR table as probe rows on ``device``.

    Uploads the CSR stream feature-range group by group (bucket-start
    marks plus pk, or tgt and win, lanes: 5 or 9 bytes a location) and
    fills the row layouts on the card, so the padded rows never cross
    the host link; at most one group's stream is on the card beyond the
    layouts (each upload frees after its fills).

    u64 features (``uniq_host`` uint64, k > 16) need slot-packable
    locations and a bucket index without a low-32 collision within a
    bucket (make_bucket_index64). Where its default width has one, JAX's
    runner falls back to its CSR probe (runner.py:505-540); this widens
    the index to the least width free of collisions
    (collision_free_bits64), up to 26 bits (a wider index only splits
    buckets; 16 GiB at 26), so that such tables keep their rows, and
    raises MemoryError where a collision or unpackable slots remain, or
    where the rows and the index together exceed the budget: the runner
    then stages the CSR layout, as JAX's does."""
    if budget_bytes is None:
        budget_bytes = hbm_budget_bytes(device)
    nf = len(uniq_host)
    n = len(ltgt)
    nf_pad = _quantize(nf, 12)
    G = 1 << (_choose_gbits(n) if gbits is None else gbits)
    sizes_h = np.diff(offsets_host).astype(np.int64)
    spf = max(min(int(sizes_h.max()) if nf else 1, cap), 1)
    sizes_capped = np.minimum(sizes_h, spf).astype(np.int32)
    maxw = int(lwin.max()) if n else 0
    slot_bits = slot_pack_bits(maxw, int(ltgt.max()) if n else 0)
    wide = uniq_host.dtype == np.uint64
    index = None
    if wide:
        if not slot_bits:
            raise MemoryError("u64 device layout needs slot-packable "
                              "locations")
        index = make_bucket_index64(uniq_host)
        if index is None:
            bits = collision_free_bits64(uniq_host)
            index = make_bucket_index64(uniq_host, bits) \
                if bits <= 26 else None
        if index is None:
            raise MemoryError("u64 bucket index: low-32 collision "
                              "within a bucket at every width")
        uniq_bits = uniq_host.view(np.int64)
        fsent = -1
    else:
        uniq_bits = uniq_host.astype(np.int64)
        fsent = SENT

    # feature-range groups: equal-element quantile cuts over the CSR
    offs64 = np.asarray(offsets_host, np.int64)
    if G > 1:
        targets = np.asarray([n * g // G for g in range(1, G)], np.int64)
        fb = np.searchsorted(offs64[1:], targets, side="left") + 1
        lo_f = np.maximum.accumulate(np.concatenate(
            [[0], np.minimum(fb, nf), [nf]]).astype(np.int64))
    else:
        lo_f = np.asarray([0, nf], np.int64)
    nf_gs = np.diff(lo_f)
    hists = [np.bincount(sizes_capped[lo_f[g]:lo_f[g + 1]],
                         minlength=spf + 1) for g in range(G)]
    uniq = torch.from_numpy(np.pad(
        uniq_bits, (0, nf_pad - nf), constant_values=fsent)).to(device)
    sizes = torch.from_numpy(np.pad(sizes_capped, (0, nf_pad - nf))).to(
        device)

    def get_mv(g):
        """Stage group g's stream: bool bucket-start marks + values
        (pk, or tgt/win lanes); padded tail elements are singleton
        buckets at local r >= nf_g (dropped by the fills)."""
        e0, e1 = int(offs64[lo_f[g]]), int(offs64[lo_f[g + 1]])
        m = e1 - e0
        Sg = _quantize(max(m, 1), 14)
        start = np.ones(Sg, bool)
        start[:m] = False
        st = offs64[lo_f[g]:lo_f[g + 1]][
            sizes_h[lo_f[g]:lo_f[g + 1]] > 0] - e0
        start[st] = True
        tg = ltgt[e0:e1].astype(np.int64, copy=False)
        wg = lwin[e0:e1].astype(np.int64, copy=False)
        lanes = [(tg << slot_bits) | wg] if slot_bits else [tg, wg]
        vals = []
        for x in lanes:
            v = np.zeros(Sg, np.int32)
            v[:m] = x
            vals.append(torch.from_numpy(v).to(device))
        return torch.from_numpy(start).to(device), vals

    return _layout_and_fill(
        get_mv, G, lo_f, nf_gs, hists, sizes, uniq, nf=nf, nf_pad=nf_pad,
        spf=spf, hist=np.sum(hists, axis=0), slot_bits=slot_bits, maxw=maxw,
        budget_bytes=budget_bytes, what="layout", allow_dense=allow_dense,
        index=index)


def dense_bytes(nf: int, spf: int, slot_bits: int,
                wide: bool = False) -> int:
    """Bytes of the dense layout the builder weighs for nf features."""
    return _bytes_for_fn(_quantize(nf, 12), spf,
                         1 if slot_bits else 2, wide=wide)(spf, 0)
