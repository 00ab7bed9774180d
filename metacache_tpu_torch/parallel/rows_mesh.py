"""Row-layout classification over a (data, table) grid of devices.

Port of metacache_tpu/parallel/rows_mesh.py. Two compositions of the
row pipeline (ops/rows.py):

1. Data parallelism (``-replicate``; the table fits one device, the
   reference's P1/P4): every stage is per row, so the runner splits a
   batch's rows over the replicas and runs the single-device step on
   each (classify/runner.py); nothing crosses devices but the results.

2. Table sharding (``-table-shards``; the reference's P2/P3): each
   "table" position holds a feature-range shard of the one part, with
   its own rows and bucket-row index (``shard_row_table``), and probes
   its data group's whole batch; an exchange then trades slot columns
   for row blocks, so position (d, r) receives every shard's slots of
   the r-th 1/P of group d's rows and finishes candidates and the LCA
   there (``sharded_query_step_rows``). This replaces the reference's
   serial GPU P2P pipeline (src/query_batch.cu:464-527).

JAX leaves its two collectives to XLA; here one process drives the
grid and they are copies between its devices: the all_gather of the
sketches over "table" and the all_to_all of the slot columns are
``Tensor.to(device, non_blocking=True)`` of each block, then
``torch.cat`` in shard order. A copy between two CUDA devices runs on
the source's current stream, which PyTorch orders with CUDA events
against both devices' current streams; between two positions on one
device it is no copy at all. Each position's kernels launch with its
device current (``on_device``).

The exchanged rows are P shard blocks side by side; they take the
port's route (``ops/rows.py::route``): B4 on packed slots, B5 on
(tgt, win) pairs, else ``rows_to_result``'s non-fused branch. JAX
never fuses under a mesh (runner.py:623); the results are the same.
"""
from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from ..device import hbm_budget_bytes
from ..ops.candidates import padded_width
from ..ops.pipeline import QueryResult, concat_results
from ..ops.probe import make_bucket_index
from ..ops.rows import probe_rows, probe_rows_head, route, rows_to_result
from ..ops.sketch import sketch_windows
from ..ops.table import FeatureTable
from ..ops.table_device import slot_pack_bits
from ..db.state import tables_from_numpy
from ..taxonomy.model import NUM_RANKS
from .mesh import make_mesh, on_device

U64_REFUSAL = (
    "-table-shards over more than one device needs 32-bit features "
    "(k <= 16): metacache_tpu's shard_row_table writes each feature into "
    "one int32 lane (metacache_tpu/parallel/rows_mesh.py:98, :121), which "
    "fails for the 64-bit features of k > 16, so the JAX package does not "
    "classify such a database under -table-shards either; query it "
    "without -table-shards")


class ShardedRowTable(NamedTuple):
    """Feature-range shards of one part on a grid of devices.

    slot_bits == 0: each shard holds dense (tgt, win)-lane rows
    [feature, count, tgt * spf, win * spf]. slot_bits > 0: two-tier
    slot-packed shards, head rows [feature, count, ovf_idx, pk *
    head_slots] and overflow rows (the deep-bucket layout; the exchange
    then moves one pk lane a slot instead of the (tgt, win) pair)."""
    features: list            # per shard: (n_p,) u32 ascending
    offsets: list             # per shard: (n_p + 1,) int64, from 0
    tables: np.ndarray        # (num_data, num_table) DeviceTables
    grid: np.ndarray          # (num_data, num_table) torch.device
    shard_bytes: list         # bytes of one copy of each shard
    shard_seconds: list       # each shard's host rows and its copies
    slots_per_feature: int
    prefix_bits: int
    slot_bits: int = 0
    head_slots: int = 0


def shard_row_table(part: FeatureTable, num_shards: int, maxloc: int,
                    layout: str = "auto", grid=None, lineages=None,
                    merge_tax=None) -> ShardedRowTable:
    """Cut ``part`` into ``num_shards`` feature ranges and stage shard p
    on the devices of grid column p (rows_mesh.py:55-153): JAX's cuts,
    bucket bits, layout rule, head width and slot bits. ``layout``:
    "dense" (full-width (tgt, win) rows), "two_tier" (61-slot packed
    heads + overflow rows) or "auto" (two-tier once buckets are deeper
    than 61 slots); two-tier needs slots that pack into int32 and more
    than one slot a feature, else the shards are dense.

    Each range's rows are the host rows the port stages under
    MC_DEVICE_LAYOUT=0 (``fused_rows`` / ``fused_rows_two_tier`` of the
    range) and its own bucket-row index at the shards' common bits.
    Positions of one device share one copy of their shard; the copies a
    device holds must fit its ``hbm_budget_bytes``, else MemoryError.
    ``grid``: (num_data, num_shards) devices (default: one row of the
    default device); ``lineages`` and ``merge_tax``: the runner's
    taxonomy arrays (default: none). Raises ValueError for u64 features
    (k > 16), where the JAX function fails."""
    f = part.unique_features
    if f.dtype == np.uint64:
        raise ValueError(U64_REFUSAL)
    if grid is None:
        from ..device import get_device
        grid = make_mesh(1, num_shards, [get_device()] * num_shards)
    grid = np.asarray(grid, dtype=object)
    if grid.ndim != 2 or grid.shape[1] != num_shards:
        raise ValueError(f"a grid of {grid.shape} devices for "
                         f"{num_shards} shards")
    if lineages is None:
        lineages = np.zeros((1, NUM_RANKS), np.int32)
    if merge_tax is None:
        merge_tax = np.zeros(1, np.int32)
    offs = part.offsets
    locs = part.locations
    nf = len(f)
    spf = min(part.max_bucket_size, maxloc) or 1
    maxtgt = int((locs >> np.uint64(32)).max()) if len(locs) else 0
    maxwin = int((locs & np.uint64(0xFFFFFFFF)).max()) if len(locs) else 0
    wbits = slot_pack_bits(maxwin, maxtgt)
    two_tier = bool(wbits) and spf > 1 and (
        layout == "two_tier" or (layout == "auto" and spf > 61))
    hsl = min(61, spf - 1) if two_tier else 0
    sbits = wbits if two_tier else 0
    cuts = [int(round(i * nf / num_shards)) for i in range(num_shards + 1)]
    fs = max(max(cuts[i + 1] - cuts[i] for i in range(num_shards)), 1)
    prefix_bits = min(24, max(12, int(fs).bit_length() - 2))
    feats, offsets, nbytes, seconds = [], [], [], []
    tables = np.empty(grid.shape, dtype=object)
    held = {}
    for p in range(num_shards):
        t0 = time.perf_counter()
        a, b = cuts[p], cuts[p + 1]
        sub = FeatureTable(f[a:b], offs[a:b + 1] - offs[a],
                           locs[offs[a]:offs[b]])
        if two_tier:
            rows, ovf = sub.fused_rows_two_tier(spf, hsl, slot_bits=sbits)
        else:
            rows, ovf = sub.fused_rows(spf), None
        brows, _ = make_bucket_index(sub.unique_features, prefix_bits)
        size = rows.nbytes + brows.nbytes + (0 if ovf is None else
                                              ovf.nbytes)
        feats.append(sub.unique_features)
        offsets.append(sub.offsets)
        nbytes.append(size)
        copies = {}
        for d in range(grid.shape[0]):
            dev = grid[d, p]
            if dev not in copies:
                held[dev] = held.get(dev, 0) + size
                if held[dev] > hbm_budget_bytes(dev):
                    raise MemoryError(
                        f"the shards on {dev} take {held[dev]} bytes, past "
                        f"its budget of {hbm_budget_bytes(dev)}; use more "
                        "devices or -parts")
                copies[dev] = tables_from_numpy(
                    sub.unique_features, sub.offsets, rows, brows,
                    prefix_bits, lineages, merge_tax, spf, sbits, dev,
                    ovf_rows=ovf, head_slots=hsl)
            tables[d, p] = copies[dev]
        del rows, ovf, brows
        for dev in copies:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        seconds.append(time.perf_counter() - t0)
    return ShardedRowTable(feats, offsets, tables, grid, nbytes, seconds,
                           spf, prefix_bits, sbits, hsl)


def _blocks(b: int, grid: np.ndarray):
    """-> (rows of a data group, rows of a position)."""
    nd, nt = grid.shape
    if b % (nd * nt):
        raise ValueError(f"{b} rows do not split over a {nd} x {nt} grid")
    return b // nd, b // (nd * nt)


def _sketch_gather(windows, valid, grid, k: int, sketchlen: int):
    """Position (d, p) sketches rows [d * b_loc + p * bsub, + bsub) of
    the (B, Wq, W) windows (B1, B2 above 128 characters), then the
    all_gather over "table" gives every position of group d the group's
    (b_loc, Wq * s) sketches in shard order (rows_mesh.py:184-204).
    -> [d][p] tensors on grid[d, p]."""
    nd, nt = grid.shape
    b, wq, w = windows.shape
    b_loc, bsub = _blocks(b, grid)
    feats = [[None] * nt for _ in range(nd)]
    for d in range(nd):
        for p in range(nt):
            dev = grid[d, p]
            lo = d * b_loc + p * bsub
            with on_device(dev):
                wm = windows[lo:lo + bsub].to(dev, non_blocking=True)
                vm = valid[lo:lo + bsub].to(dev, non_blocking=True)
                feats[d][p] = sketch_windows(
                    wm.reshape(bsub * wq, w), vm.reshape(bsub * wq), k,
                    sketchlen).reshape(bsub, wq * sketchlen)
    if nt == 1:
        return feats
    return [[_cat([feats[d][q] for q in range(nt)], grid[d, p], 0)
             for p in range(nt)] for d in range(nd)]


def _cat(parts, dev: torch.device, dim: int) -> torch.Tensor:
    """Blocks from several devices, copied to ``dev`` and concatenated."""
    with on_device(dev):
        return torch.cat([x.to(dev, non_blocking=True) for x in parts],
                         dim=dim)


def _exchange(x, grid, bsub: int):
    """all_to_all(split rows, concat columns) over "table": x[d][p] is
    (b_loc, L) on grid[d, p]; -> out[d][r] (bsub, P * L) on grid[d, r],
    row block r of every shard side by side in shard order
    (rows_mesh.py:211-216)."""
    nd, nt = grid.shape
    if nt == 1:
        return x
    return [[_cat([x[d][p][r * bsub:(r + 1) * bsub] for p in range(nt)],
                  grid[d, r], 1) for r in range(nt)] for d in range(nd)]


def presorted_runs(runs: int, f: int, nt: int) -> int:
    """The ``presorted`` of an exchanged row of ``nt`` shard blocks, each
    of ``f`` alternating asc/desc runs of ``runs`` lanes starting
    ascending: the runs alternate across block boundaries only where f
    is even (or there is one block), and must tile the padded row; else
    0 (the kernels sort the rows whole)."""
    if not runs or (nt > 1 and f % 2):
        return 0
    width = nt * f * runs
    return runs if padded_width(width) == width else 0


def _results(tgt, win, mwir, st, grid, bsub, args, flags, presorted):
    """rows_to_result at every position on its exchanged rows and its
    rows of ``mwir``; -> QueryResults in (data, table) block order,
    which is the rows' input order."""
    nd, nt = grid.shape
    out = []
    for d in range(nd):
        for r in range(nt):
            dev = grid[d, r]
            t = st.tables[d, r]
            lo = (d * nt + r) * bsub
            with on_device(dev):
                out.append(rows_to_result(
                    tgt[d][r], win[d][r],
                    mwir[lo:lo + bsub].to(dev, non_blocking=True),
                    t.merge_tax, t.lineages, *args, presorted_runs=presorted,
                    pack_bits=st.slot_bits, **flags))
    return out


def sharded_query_step_rows(windows, valid, mwir, st: ShardedRowTable,
                            hits_min, hits_diff_frac, highest_rank,
                            merge_rank, *, k: int, sketchlen: int,
                            max_candidates: int, walk_elems: int = 0,
                            dedup_walk: int = 0, fast_top2: bool = False,
                            fused_candidates: bool = True,
                            emit_hits: bool = False) -> list:
    """The sharded row step (rows_mesh.py:156-246) on ``st.grid``.

    windows (B, Wq, W) u8, valid (B, Wq), mwir (B,) on any device, B a
    multiple of the grid's positions. Each position sketches its 1/P of
    its group's rows, the sketches are gathered, each position probes
    its shard (dense rows: dense_decode; two-tier: B7) for
    the group's whole batch, the exchange trades slot columns for row
    blocks, and each position classifies its block. -> QueryResults of
    the (data, table) blocks in order (``merge_blocks`` joins them)."""
    grid = st.grid
    nd, nt = grid.shape
    f = windows.shape[1] * sketchlen
    _b_loc, bsub = _blocks(windows.shape[0], grid)
    fused, alt = route(fused_candidates, fast_top2, max_candidates,
                       walk_elems, dedup_walk, emit_hits, f,
                       st.slots_per_feature)
    full = _sketch_gather(windows, valid, grid, k, sketchlen)
    tgt = [[None] * nt for _ in range(nd)]
    win = [[None] * nt for _ in range(nd)]
    for d in range(nd):
        for p in range(nt):
            with on_device(grid[d, p]):
                tgt[d][p], win[d][p] = probe_rows(
                    full[d][p], st.tables[d, p], alt_runs=alt,
                    pack_bits=st.slot_bits)
    del full
    tgt = _exchange(tgt, grid, bsub)
    win = tgt if st.slot_bits else _exchange(win, grid, bsub)
    flags = dict(max_candidates=max_candidates, walk_elems=walk_elems,
                 dedup_walk=dedup_walk, fast_top2=fast_top2,
                 fused_candidates=fused, emit_hits=emit_hits)
    return _results(tgt, win, mwir, st, grid, bsub,
                    (hits_min, hits_diff_frac, highest_rank, merge_rank),
                    flags, presorted_runs(alt, f, nt))


def sharded_query_step_rows_head(windows, valid, mwir, st: ShardedRowTable,
                                 hits_min, hits_diff_frac, highest_rank,
                                 merge_rank, *, k: int, sketchlen: int,
                                 max_candidates: int, walk_elems: int = 0,
                                 dedup_walk: int = 0,
                                 fast_top2: bool = False,
                                 fused_candidates: bool = True):
    """Escalation phase 1 on two-tier shards (rows_mesh.py:249-319):
    every position probes only the head rows of its shard (B6), the
    exchange trades head slots for row blocks, and each read's per-shard
    ``over`` flags are OR-ed through the same exchange. -> (QueryResults
    of the blocks, their (bsub,) bool ``over`` flags): reads whose flag
    is clear are exact; flagged reads must be redone through
    ``sharded_query_step_rows``. On the fused route the heads emit runs
    of pow2(head_slots) lanes, as the single-device phase 1 does."""
    hsl = st.head_slots
    if not (st.slot_bits and hsl):
        raise ValueError("the head-only step needs slot-packed two-tier "
                         "shards")
    grid = st.grid
    nd, nt = grid.shape
    f = windows.shape[1] * sketchlen
    _b_loc, bsub = _blocks(windows.shape[0], grid)
    fused, _alt = route(fused_candidates, fast_top2, max_candidates,
                        walk_elems, dedup_walk, False, f,
                        st.slots_per_feature)
    rl = 1 << max(int(hsl - 1).bit_length(), 0) if fused else 0
    full = _sketch_gather(windows, valid, grid, k, sketchlen)
    pk = [[None] * nt for _ in range(nd)]
    over = [[None] * nt for _ in range(nd)]
    for d in range(nd):
        for p in range(nt):
            with on_device(grid[d, p]):
                pk[d][p], ov = probe_rows_head(
                    full[d][p], st.tables[d, p], alt_runs=rl,
                    pack_bits=st.slot_bits)
                over[d][p] = ov[:, None]
    del full
    pk = _exchange(pk, grid, bsub)
    over = [[o.any(dim=1) for o in row]
            for row in _exchange(over, grid, bsub)]
    flags = dict(max_candidates=max_candidates, walk_elems=walk_elems,
                 dedup_walk=dedup_walk, fast_top2=fast_top2,
                 fused_candidates=fused, emit_hits=False)
    blocks = _results(pk, pk, mwir, st, grid, bsub,
                      (hits_min, hits_diff_frac, highest_rank, merge_rank),
                      flags, presorted_runs(rl, f, nt))
    return blocks, [o for row in over for o in row]


def merge_blocks(blocks, device: torch.device) -> QueryResult:
    """JAX's _ShardedRows (runner.py:262-313): the blocks of a sharded
    step in (data, table) order hold the input's consecutive row blocks
    of one size, so the per-row fields concatenate in order on
    ``device``, and the per-hit lists' row ids move by each block's
    first row (their padding id becomes the row count)."""
    moved = [QueryResult(*(x.to(device, non_blocking=True) for x in r))
             for r in blocks]
    bsub = moved[0].cls_tax.shape[0]
    return concat_results(moved, bsub, bsub * len(moved))
