"""Query execution: stream reads, classify on the card, produce output.

Port of metacache_tpu/classify/runner.py (QueryRunner) for single-end
and paired-end reads (-pairfiles, -pairseq) against databases of u32
features (k <= 16) or u64 ones (k 17-32, int64 bit patterns) of one part
or many, with packed slots when they fit int32 and (tgt, win) lane pairs
when they do not (many targets, long genomes). Two paths, as in the JAX
package:

- summary only (``-no-map`` and no per-read analysis) on a single-part
  database: short reads are stacked K batches deep and classified by
  ``query_step_rows_scan`` (the native reader's 2-bit packed rows; pairs
  as two coded windows a query); a rank histogram computed on the card
  is the only thing fetched;
- per-read output, or a multi-part database: coded read batches are
  bucketed by window count (a pair's windows are mate 1's then mate
  2's) and classified by ``query_step_rows`` or, over every part,
  ``query_step_rows_multipart``, then formatted on the host.

Each step takes the fused candidate kernels where JAX's runner would
(``_fused_flags``, ``MC_FUSED_CANDIDATES``; long reads' wide rows
through their wide form), else the non-fused result path (taxon
merging, more than 4 candidates, -allhits, ranges longer than 48
windows).

The database stages on the card as the JAX runner stages it, part by
part within one budget: a database built in this process
(``build+query``) keeps the tables its build made there; a loaded one
uploads each part's CSR stream and fills the probe rows on the card
(ops/table_device.py::device_layout_from_csr); ``MC_DEVICE_LAYOUT=0``
fills host rows in numpy and copies them. Dense fused rows when they fit
the card's budget, else two-tier head and overflow rows or size-classed
cells; on a single part with packed slots the summary path then
classifies head-only and redoes at full depth only the reads that
touched a deeper bucket (escalation). A per-read batch bound for the
non-fused result path goes in launches that fit the device memory left
free (``_nonfused_rows``). -cov-percentile classifies every read again
on the host after the run, from the candidates of the targets that
keep their coverage; -align aligns each classified read to its top
candidate's windows, re-read from the target's FASTA, on the host.

Over a grid of devices (``devices``; parallel/mesh.py), as JAX's runner
over its mesh: ``-replicate`` stages the parts once a distinct device
and splits each row batch over the replicas, each running the
single-device step on its own tables; ``-table-shards`` cuts the one
part into feature-range shards (parallel/rows_mesh.py) and runs the
sharded step, escalated on two-tier shards of a summary-only run.
Either takes the row path for every batch (no scan loop), as JAX's
does. The JAX runner's TPU-link workarounds (packed result fetches,
fixed dispatch shapes) are not carried over.
"""
from __future__ import annotations

import collections
import itertools
import os
import queue
import threading
import time
from typing import Dict, List

import numpy as np
import torch

from .. import kernels, native
from ..config import SketchingOptions, max_windows_in_range
from ..db.database import Database
from ..native import decode_header as _decode_header
from ..ops import windows as win_ops
from ..seqio.reader import PairingMode, QueryRecord, read_queries
from ..taxonomy.model import NUM_RANKS, Rank, rank_from_name
from ..db.state import tables_csr, tables_from_device, tables_from_numpy
from ..device import Infeed, SideStream, free_bytes, hbm_budget_bytes
from ..ops.probe import make_bucket_index
from ..ops.pipeline import QueryResult, concat_results
from ..ops.rows import (fuses, fused_candidates_enabled, nonfused_sweep,
                        query_step_rows, query_step_rows_multipart,
                        query_step_rows_redo_scan, query_step_rows_scan,
                        query_step_rows_scan_head,
                        query_step_rows_scan_head_fused)
from ..ops.candidates import padded_width
from ..ops.table import csr_bytes, device_layout, unpack_locations
from ..parallel.mesh import default_devices, distinct, make_mesh, on_device
from ..parallel.rows_mesh import (merge_blocks, shard_row_table,
                                  sharded_query_step_rows,
                                  sharded_query_step_rows_head)
from ..ops.table_device import (debug_note, dense_bytes,
                                device_layout_from_csr)
from . import abundance as abd
from . import classification as cls_mod
from . import output as out_mod
from .options import ClassificationResults, QueryOptions
from .output import MapViewMode


# rank_hist's scratch (csrc/classify.cu): zeroed once and left zeroed
# by every launch (its last block puts the sums and the ticket back), so
# no launch needs a fill. Launches that can run at once never share one:
# outside a capture each (device, stream) keeps its own; a launch that a
# CUDA graph captures takes one that no other launch ever takes (kept as
# long as the process, so as long as the graph), since graphs captured
# on one stream may be replayed at once on several. Slots are zeroed
# _HIST_SLOTS at a time outside any capture, so a capture takes one
# zeroed before it began; where none is left, the capture's own slot is
# zeroed inside the graph.
_HIST_SLOTS = 64
_hist_lock = threading.Lock()
_hist_scratch = {}     # (device index, stream) -> scratch pointer
_hist_free = {}        # device index -> zeroed pointers not yet taken
_hist_held = []        # the scratch tensors


def _hist_take(dev: torch.device, capturing: bool) -> int:
    """A zeroed scratch not yet taken on ``dev``."""
    with _hist_lock:
        free = _hist_free.setdefault(dev.index, [])
        if not free:
            t = torch.zeros(
                (1 if capturing else _HIST_SLOTS,
                 kernels.rank_hist_scratch_bytes() // 4),
                dtype=torch.int32, device=dev)
            _hist_held.append(t)
            if capturing:
                return t.data_ptr()
            free.extend(row.data_ptr() for row in t)
        return free.pop()


def _hist_scratch_of(dev: torch.device) -> int:
    if torch._C._cuda_isCurrentStreamCapturing():
        return _hist_take(dev, True)
    key = (dev.index, torch._C._cuda_getCurrentRawStream(dev.index))
    ptr = _hist_scratch.get(key)
    if ptr is None:
        ptr = _hist_scratch[key] = _hist_take(dev, False)
    return ptr


def rank_histogram(cls: torch.Tensor, n: int, taxid_sorted: torch.Tensor,
                   rank_of: torch.Tensor,
                   over_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Summary rank histogram on the card: (NUM_RANKS + 1,) int64 counts
    of the first ``n`` classified taxa by rank (runner.py:106-128). Reads
    whose bit is set in ``over_bits`` (32 reads a word, escalation phase
    1) are left out: the redo counts them (runner.py:76-102). ``cls``:
    int32 taxa of any shape, read flat (a view in place, at any offset);
    ``taxid_sorted`` the ascending int32 taxon ids and ``rank_of`` their
    int32 ranks. CUDA tensors launch the rank_hist kernel
    (csrc/classify.cu), one launch that writes every bin; CPU tensors
    take ``rank_histogram_plain``."""
    ts = [cls, taxid_sorted, rank_of] + \
        ([] if over_bits is None else [over_bits])
    if any(t.dtype != torch.int32 for t in ts) or \
            len({t.device for t in ts}) != 1:
        raise ValueError("cls, taxid_sorted, rank_of and over_bits must be "
                         "int32 tensors on one device")
    m = cls.numel()
    nt = taxid_sorted.numel()
    if taxid_sorted.dim() != 1 or rank_of.shape != taxid_sorted.shape or \
            nt < 1 or (over_bits is not None and over_bits.numel() * 32 < m):
        raise ValueError(f"bad rank histogram tables: taxid_sorted "
                         f"{tuple(taxid_sorted.shape)}, rank_of "
                         f"{tuple(rank_of.shape)}, over_bits for {m} reads")
    if not cls.is_cuda:
        return rank_histogram_plain(cls, n, taxid_sorted, rank_of, over_bits)
    dev = cls.device
    out = torch.empty(NUM_RANKS + 2, dtype=torch.int64, device=dev)
    cls = cls.reshape(-1)
    if not cls.is_contiguous():
        cls = cls.contiguous()
    taxid_sorted, rank_of = taxid_sorted.contiguous(), rank_of.contiguous()
    if over_bits is not None:
        over_bits = over_bits.reshape(-1).contiguous()
    kernels.RANK_HIST(
        cls.data_ptr(), m, max(int(n), 0), taxid_sorted.data_ptr(), nt,
        rank_of.data_ptr(),
        None if over_bits is None else over_bits.data_ptr(), NUM_RANKS,
        out.data_ptr(), _hist_scratch_of(dev))
    return out[:NUM_RANKS + 1]


def rank_histogram_plain(cls: torch.Tensor, n: int,
                         taxid_sorted: torch.Tensor, rank_of: torch.Tensor,
                         over_bits: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """rank_histogram in torch ops (the plain version of rank_hist)."""
    cls = cls.reshape(-1)
    nt = taxid_sorted.shape[0]
    pos = torch.clamp(torch.searchsorted(taxid_sorted, cls), max=nt - 1)
    found = (taxid_sorted[pos] == cls) & (cls != 0)
    ranks = torch.where(found, rank_of[pos], NUM_RANKS)
    valid = torch.arange(cls.shape[0], device=cls.device) < n
    if over_bits is not None:
        sh = torch.arange(32, dtype=torch.int32, device=cls.device)
        over = ((over_bits.reshape(-1, 1) >> sh) & 1).reshape(-1) == 1
        valid &= ~over[:cls.shape[0]]
    ranks = torch.where(valid, ranks, NUM_RANKS + 1).to(torch.int64)
    return torch.bincount(ranks, minlength=NUM_RANKS + 2)[:NUM_RANKS + 1]


# copied from metacache_tpu/classify/runner.py:206-259
_DECODE_LUT = np.frombuffer(b"ACGTN" + b"N" * 251, dtype=np.uint8)


class _CodedQuery:
    """QueryRecord-compatible view over one row of a coded batch;
    headers/sequences decode lazily (only when output needs them)."""

    __slots__ = ("_codes", "_len", "_hdr", "_codes2", "_len2")

    def __init__(self, codes, length, hdr_raw, codes2=None, len2=0):
        self._codes = codes
        self._len = int(length)
        self._hdr = hdr_raw
        self._codes2 = codes2
        self._len2 = int(len2)

    @property
    def header(self) -> str:
        return _decode_header(self._hdr)

    @property
    def seq1(self) -> bytes:
        n = min(self._len, len(self._codes))
        return _DECODE_LUT[self._codes[:n]].tobytes()

    @property
    def seq2(self) -> bytes:
        if self._codes2 is None:
            return b""
        n = min(self._len2, len(self._codes2))
        return _DECODE_LUT[self._codes2[:n]].tobytes()


class _CodedBatch:
    """A coded read batch: raw header rows for the line formatter, and
    the codes, which -align reads back as sequences."""

    def __init__(self, codes, lens, headers, codes2=None, lens2=None):
        self.codes = codes
        self.lens = lens
        self.headers = headers
        self.codes2 = codes2
        self.lens2 = lens2

    def __len__(self):
        return len(self.lens)

    def __getitem__(self, i):
        if self.codes2 is None:
            return _CodedQuery(self.codes[i], self.lens[i],
                               self.headers[i])
        return _CodedQuery(self.codes[i], self.lens[i], self.headers[i],
                           self.codes2[i], self.lens2[i])


class _ShardedRowsEsc:
    """The sharded escalation's result (JAX's runner.py:315-356), for the
    summary path, which reads only ``cls_tax``: phase 1 (head only,
    across the shards) classified every read; the reads whose OR-ed
    ``over`` flag is set are redone through the full-depth sharded step,
    padded to the grid's row quantum, when ``cls_tax`` is first read.
    ``redo(rows, nreal)``: the full-depth step on those rows of the
    batch, of which ``nreal`` are real."""

    def __init__(self, res1: QueryResult, over: torch.Tensor, redo,
                 quantum: int):
        self._res1 = res1
        self._over = over
        self._redo = redo
        self._quantum = quantum
        self._cls = None

    @property
    def cls_tax(self) -> torch.Tensor:
        if self._cls is None:
            cls = self._res1.cls_tax.clone()
            idx = torch.nonzero(self._over).reshape(-1).cpu().numpy()
            if len(idx):
                q = self._quantum
                sel = np.resize(idx, -(-len(idx) // q) * q)
                redo = self._redo(torch.from_numpy(sel), len(idx))
                cls[torch.from_numpy(idx).to(cls.device)] = \
                    redo.cls_tax[:len(idx)]
            self._cls = cls
            self._redo = None
        return self._cls


def slot_pack_bits(target_count: int, max_window: int) -> int:
    """Window bits of the packed slot pk = (tgt << wbits) | win, or 0
    when slots stay unpacked (copied from
    metacache_tpu/classify/runner.py:632-646). wbits carries one bit
    more than the largest window, so the inter-target gap exceeds any
    clamped mwir; packing needs the largest pk below I32_MAX (the
    padding value). MC_PACK_SLOTS=0 turns packing off."""
    if os.environ.get("MC_PACK_SLOTS", "1") == "0" or target_count <= 0:
        return 0
    wbits = max(1, (2 * max_window).bit_length())
    pkmax = ((target_count - 1) << wbits) | max_window
    return wbits if pkmax < 2**31 - 1 else 0


def _max_window(p) -> int:
    """The largest target window of a part's locations."""
    return int((p.locations & np.uint64(0xFFFFFFFF)).max()) \
        if p.num_locations else 0


# device bytes a slot of a row's padded width (ops/candidates.py::
# padded_width) takes on the non-fused result path (ops/rows.py::
# rows_to_result: its row sorts, scans and taxon merge), by the branch's
# sweep (ops/rows.py::nonfused_sweep). Peaks allocated a padded slot on
# random rows of 1 to 256 windows, on an NVIDIA H100 80GB HBM3 at 700 W
# (tools/torch_nonfused_mem.py): walk 75.5-78.1, dedup 109.3-111.0, rank
# join 141-183 (reserved up to 208); launches sized at these figures ran
# beside a ballast leaving 1, 2 or 4 GiB free, where 96 and 128 a dedup
# slot and 192 a rank-join slot ran out of memory. The walk's figure
# also covers a 65,536-read batch of 16 x 503 slots a row over a two-part
# 944 Mbp database, which peaked at 84 bytes a slot (chip_smoke.py,
# run_multipart)
NONFUSED_BYTES_A_SLOT = 96
DEDUP_BYTES_A_SLOT = 160
RANK_JOIN_BYTES_A_SLOT = 256
# -allhits adds a launch's per-hit lists (QueryResult.hit_qid, hit_tgt,
# hit_win: an int32 each a slot), which go to the host as it ends
HIT_LIST_BYTES_A_SLOT = 12


def nonfused_row_bytes(slots: int, sweep: str, emit_hits: bool) -> int:
    """Device bytes a row of ``slots`` match slots takes on the non-fused
    result path under ``sweep`` (ops/rows.py::nonfused_sweep), with its
    per-hit lists where ``emit_hits``."""
    a_slot = {"dedup": DEDUP_BYTES_A_SLOT,
              "rank-join": RANK_JOIN_BYTES_A_SLOT}.get(
                  sweep, NONFUSED_BYTES_A_SLOT)
    return padded_width(max(slots, 1)) * (
        a_slot + (HIT_LIST_BYTES_A_SLOT if emit_hits else 0))


class QueryRunner:
    """Holds the device-resident database state across query runs."""

    # copied from metacache_tpu/classify/runner.py:700-701 and :722
    MAX_WALK_ELEMS = 64
    MAX_DEDUP_WALK = 48
    FUSED_MIN_SLOTS = 1024

    def __init__(self, db: Database, opt: QueryOptions,
                 device: torch.device | None = None, devices=None):
        self.db = db
        self.opt = opt
        grid = self._choose_grid(db, opt, device, devices)
        self.device = grid[0, 0]
        self._nrep, self._ntab = grid.shape
        self.sketching = self._adapt_sketching()
        self.hits_min = opt.classify.resolve_hits_min(
            db.sketching.sketchlen)
        self._line_writer = None

        # copied from metacache_tpu/classify/runner.py:375-395
        db.taxa.update()
        lin64 = db.taxa.target_lineages_array()  # (num_targets, R) int64
        self.lineages = np.clip(
            lin64, -2**31 + 1, 2**31 - 1).astype(np.int32)
        lowest = rank_from_name(opt.classify.lowest_rank)
        self.merge_rank = int(lowest)
        merge_tax = np.zeros(max(db.target_count, 1), dtype=np.int32)
        for r in range(self.merge_rank, NUM_RANKS):
            fill = (merge_tax == 0) & (self.lineages[:, r] != 0) \
                if db.target_count else np.zeros(1, bool)
            merge_tax[fill] = self.lineages[:, r][fill]
        self.merge_tax = merge_tax
        self.highest_rank = int(rank_from_name(opt.classify.highest_rank))
        self._fast_top2 = (
            self.merge_rank == 0 and opt.classify.max_candidates <= 4
            and db.target_count > 0 and bool(np.all(merge_tax != 0)))
        self._fused_candidates = fused_candidates_enabled()

        # staging (runner.py:481-595, 632-646): packed pk slots when they
        # fit int32 (one pack_bits from the largest window of all parts),
        # else (tgt, win) lane pairs (layout tag True); every part takes
        # its layout from what the parts before it left of the budget
        self.budget_bytes = hbm_budget_bytes(self.device)
        lineages = self.lineages if db.target_count else \
            np.zeros((1, NUM_RANKS), np.int32)
        self.stage_seconds = []     # a part's staging split, _staged
        self._shards = None
        on = {}         # a device -> its staged parts: (tables, dense, staged)
        if self._ntab > 1:
            # feature-range shards over the grid's "table" axis
            # (runner.py:458-473)
            t0 = time.perf_counter()
            self._pack_bits = 0
            self._shards = shard_row_table(
                db.parts[0], self._ntab, db.max_locations_per_feature,
                layout=os.environ.get("MC_SHARD_LAYOUT", "auto"), grid=grid,
                lineages=lineages, merge_tax=merge_tax)
            self.stage_seconds.append({
                "layout": self.layout, "shards": self._shards.shard_seconds,
                "seconds": time.perf_counter() - t0})
        elif db.device_parts:
            # tables built on the card by this process (build+query)
            dtab = db.device_parts[0]
            self._pack_bits = slot_pack_bits(db.target_count, dtab.max_win)
            on[self.device] = [self._take(dtab, lineages, merge_tax)]
        else:
            # replicas (-replicate) stage once a distinct device, each
            # within its own budget
            self._pack_bits = slot_pack_bits(
                db.target_count, max(_max_window(p) for p in db.parts))
            for dev in distinct(grid):
                staged, left = [], hbm_budget_bytes(dev)
                with on_device(dev):
                    for p in db.parts:
                        staged.append(self._stage_part(
                            p, lineages, merge_tax, left, dev))
                        left -= staged[-1][2]
                on[dev] = staged
        staged = on.get(self.device, [])
        self.parts = [t for t, _d, _s in staged]
        # the single-part paths' tables; none under table shards
        self.tables = self.parts[0] if self.parts else None
        self._replicas = [(dev, [t for t, _d, _s in on[dev]])
                          for dev in grid[:, 0]] if on else []
        self.dense_bytes = sum(d for _t, d, _s in staged)
        self.staged_bytes = sum(self._shards.shard_bytes) if self._shards \
            else sum(s for _t, _d, s in staged)
        self.esc_reads = 0          # reads escalated to the full-depth redo
        # the full-depth redo's dispatches: (route, batches, reads a batch,
        # real reads) with route "feats" (phase 1's saved sketches and
        # bucket probes), "fused" (inside phase 1's dispatch) or "rows"
        # (the reads' rows through the full-depth scan, MC_PREFETCH=0)
        self.redo_dispatches: list = []
        self.row_launches = 0       # launches of the per-read row steps
        # the summary path's pipeline on the runner's device: a side
        # stream for prefetched stages and fused redo batches, and the
        # pinned infeed of the scan stacks, a buffer for each dispatch in
        # flight and one being filled
        self._side = SideStream(self.device)
        self._infeed = Infeed(self.device, self.DEPTH + 1)

        # copied from metacache_tpu/classify/runner.py:655-676
        ids, ranks = [], []
        for t in db.taxa.taxonomy.taxa.values():
            ids.append(t.id)
            ranks.append(int(t.rank))
        for t in db.taxa.taxonomy.targets.values():
            ids.append(t.id)
            ranks.append(int(t.rank))
        order = np.argsort(ids) if ids else np.zeros(0, np.int64)
        self._taxid_sorted = np.asarray(ids, np.int64)[order] \
            if ids else np.zeros(0, np.int64)
        self._rank_of_taxid = np.asarray(ranks, np.uint8)[order] \
            if ids else np.zeros(0, np.uint8)
        self._hist_dev = None
        if len(self._taxid_sorted) and \
                int(np.abs(self._taxid_sorted).max()) < 2**31:
            self._hist_dev = (
                torch.from_numpy(self._taxid_sorted.astype(np.int32))
                .to(self.device),
                torch.from_numpy(self._rank_of_taxid.astype(np.int32))
                .to(self.device))

    @staticmethod
    def _choose_grid(db: Database, opt: QueryOptions, device, devices):
        """The (data, table) grid of devices, by JAX's rules
        (runner.py:397-436): ``-replicate`` n <= 0 takes every device,
        n is capped at the device count and rounded down to a power of
        two; table shards when ``-table-shards`` n > 1, replicas x shards
        fit the devices and the database has one part; else replicas
        when n > 1; else one device. ``devices`` (default: ``device``,
        else every CUDA device, or the CPU under MC_TORCH_DEVICE=cpu)
        may repeat a device. A database built in this process
        (``build+query``) takes no grid (runner.py:489-493)."""
        devs = list(devices) if devices is not None else \
            [device] if device is not None else default_devices()
        ndev = len(devs)
        nrep = opt.num_replicas
        if nrep <= 0:
            nrep = ndev
        nrep = min(nrep, ndev)
        while nrep & (nrep - 1):
            nrep -= 1
        ntab = opt.table_shards
        if ntab > 1 and nrep * ntab <= ndev and len(db.parts) == 1:
            grid = make_mesh(nrep, ntab, devs)
        elif nrep > 1:
            grid = make_mesh(nrep, 1, devs)
        else:
            grid = make_mesh(1, 1, devs)
        if grid.size > 1 and db.device_parts:
            raise RuntimeError(
                "device-resident build does not support -replicate/"
                "-table-shards yet; use a saved database")
        return grid

    def _take(self, dtab, lineages, merge_tax):
        """Probe through a DeviceTable (ops/table_device.py).
        -> (tables, dense bytes, staged bytes)."""
        return (tables_from_device(dtab, lineages, merge_tax),
                dense_bytes(dtab.nf, dtab.spf, dtab.slot_bits,
                            wide=dtab.uniq.dtype == torch.int64),
                dtab.layout_bytes)

    def _stage_part(self, p, lineages, merge_tax, budget: int,
                    device: torch.device | None = None):
        """Stage a loaded part within ``budget`` bytes, as JAX's runner
        stages it (runner.py:505-596): its CSR stream filled into probe
        rows on the card (MC_DEVICE_LAYOUT=1, the default); where the
        builder raises MemoryError (no layout fits; for u64 features also
        unpackable slots or a low-32 collision of the bucket index that
        widening does not part), or under MC_DEVICE_LAYOUT=0, host rows
        by the host rule (``device_layout``), which takes the CSR layout
        where no row layout fits and raises MemoryError where even CSR
        does not. u64 features (k > 16) never stage as host rows: they
        take the CSR layout there, without a budget check, as in JAX.
        MC_DENSE_LIMIT caps only the dense option of u32 features.
        Records the staging's seconds (``_staged``). ``device``: where
        to stage (default: the runner's device).
        -> (tables, dense bytes, staged bytes)."""
        device = device or self.device
        t0 = time.perf_counter()
        spf = min(p.max_bucket_size, self.db.max_locations_per_feature) or 1
        wide = p.unique_features.dtype == np.uint64
        try:
            dense_cap = int(os.environ.get("MC_DENSE_LIMIT", 0)) or None
        except ValueError:
            dense_cap = None
        allow_dense = wide or dense_cap is None or \
            p.dense_rows_bytes(spf) <= dense_cap
        unpacked = None
        unpack_s = 0.0
        if os.environ.get("MC_DEVICE_LAYOUT", "1") != "0" and p.num_features:
            unpacked = unpack_locations(p.locations)
            unpack_s = time.perf_counter() - t0
            t_card = time.perf_counter()
            try:
                staged = self._take(device_layout_from_csr(
                    p.unique_features, p.offsets, *unpacked,
                    device=device,
                    cap=self.db.max_locations_per_feature or 254,
                    budget_bytes=budget, allow_dense=allow_dense),
                    lineages, merge_tax)
                return self._staged(staged, t0, t_card, unpack_s, device)
            except MemoryError:
                pass             # the host rule, then CSR (runner.py:564)
        index = None if wide else make_bucket_index(p.unique_features)
        if wide:
            hsl, staged_b = 0, csr_bytes(p)
            dense_b = dense_bytes(p.num_features, spf, 1, wide=True)
        else:
            hsl, dense_b, staged_b = device_layout(
                p, spf, self._pack_bits, budget, allow_dense=allow_dense,
                index_bytes=index[0].nbytes)
        if hsl == 0:
            if unpacked is None:
                h0 = time.perf_counter()
                unpacked = unpack_locations(p.locations)
                unpack_s += time.perf_counter() - h0
            t_card = time.perf_counter()
            tables = tables_csr(p.unique_features, p.offsets, *unpacked,
                                lineages, merge_tax, spf, device,
                                index=index)
            return self._staged((tables, dense_b, staged_b), t0, t_card,
                                unpack_s, device)
        if hsl == spf:
            rows = p.fused_rows(spf, slot_bits=self._pack_bits)
            ovf, hsl = None, 0
        else:
            rows, ovf = p.fused_rows_two_tier(spf, hsl,
                                              slot_bits=self._pack_bits)
        brows, bits = index
        t_card = time.perf_counter()
        return self._staged((tables_from_numpy(
            p.unique_features, p.offsets, rows, brows, bits, lineages,
            merge_tax, spf, self._pack_bits, device, ovf_rows=ovf,
            head_slots=hsl), dense_b, staged_b), t0, t_card, unpack_s,
            device)

    def _staged(self, staged, t0: float, t_card: float, unpack_s: float,
                device: torch.device):
        """Record a staged part's seconds (``stage_seconds``): on the
        host before the call that puts the part on the device (from
        ``t0`` to ``t_card``; ``unpack_s`` of them the host's
        unpack_locations), and in that call, waited for (the card's
        fill from the CSR, or the copy of the host's rows or CSR); then
        pass the part on."""
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        card_s = time.perf_counter() - t_card
        self.stage_seconds.append({"layout": str(staged[0].dense),
                                   "unpack_s": unpack_s,
                                   "host_s": t_card - t0, "card_s": card_s})
        debug_note(f"staged part {len(self.stage_seconds)}: layout "
                   f"{staged[0].dense}, {staged[2] / 2**30:.3f} GiB, host "
                   f"{t_card - t0:.3f} s (unpack {unpack_s:.3f} s), card "
                   f"{card_s:.3f} s")
        return staged

    @property
    def layout(self) -> str:
        """Probe layout tag of each staged part, comma-separated (e.g.
        "pk15", "('two_tier', 61, True, False, 15)" or "('classed', 61,
        False, False, 15)"); table shards: "shards<P>:" and their tag."""
        if self._shards is not None:
            return f"shards{self._ntab}:{self._shards.tables[0, 0].dense}"
        return ", ".join(str(t.dense) for t in self.parts)

    # copied from metacache_tpu/classify/runner.py:703-717
    def _sweep_params(self, mwir, wq: int) -> dict:
        """Lane-walk over raw slots when the per-range slot bound is
        small, dedup + walk over distinct entries when only max(mwir) is
        small (long reads); longer ranges need the rank join."""
        if len(mwir) == 0:
            return {}
        m = int(np.max(mwir))
        e = m * self.sketching.sketchlen * wq
        if e <= self.MAX_WALK_ELEMS:
            return {"walk_elems": e}
        if m <= self.MAX_DEDUP_WALK:
            return {"dedup_walk": m}
        return {}

    # copied from metacache_tpu/classify/runner.py:724-733, without the
    # TPU crossover FUSED_MIN_SLOTS, which the fused kernels beat on the
    # card at every width (chip_smoke.py's fused-crossover phase)
    def _fused_flags(self) -> dict:
        """The fused candidate kernels and no per-hit lists, unless
        -allhits asks for them; rows_to_result fuses only where the
        sweep is a walk and fast_top2 is on."""
        if self.opt.output.analysis.show_all_hits:
            return {"emit_hits": True, "fused_candidates": False}
        return {"emit_hits": False,
                "fused_candidates": self._fused_candidates}

    # copied from metacache_tpu/classify/runner.py:743-754
    def _adapt_sketching(self) -> SketchingOptions:
        """Reference: adapt_options_to_database (src/querying.cpp:225-266)."""
        dbs = self.db.sketching
        qs = self.opt.sketching
        if qs is None:
            return dbs
        kmerlen = dbs.kmerlen
        sketchlen = qs.sketchlen if qs.sketchlen >= 1 else dbs.sketchlen
        winlen = qs.winlen if qs.winlen >= 1 else dbs.winlen
        winstride = qs.winstride if qs.winstride >= 1 else \
            winlen - kmerlen + 1
        return SketchingOptions(kmerlen, sketchlen, winlen, winstride)

    # copied from metacache_tpu/classify/runner.py:2035-2044
    def _summary_only(self):
        """True when per-query host work can be skipped entirely."""
        o = self.opt.output
        return (o.format.map_view_mode == MapViewMode.NONE and
                not o.evaluate.precision and
                not o.evaluate.determine_ground_truth and
                not o.analysis.show_hits_per_target and
                not o.analysis.show_tax_abundances and
                o.analysis.abundance_per == Rank.NONE and
                self.opt.classify.cov_percentile <= 0)

    # ------------------------------------------------------------------
    # copied from metacache_tpu/classify/runner.py:757-792
    def run_queries(self, queries, results: ClassificationResults):
        """Classify an iterable of QueryRecord into `results`; one batch
        stays in flight while the host prepares the next."""
        batch: List[QueryRecord] = []
        nwin_total = 0
        pending = None
        opt = self.opt
        for q in queries:
            ln = len(q.seq1) + len(q.seq2)
            if ln < opt.min_read_length:
                continue
            if opt.max_read_length and ln > opt.max_read_length:
                continue
            nw = (win_ops.num_windows(len(q.seq1), self.sketching) +
                  win_ops.num_windows(len(q.seq2), self.sketching))
            batch.append(q)
            nwin_total += max(nw, 1)
            if nwin_total >= opt.batch_windows:
                dispatched = ("rows", self._dispatch_batch_rows(batch))
                if pending is not None:
                    self._collect_batch(*pending, results)
                pending = (batch, dispatched)
                batch, nwin_total = [], 0
        if batch:
            dispatched = ("rows", self._dispatch_batch_rows(batch))
            if pending is not None:
                self._collect_batch(*pending, results)
            pending = (batch, dispatched)
        if pending is not None:
            self._collect_batch(*pending, results)

    # ------------------------------------------------------------------
    def run_file_native(self, path: str,
                        results: ClassificationResults) -> bool:
        """Single-end ingestion through the native C++ reader; returns
        False when it cannot serve the file (the caller then streams
        QueryRecords). Reader set-up and batch sizes copied from
        metacache_tpu/classify/runner.py:805-836 and :866-879."""
        if native.get_lib() is None or self.opt.query_limit >= 0:
            return False
        scan = native.scan_file(path)
        if scan is None or scan[0] == 0:
            return False
        max_len = max(1024, scan[1])
        if max_len > (1 << 20):
            return False
        try:
            reader = native.NativeFastxReader(path, max_len=max_len)
        except (FileNotFoundError, RuntimeError):
            return False
        opt = self.opt
        batch_reads = max(opt.batch_windows, 1024)
        if max_len > 1024:
            batch_reads = max(256, min(batch_reads,
                                       (128 << 20) // max_len))
        summary = self._summary_only()
        if not summary and max_len <= 1024:
            batch_reads = max(batch_reads, 65536)
        # the summary scan stages one part on one device (runner.py:838-839):
        # a multi-part summary, or one over a grid of devices, takes the
        # row path and accumulates there
        summary = summary and len(self.parts) == 1 and \
            self._row_quantum == 1
        extra = []
        try:
            if summary:
                bsz = batch_reads if self.device.type == "cpu" else \
                    max(batch_reads, 8192)
                # stack no deeper than the file needs: the last stack is
                # padded to full depth, so a small file would otherwise
                # classify scan_k * bsz rows
                scan_k = max(1, min(int(os.environ.get("MC_SCAN_K", "32")),
                                    -(-scan[0] // bsz)))
                nthr = max(1, int(getattr(opt, "num_threads", 1) or 1))
                if nthr > 1 and not path.endswith(".gz"):
                    try:
                        fsz = os.path.getsize(path)
                        cuts = [fsz * i // nthr for i in range(nthr + 1)]
                        rngs = [native.NativeFastxReader(
                            path, max_len=max_len,
                            start=cuts[i], end=cuts[i + 1])
                            for i in range(nthr)]
                        reader.close()
                        reader, extra = rngs[0], rngs[1:]
                    except (ValueError, RuntimeError, OSError):
                        extra = []
                self._run_scan_native_packed(reader, bsz, scan_k, results,
                                             extra_readers=extra)
                return True
            pending = None
            while True:
                codes, lens, headers = reader.read_batch_raw(batch_reads)
                if len(lens) == 0:
                    break
                # length filter (reference: database_query.hpp:271-281)
                if opt.min_read_length > 0 or opt.max_read_length:
                    keep = lens >= opt.min_read_length
                    if opt.max_read_length:
                        keep &= lens <= opt.max_read_length
                    codes, lens, headers = codes[keep], lens[keep], \
                        headers[keep]
                    if len(lens) == 0:
                        continue
                dispatched = self._dispatch_coded(codes, lens, headers)
                if pending is not None:
                    self._collect_batch(*pending, results)
                pending = dispatched
            if pending is not None:
                self._collect_batch(*pending, results)
            return True
        finally:
            reader.close()
            for rd_ in extra:
                rd_.close()

    # copied from metacache_tpu/classify/runner.py:957-1125
    def _run_scan_native_packed(self, reader, batch_reads: int,
                                scan_k: int, results, extra_readers=None):
        """Summary fast path fed by the native packed reader: clean short
        reads arrive 2-bit packed and are stacked scan_k batches deep
        (straight into the pinned infeed); long/ambiguous reads ride the
        coded per-read path. The remainder pads to a full stack whose
        payload carries the real read count. On two-tier tables with
        packed slots the stacks classify head-only and the flagged reads
        are redone at full depth: on phase 1's sketches and bucket probes
        where the scan prefetches, inside a later phase 1's dispatch
        (MC_ESC_FUSED) once half a slice of MC_ESC_B2 reads a batch has
        gathered, else (MC_PREFETCH=0) their rows through the full-depth
        scan."""
        opt = self.opt
        wl = self.sketching.winlen
        pending: collections.deque = collections.deque()
        take = scan_k * batch_reads
        esc = self._escalation_ok() and self._hist_dev is not None
        prefetch = self._prefetch()
        # JAX's fused escalation (runner.py:977-985); the port runs the
        # redo slice on the side stream beside phase 1
        esc_fused = (esc and prefetch and
                     os.environ.get("MC_ESC_FUSED", "1") == "1")
        try:
            esc_b2 = int(os.environ.get("MC_ESC_B2", str(batch_reads // 2)))
        except ValueError:
            esc_b2 = batch_reads // 2
        self._esc_redo = []      # (feats, idx, lens) or (rows, lens) chunks
        self._esc_nredo = 0

        def flush(dispatched):
            self._flush(pending, dispatched, results)

        def scan_dispatch(stack, n):
            la = np.zeros(take, np.int32)
            np.concatenate([l for _, l in stack], out=la[:n])
            # crop rows to the stack's max read length (4-byte quantum)
            q = min(-(-int(la.max(initial=0)) // 16) * 4,
                    stack[0][0].shape[1]) if n else 4
            rows = [c[:, :max(q, 4)] for c, _ in stack]
            if not esc:
                return (None, ("scan", (n, self._dispatch_scan(
                    rows, la, scan_k, batch_reads))))
            if esc_fused and self._esc_nredo >= (scan_k * esc_b2) // 2:
                rf, ri, rlens, got = self._carve_redo(scan_k * esc_b2)
                self.redo_dispatches.append(("fused", scan_k, esc_b2, got))
                return (None, ("scanesc2", (n, la, got,
                                            *self._dispatch_scan_head_fused(
                                                rows, la, scan_k,
                                                batch_reads, rf, ri, rlens,
                                                esc_b2))))
            cls, over, fk, ik = self._dispatch_scan_head(rows, la, scan_k,
                                                         batch_reads)
            if prefetch:
                return (None, ("scanesc", (n, la, cls, over, fk, ik, None)))
            # the row redo (runner.py:1035-1052) re-sends the rows
            return (None, ("scanesc", (n, la, cls, over, None, None, rows)))

        buf: list = []
        nbuf = 0
        # producer thread(s): the C parser releases the GIL, so parsing
        # overlaps device work
        readers = [reader] + list(extra_readers or [])
        chunks: queue.Queue = queue.Queue(maxsize=2 + 2 * len(readers))
        done = threading.Lock()
        live = [len(readers)]
        stop = threading.Event()

        def _produce(rd):
            try:
                while not stop.is_set():
                    item = rd.read_batch_packed(4 * batch_reads, wl)
                    if item[5] == 0:
                        break
                    chunks.put(item)
            finally:
                with done:
                    live[0] -= 1
                    if live[0] == 0:
                        chunks.put(None)

        ths = [threading.Thread(target=_produce, args=(rd,), daemon=True)
               for rd in readers]
        for th in ths:
            th.start()
        # the caller closes the readers: on an error here the producers
        # stop reading first, so that none reads a closed reader
        try:
            while True:
                item = chunks.get()
                if item is None:
                    break
                packed, plens, scodes, slens, sheaders, _ = item
                if opt.min_read_length > 0 or opt.max_read_length:
                    keep = plens >= opt.min_read_length
                    if opt.max_read_length:
                        keep &= plens <= opt.max_read_length
                    packed, plens = packed[keep], plens[keep]
                    skeep = slens >= opt.min_read_length
                    if opt.max_read_length:
                        skeep &= slens <= opt.max_read_length
                    scodes, slens = scodes[skeep], slens[skeep]
                    sheaders = sheaders[skeep]
                if len(slens):
                    flush(self._dispatch_coded(scodes, slens, sheaders))
                if len(plens):
                    buf.append((packed, plens))
                    nbuf += len(plens)
                while nbuf >= take:
                    stack, buf = _split_rows(buf, take)
                    flush(scan_dispatch(stack, take))
                    nbuf -= take
                    self._flush_redo(pending, scan_k, batch_reads, results)
            if nbuf:
                flush(scan_dispatch(buf, nbuf))
            self._drain(pending, scan_k, batch_reads, results)
        finally:
            stop.set()
            while any(th.is_alive() for th in ths):
                try:
                    chunks.get(timeout=0.05)
                except queue.Empty:
                    pass

    DEPTH = 3   # scan dispatches in flight

    def _flush(self, pending: collections.deque, dispatched, results):
        """Queue a dispatch, collecting the oldest while DEPTH are in
        flight."""
        while len(pending) >= self.DEPTH:
            self._collect_batch(*pending.popleft(), results)
        pending.append(dispatched)

    def _flush_redo(self, pending, scan_k: int, bsz: int, results,
                    final: bool = False):
        """Full-depth phase 2 for the reads that touched a bucket deeper
        than the head, a stack at a time (with ``final``, also the last
        partial one): on phase 1's sketches and bucket probes, or, where
        phase 1 kept none (MC_PREFETCH=0), their rows through the
        full-depth scan (runner.py:1024-1052); unlike the JAX runner's
        fixed-shape stacks, a redo stack is only as deep as its reads
        need."""
        while self._esc_nredo >= scan_k * bsz or (final and self._esc_nredo):
            k2 = min(scan_k, -(-self._esc_nredo // bsz))
            if len(self._esc_redo[0]) == 2:
                chunks, self._esc_redo = _split_rows(self._esc_redo, k2 * bsz)
                got = sum(len(l) for _, l in chunks)
                la = np.zeros(k2 * bsz, np.int32)
                np.concatenate([l for _, l in chunks], out=la[:got])
                self._esc_nredo -= got
                route = "rows"
                out = self._dispatch_scan([r for r, _ in chunks], la, k2,
                                          bsz)
            else:
                rf, ri, rlens, got = self._carve_redo(k2 * bsz)
                route = "feats"
                out = self._dispatch_redo(rf, ri, rlens, k2, bsz)
            self.redo_dispatches.append((route, k2, bsz, got))
            self._flush(pending, (None, ("scan", (got, out))), results)

    def _drain(self, pending, scan_k: int, bsz: int, results):
        """Collect every dispatch in flight, then the redo of the reads
        they flagged."""
        while pending:
            self._collect_batch(*pending.popleft(), results)
        self._flush_redo(pending, scan_k, bsz, results, final=True)
        while pending:
            self._collect_batch(*pending.popleft(), results)

    def _scan_inputs(self, rows, lens, scan_k: int, bsz: int, *extra):
        """Stacked 2-bit packed rows -> (windows, valid, mwir, *extra) of
        the scan steps on the device, and mwir on the host
        (runner.py:1910-1921). ``rows``: blocks of packed rows, in order,
        each cropped or zero-filled to the widest; stacked straight into
        the infeed's next pinned buffer, with ``extra`` host arrays for
        the same copy; rows past them (a short stack) are empty reads.
        ``lens``: the stack's read lengths, 0 past the real ones."""
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        n, q = scan_k * bsz, max(r.shape[1] for r in rows)
        mwir_max = 2 + max(wl, opt.classify.insert_size_max) // stride
        vdt = np.uint8 if wl < 256 else np.int32
        mdt = np.uint8 if mwir_max < 256 else np.int32
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(mdt)
        w, v, m, *more = self._infeed.stage(
            ((n, q), np.uint8), ((n,), vdt), ((n,), mdt),
            *((a.shape, a.dtype) for a in extra))
        _fill_rows(w, rows)
        np.copyto(v, np.where(lens >= sk.kmerlen, lens, 0), casting="unsafe")
        m[:] = mwir
        for x, a in zip(more, extra):
            x[...] = a
        wmat, vmat, mw, *more = self._infeed.send()
        return (wmat.reshape(scan_k, bsz, 1, q), vmat.reshape(scan_k, bsz, 1),
                mw.reshape(scan_k, bsz), *more), mwir

    def _dispatch_scan(self, rows, lens, scan_k: int, bsz: int):
        """One scan over scan_k stacked short-read batches of 2-bit packed
        rows (``_scan_inputs``); -> (scan_k, bsz) classified taxa on the
        device (adapted from metacache_tpu/classify/runner.py:1895-1932)."""
        sk = self.sketching
        opt = self.opt
        dev, mwir = self._scan_inputs(rows, lens, scan_k, bsz)
        return query_step_rows_scan(
            *dev, self.tables, self.hits_min,
            opt.classify.hits_diff_fraction, self.highest_rank,
            self.merge_rank, k=sk.kmerlen, sketchlen=sk.sketchlen,
            windows_per_query=1, max_candidates=opt.classify.max_candidates,
            pack_bits=self._pack_bits, infeed_packed=True,
            fast_top2=self._fast_top2,
            fused_candidates=self._fused_candidates,
            prefetch=self._prefetch(), side=self._side,
            **self._sweep_params(mwir.astype(np.int32), 1))

    # copied from metacache_tpu/classify/runner.py:1659-1669
    def _prefetch(self) -> bool:
        """The software-pipelined scan (ops/rows.py: batch i+1's sketch
        and bucket probe on the side stream beside batch i's probe rows
        and candidates): for row layouts, whose bucket-row index finds the
        rows ahead, not the CSR layout; the same results.
        MC_PREFETCH=0 disables."""
        return os.environ.get("MC_PREFETCH", "1") != "0" and \
            not self.tables.csr

    # copied from metacache_tpu/classify/runner.py:1671-1693
    def _escalation_ok(self, wq: int = 1) -> bool:
        """Escalation (head-only phase 1 + full-depth redo) is valid for
        slot-packed two-tier and classed single-part layouts on the fused
        fast path; it pays off when buckets can exceed the head. ``wq``:
        windows a query (2 for pairs, whose ranges span both mates).
        MC_ESCALATE=0 disables."""
        t = self.tables
        # u64 two-tier rows are not escalated (runner.py:1689 admits
        # "two_tier" and "classed" only): they take the full-depth scan
        if os.environ.get("MC_ESCALATE", "1") == "0" or \
                len(self.parts) != 1 or not self._fast_top2 or \
                not self._fused_candidates or not self._pack_bits or t.wide:
            return False
        sk = self.sketching
        stride = self.db.sketching.winstride
        m = 2 + max(wq * sk.winlen,
                    self.opt.classify.insert_size_max) // stride
        sweep_ok = (m * sk.sketchlen * wq <= self.MAX_WALK_ELEMS or
                    m <= self.MAX_DEDUP_WALK)
        return (t.head_slots > 0 and t.slot_bits == self._pack_bits and
                t.spf > t.head_slots and sweep_ok and
                wq * sk.sketchlen * t.spf >= self.FUSED_MIN_SLOTS)

    # copied from metacache_tpu/classify/runner.py:1695-1731
    def _dispatch_scan_head(self, rows, lens, scan_k: int, bsz: int):
        """Escalation phase 1 (head-only probe) over prepacked rows
        (``_scan_inputs``); -> (cls (K, B), over_bits (K, B/32), feats
        (K, B, F), idx (K, B, F)) device tensors."""
        sk = self.sketching
        opt = self.opt
        dev, mwir = self._scan_inputs(rows, lens, scan_k, bsz)
        return query_step_rows_scan_head(
            *dev, self.tables, self.hits_min,
            opt.classify.hits_diff_fraction, self.highest_rank,
            self.merge_rank, k=sk.kmerlen, sketchlen=sk.sketchlen,
            max_candidates=opt.classify.max_candidates,
            walk_elems=int(mwir.max()) * sk.sketchlen, fast_top2=True,
            fused_candidates=self._fused_candidates,
            pack_bits=self._pack_bits, infeed_packed=True,
            prefetch=self._prefetch(), side=self._side)

    # copied from metacache_tpu/classify/runner.py:1808-1851
    def _dispatch_scan_head_fused(self, rows, lens, scan_k: int, bsz: int,
                                  rfeats, ridx, rlens, b2: int):
        """One dispatch of phase 1 on fresh reads and phase 2 on a slice
        of b2 earlier flagged reads a batch
        (query_step_rows_scan_head_fused: the slice on the side stream,
        beside phase 1); -> (cls1, over_bits, feats, idx, cls2 (K, b2))
        device tensors."""
        sk = self.sketching
        opt = self.opt
        stride = self.db.sketching.winstride
        rmwir = (2 + np.maximum(rlens, opt.classify.insert_size_max)
                 // stride).astype(np.int32).reshape(scan_k, b2)
        (*dev, rm), mwir = self._scan_inputs(rows, lens, scan_k, bsz, rmwir)
        F = sk.sketchlen
        return query_step_rows_scan_head_fused(
            *dev, rfeats.reshape(scan_k, b2, F), ridx.reshape(scan_k, b2, F),
            rm, self.tables, self.hits_min, opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank, k=sk.kmerlen, sketchlen=F,
            max_candidates=opt.classify.max_candidates,
            walk_elems=int(max(mwir.max(), rmwir.max(initial=2))) * F,
            fast_top2=True, fused_candidates=self._fused_candidates,
            pack_bits=self._pack_bits, infeed_packed=True, side=self._side)

    # copied from metacache_tpu/classify/runner.py:1733-1764
    def _carve_redo(self, need: int):
        """Take `need` flagged rows (feats, idx, lens) from the redo
        buffer, padding with sentinel features when short.
        -> (feats (need, F) dev, idx (need, F) dev, lens (need,) np,
            real_count)."""
        fparts, iparts, lparts = [], [], []
        got = 0
        left = []
        for f_, i_, l_ in self._esc_redo:
            use = min(len(l_), need - got)
            if use:
                fparts.append(f_[:use])
                iparts.append(i_[:use])
                lparts.append(l_[:use])
                got += use
            if use < len(l_):
                left.append((f_[use:], i_[use:], l_[use:]))
        self._esc_redo = left
        self._esc_nredo -= got
        pad = need - got
        F = fparts[0].shape[1] if fparts else self.sketching.sketchlen
        if pad:
            fdt = torch.int64 if self.sketching.kmerlen > 16 else torch.int32
            fparts.append(torch.full((pad, F), -1, dtype=fdt,
                                     device=self.device))
            iparts.append(torch.zeros((pad, F), dtype=torch.int32,
                                      device=self.device))
            lparts.append(np.zeros(pad, np.int32))
        return (torch.cat(fparts), torch.cat(iparts),
                np.concatenate(lparts), got)

    # copied from metacache_tpu/classify/runner.py:1853-1880
    def _dispatch_redo(self, feats, idx, lens, scan_k: int, bsz: int):
        """Escalation phase 2 over phase 1's device-resident sketches
        (query_step_rows_redo_scan): full-depth probe + candidates with
        no re-sketch and no bucket-row gather."""
        sk = self.sketching
        opt = self.opt
        stride = self.db.sketching.winstride
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(np.int32)
        F = feats.shape[-1]
        wq = max(F // sk.sketchlen, 1)
        (mwir_dev,) = self._infeed.put(mwir.reshape(scan_k, bsz))
        return query_step_rows_redo_scan(
            feats.reshape(scan_k, bsz, F), idx.reshape(scan_k, bsz, F),
            mwir_dev, self.tables,
            self.hits_min, opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank,
            max_candidates=opt.classify.max_candidates, fast_top2=True,
            fused_candidates=self._fused_candidates,
            pack_bits=self._pack_bits, **self._sweep_params(mwir, wq))

    # ------------------------------------------------------------------
    # paired-end reads: each pair classifies from mate 1's windows then
    # mate 2's (reference: sequence_pair_reader, src/sequence_io.cpp:
    # 246-450, consumed with stride 2 by query_database,
    # src/database_query.hpp:256-284)

    # copied from metacache_tpu/classify/runner.py:1127-1153
    def run_pair_files_native(self, path1: str, path2: str,
                              results: ClassificationResults) -> bool:
        """-pairfiles through two native readers advancing in lockstep;
        returns False (the caller then streams QueryRecords) when the
        reader cannot serve the files or they disagree on record
        count."""
        if native.get_lib() is None or self.opt.query_limit >= 0:
            return False
        s1, s2 = native.scan_file(path1), native.scan_file(path2)
        if s1 is None or s2 is None or s1[0] == 0 or s1[0] != s2[0]:
            return False
        max_len = max(1024, s1[1], s2[1])
        readers = self._open_readers((path1, path2), max_len)
        if readers is None:
            return False
        r1, r2 = readers

        def batches(n):
            while True:
                c1, l1, h1 = r1.read_batch_raw(n)
                c2, l2, _h2 = r2.read_batch_raw(n)
                m = min(len(l1), len(l2))
                if m == 0:
                    return
                yield c1[:m], l1[:m], c2[:m], l2[:m], h1[:m]
        try:
            self._run_pairs(batches, s1[0], max_len, results)
        finally:
            r1.close()
            r2.close()
        return True

    # copied from metacache_tpu/classify/runner.py:1324-1398
    def run_pair_seq_native(self, path: str,
                            results: ClassificationResults) -> bool:
        """-pairseq through the native reader: records 2i and 2i+1 form a
        pair; an odd final record is a pair whose mate 2 is empty (the
        reference's sequence_pair_reader, src/sequence_io.cpp:345-383)."""
        if native.get_lib() is None or self.opt.query_limit >= 0:
            return False
        scan = native.scan_file(path)
        if scan is None or scan[0] == 0:
            return False
        max_len = max(1024, scan[1])
        readers = self._open_readers((path,), max_len)
        if readers is None:
            return False
        reader = readers[0]

        def batches(n):
            carry = None        # odd leftover record of the last batch
            while True:
                codes, lens, headers = reader.read_batch_raw(2 * n)
                if len(lens) == 0:
                    if carry is not None:
                        c1 = carry[0][None]
                        yield (c1, np.asarray([carry[1]], np.int32),
                               np.zeros_like(c1), np.zeros(1, np.int32),
                               carry[2][None])
                    return
                if carry is not None:
                    codes = np.concatenate([carry[0][None], codes])
                    lens = np.concatenate(
                        [np.asarray([carry[1]], lens.dtype), lens])
                    headers = np.concatenate([carry[2][None], headers])
                    carry = None
                if len(lens) % 2:
                    carry = (codes[-1].copy(), lens[-1], headers[-1].copy())
                    codes, lens, headers = codes[:-1], lens[:-1], \
                        headers[:-1]
                    if len(lens) == 0:
                        continue
                yield (codes[0::2], lens[0::2], codes[1::2], lens[1::2],
                       headers[0::2])
        try:
            self._run_pairs(batches, -(-scan[0] // 2), max_len, results)
        finally:
            reader.close()
        return True

    @staticmethod
    def _open_readers(paths, max_len: int):
        """Native readers of ``paths``, or None (any opened closed again)
        when one cannot be opened or reads pass 1 Mbp."""
        if max_len > (1 << 20):
            return None
        readers = []
        try:
            for p in paths:
                readers.append(native.NativeFastxReader(p, max_len=max_len))
        except (FileNotFoundError, RuntimeError):
            for rd in readers:
                rd.close()
            return None
        return readers

    # copied from metacache_tpu/classify/runner.py:1154-1279, with the
    # port's stacks (runner.py:383-389 here) and a remainder stack only as
    # deep as its pairs need
    def _run_pairs(self, batches, npairs: int, max_len: int, results):
        """Classify ``batches(n)``, a generator of (codes1, lens1,
        codes2, lens2, headers1) batches of n pairs. Summary queries on
        one part stack short pairs (both mates <= winlen) scan_k batches
        deep through the scan step with two windows a query, escalating
        where ``_escalation_ok(wq=2)`` holds; longer pairs, per-read
        output and multi-part databases go through
        ``_dispatch_coded_pair``. The length filter applies to a pair's
        combined length."""
        opt = self.opt
        wl = self.sketching.winlen
        batch_reads = max(opt.batch_windows // 2, 1024)
        if max_len > 1024:
            batch_reads = max(256, min(batch_reads, (64 << 20) // max_len))

        def filtered(n):
            for batch in batches(n):
                # reference: database_query.hpp:271-281
                if opt.min_read_length > 0 or opt.max_read_length:
                    ln = batch[1].astype(np.int64) + batch[3]
                    keep = ln >= opt.min_read_length
                    if opt.max_read_length:
                        keep &= ln <= opt.max_read_length
                    batch = tuple(x[keep] for x in batch)
                if len(batch[1]):
                    yield batch

        if not (self._summary_only() and len(self.parts) == 1
                and self._row_quantum == 1):
            pending = None
            for batch in filtered(batch_reads):
                dispatched = self._dispatch_coded_pair(*batch)
                if pending is not None:
                    self._collect_batch(*pending, results)
                pending = dispatched
            if pending is not None:
                self._collect_batch(*pending, results)
            return

        bsz = batch_reads if self.device.type == "cpu" else \
            max(batch_reads, 8192)
        scan_k = max(1, min(int(os.environ.get("MC_SCAN_K", "32")),
                            -(-npairs // bsz)))
        take = scan_k * bsz
        # the paired redo reuses phase 1's sketches and bucket probes,
        # which only the prefetched scan keeps (runner.py:1172-1177):
        # under MC_PREFETCH=0 pairs do not escalate
        esc = self._escalation_ok(wq=2) and self._hist_dev is not None \
            and self._prefetch()
        self._esc_redo = []
        self._esc_nredo = 0
        pending: collections.deque = collections.deque()

        def dispatch(chunks, n):
            # a remainder stack is only as deep as its pairs need
            k = -(-n // bsz)
            l1, l2 = np.zeros(k * bsz, np.int32), np.zeros(k * bsz, np.int32)
            np.concatenate([c[1] for c in chunks], out=l1[:n])
            np.concatenate([c[3] for c in chunks], out=l2[:n])
            if esc:
                lsum = (l1.astype(np.int64) + l2).astype(np.int32)
                return (None, ("scanesc", (n, lsum, *self._dispatch_scan_pair(
                    chunks, l1, l2, k, bsz, head=True), None)))
            return (None, ("scan", (n, self._dispatch_scan_pair(
                chunks, l1, l2, k, bsz))))

        buf: list = []
        nbuf = 0
        for c1, l1, c2, l2, h1 in filtered(bsz):
            short = (l1 <= wl) & (l2 <= wl)
            if not short.all():
                self._flush(pending, self._dispatch_coded_pair(
                    *(x[~short] for x in (c1, l1, c2, l2, h1))), results)
            if short.any():
                buf.append(tuple(np.ascontiguousarray(x[short])
                                 for x in (c1[:, :wl], l1, c2[:, :wl], l2)))
                nbuf += int(short.sum())
            while nbuf >= take:
                chunks, buf = _split_rows(buf, take)
                self._flush(pending, dispatch(chunks, take), results)
                nbuf -= take
                self._flush_redo(pending, scan_k, bsz, results)
        if nbuf:
            # the remainder, padded to whole batches with empty pairs
            self._flush(pending, dispatch(buf, nbuf), results)
        self._drain(pending, scan_k, bsz, results)

    # copied from metacache_tpu/classify/runner.py:1281-1322 and
    # :1766-1806
    def _dispatch_scan_pair(self, chunks, l1, l2, scan_k: int, bsz: int,
                            head: bool = False):
        """One scan over scan_k stacked batches of short pairs, two coded
        windows a query, stacked from ``chunks`` of (codes1, lens1,
        codes2, lens2) straight into the infeed's next pinned buffer, then
        empty pairs (``l1``, ``l2``: the stack's mate lengths, 0 past the
        real ones); -> (scan_k, bsz) classified taxa on the device, or
        with ``head`` escalation phase 1's (cls, over_bits, feats
        (K, B, 2s), idx). Phase 1 on pairs takes the runner's sweep for
        two windows, where single reads take the walk alone
        (runner.py:1725 against :1802)."""
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        n = scan_k * bsz
        mwir = (2 + np.maximum(l1.astype(np.int64) + l2,
                               opt.classify.insert_size_max) // stride)
        w, v, m = self._infeed.stage(((n, 2, wl), np.uint8),
                                     ((n, 2), np.int32), ((n,), np.int32))
        _fill_rows(w[:, 0], [c[0] for c in chunks])
        _fill_rows(w[:, 1], [c[2] for c in chunks])
        v[:, 0] = np.where(l1 >= sk.kmerlen, l1, 0)
        v[:, 1] = np.where(l2 >= sk.kmerlen, l2, 0)
        m[:] = mwir
        wmat, vmat, mw = self._infeed.send()
        args = (wmat.reshape(scan_k, bsz, 2, wl), vmat.reshape(scan_k, bsz, 2),
                mw.reshape(scan_k, bsz), self.tables, self.hits_min,
                opt.classify.hits_diff_fraction, self.highest_rank,
                self.merge_rank)
        kw = dict(k=sk.kmerlen, sketchlen=sk.sketchlen,
                  max_candidates=opt.classify.max_candidates,
                  pack_bits=self._pack_bits,
                  fused_candidates=self._fused_candidates,
                  prefetch=self._prefetch(), side=self._side,
                  **self._sweep_params(mwir.astype(np.int32), 2))
        if head:
            return query_step_rows_scan_head(*args, fast_top2=True, **kw)
        return query_step_rows_scan(*args, windows_per_query=2,
                                    fast_top2=self._fast_top2, **kw)

    # copied from metacache_tpu/classify/runner.py:1400-1454
    def _dispatch_coded_pair(self, c1, l1, c2, l2, headers):
        """Dispatch a coded paired batch: short pairs (both mates <=
        winlen) as one row of two windows, longer ones bucketed by mate-1
        plus mate-2 windows; the batch keeps mate 1's headers."""
        sk = self.sketching
        opt = self.opt
        k = opt.classify.max_candidates
        wl = sk.winlen
        stride = self.db.sketching.winstride

        def mwir_of(a, b):
            return 2 + np.maximum(a.astype(np.int64) + b,
                                  opt.classify.insert_size_max) // stride

        short = (l1 <= wl) & (l2 <= wl)
        launched = []
        if short.any():
            idxs = np.nonzero(short)[0]
            rows = self._rows_for(len(idxs))
            wmat = np.full((rows, 2, wl), win_ops.PAD_CODE, np.uint8)
            wmat[:len(idxs), 0, :] = c1[idxs, :wl]
            wmat[:len(idxs), 1, :] = c2[idxs, :wl]
            vmat = np.zeros((rows, 2), np.int32)
            vmat[:len(idxs), 0] = np.where(l1[idxs] >= sk.kmerlen,
                                           l1[idxs], 0)
            vmat[:len(idxs), 1] = np.where(l2[idxs] >= sk.kmerlen,
                                           l2[idxs], 0)
            mwir = np.full(rows, 2, np.int32)
            mwir[:len(idxs)] = mwir_of(l1[idxs], l2[idxs])
            launched.append((idxs.tolist(), rows,
                             self._launch_rows(wmat, vmat, mwir, 2, k)))
        if (~short).any():
            lbuckets: Dict[int, list] = {}
            for i in np.nonzero(~short)[0].tolist():
                nw = (win_ops.num_windows(int(l1[i]), sk) +
                      win_ops.num_windows(int(l2[i]), sk))
                lbuckets.setdefault(_bucket_wq(nw), []).append(i)
            for wq, idxs in sorted(lbuckets.items()):
                rows = self._rows_for(len(idxs))
                wmat = np.full((rows, wq, wl), win_ops.PAD_CODE, np.uint8)
                vmat = np.zeros((rows, wq), np.int32)
                mwir = np.full(rows, 2, np.int32)
                for r, i in enumerate(idxs):
                    w1, v1 = win_ops.sequence_windows(c1[i, :l1[i]], sk)
                    w2, v2 = win_ops.sequence_windows(c2[i, :l2[i]], sk)
                    w = np.concatenate([w1, w2])
                    wmat[r, :len(w)] = w
                    vmat[r, :len(w)] = np.concatenate([v1, v2])
                mwir[:len(idxs)] = mwir_of(l1[idxs], l2[idxs])
                launched.append((idxs, rows,
                                 self._launch_rows(wmat, vmat, mwir,
                                                   wq, k)))
        return (_CodedBatch(c1, l1, headers, c2, l2), ("rows", launched))

    # copied from metacache_tpu/classify/runner.py:1456-1508
    def _dispatch_coded(self, codes, lens, headers):
        """Dispatch a coded (B, max_len) read batch, short reads as one
        window, long reads bucketed by padded window count."""
        sk = self.sketching
        opt = self.opt
        k = opt.classify.max_candidates
        wl = sk.winlen
        stride = self.db.sketching.winstride

        short = lens <= wl
        launched = []
        if short.any():
            idxs = np.nonzero(short)[0]
            rows = self._rows_for(len(idxs))
            wmat = np.full((rows, 1, wl), win_ops.PAD_CODE, np.uint8)
            wmat[:len(idxs), 0, :] = codes[idxs, :wl]
            vmat = np.zeros((rows, 1), np.int32)
            vmat[:len(idxs), 0] = np.where(lens[idxs] >= sk.kmerlen,
                                           lens[idxs], 0)
            mwir = np.full(rows, 2, np.int32)
            mwir[:len(idxs)] = 2 + np.maximum(
                lens[idxs], opt.classify.insert_size_max) // stride
            launched.append((idxs.tolist(), rows,
                             self._launch_rows(wmat, vmat, mwir, 1, k)))
        if (~short).any():
            lbuckets: Dict[int, list] = {}
            for i in np.nonzero(~short)[0]:
                nw = win_ops.num_windows(int(lens[i]), sk)
                lbuckets.setdefault(_bucket_wq(nw), []).append(int(i))
            for wq, idxs in sorted(lbuckets.items()):
                rows = self._rows_for(len(idxs))
                wmat = np.full((rows, wq, wl), win_ops.PAD_CODE, np.uint8)
                vmat = np.zeros((rows, wq), np.int32)
                mwir = np.full(rows, 2, np.int32)
                for r, i in enumerate(idxs):
                    w, v = win_ops.sequence_windows(codes[i, :lens[i]], sk)
                    wmat[r, :len(w)] = w
                    vmat[r, :len(v)] = v
                    mwir[r] = 2 + max(
                        int(lens[i]),
                        opt.classify.insert_size_max) // stride
                launched.append((idxs, rows,
                                 self._launch_rows(wmat, vmat, mwir,
                                                   wq, k)))
        return (_CodedBatch(codes, lens, headers), ("rows", launched))

    def _step_flags(self, mwir, wq: int, k: int) -> dict:
        return dict(max_candidates=k, fast_top2=self._fast_top2,
                    **self._fused_flags(), **self._sweep_params(mwir, wq))

    def _nonfused_rows(self, slots: int, flags: dict,
                       device: torch.device | None = None) -> int:
        """The most rows of ``slots`` match slots a launch of the
        non-fused result path takes in the memory free now on ``device``
        (default: the runner's; the fused kernels work in shared memory
        and take a batch whole), by the sweep and the per-hit lists
        (-allhits) that ``flags`` (``_step_flags``) give it
        (``nonfused_row_bytes``). Raises MemoryError when not even one row
        fits."""
        free = free_bytes(device or self.device)
        row_b = nonfused_row_bytes(
            slots, nonfused_sweep(flags.get("walk_elems", 0),
                                  flags.get("dedup_walk", 0), slots),
            flags["emit_hits"])
        r = free // row_b
        if r < 1:
            raise MemoryError(
                f"a row of {slots} match slots needs {row_b} bytes on the "
                f"non-fused result path; {free} bytes are free beside the "
                "tables")
        return int(r)

    @property
    def _row_quantum(self) -> int:
        """Batch row counts must split evenly over the grid
        (runner.py:679-681)."""
        return self._nrep * self._ntab

    def _rows_for(self, n: int) -> int:
        """Rows of a launch of ``n`` reads: a power of two, and a
        multiple of the grid's positions."""
        q = self._row_quantum
        return -(-max(_round_up_pow2(n), q) // q) * q

    # copied from metacache_tpu/classify/runner.py:1510-1588
    def _launch_rows(self, wmat, vmat, mwir, wq, k):
        """One row batch through ``query_step_rows``, or over every part
        through ``query_step_rows_multipart``, split evenly over the
        replicas (-replicate), each on its device's staged tables, or
        through the sharded step over the table shards (-table-shards).
        A batch bound for the non-fused result path goes in launches of
        as many rows as the free device memory holds
        (``_nonfused_rows``), whose results concatenate in row order; the
        flags come from the whole batch, so every launch takes the same
        route and sweep. Where a batch takes several launches, each
        launch's per-hit lists (-allhits) go to the host as it ends, so
        they hold no device memory the launches after it were sized to
        take."""
        flags = self._step_flags(mwir, wq, k)
        if self._shards is not None:
            return self._launch_sharded(wmat, vmat, mwir, wq, flags)
        per = len(mwir) // len(self._replicas)
        out = []
        for r, (dev, parts) in enumerate(self._replicas):
            rows = slice(r * per, (r + 1) * per)
            with on_device(dev):
                out.append(self._launch_parts(
                    dev, parts, wmat[rows], vmat[rows], mwir[rows], wq,
                    flags))
        if len(out) == 1:
            return out[0]
        # the per-row fields join on the runner's device; where a
        # replica's launches sent its per-hit lists to the host
        # (_launches), every replica's go there, so that none lands in
        # the device memory those launches were sized to leave free
        hits_at = torch.device("cpu") if any(
            r.hit_qid.device.type == "cpu" for r in out) else self.device
        return concat_results([QueryResult(
            *(x.to(self.device, non_blocking=True) for x in r[:6]),
            *(x.to(hits_at, non_blocking=hits_at.type != "cpu")
              for x in r[6:])) for r in out], per, len(mwir))

    def _nonfused_launch(self, n: int, slots: int, flags: dict,
                         device: torch.device, share: float = 1.0,
                         quantum: int = 1) -> int:
        """Rows a launch takes of a batch of ``n``: all of them on the
        fused route, else what ``_nonfused_rows`` lets ``device`` hold,
        of which it works ``share``, rounded down to ``quantum``."""
        if fuses(flags["fused_candidates"], flags["fast_top2"],
                 flags["max_candidates"], flags.get("walk_elems", 0),
                 flags.get("dedup_walk", 0), flags["emit_hits"]):
            return n
        r = int(self._nonfused_rows(slots, flags, device) / share)
        return min(n, max(r // quantum, 1) * quantum)

    def _launches(self, n: int, per_launch: int, flags: dict, launch):
        """``launch(rows)`` for slices of ``per_launch`` rows of ``n``,
        joined in row order."""
        results = []
        for i in range(0, n, per_launch):
            res = launch(slice(i, i + per_launch))
            if per_launch < n and flags["emit_hits"]:
                res = res._replace(hit_qid=res.hit_qid.cpu(),
                                   hit_tgt=res.hit_tgt.cpu(),
                                   hit_win=res.hit_win.cpu())
            results.append(res)
        self.row_launches += len(results)
        return results[0] if len(results) == 1 else \
            concat_results(results, per_launch, n)

    def _launch_parts(self, dev, parts, wmat, vmat, mwir, wq, flags):
        """A replica's rows through its parts' tables on ``dev``."""
        sk = self.sketching
        step, tables = (query_step_rows, parts[0]) if len(parts) == 1 \
            else (query_step_rows_multipart, parts)
        n = len(mwir)
        per_launch = self._nonfused_launch(
            n, wq * sk.sketchlen * sum(t.spf for t in parts), flags, dev)

        def to_dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return self._launches(n, per_launch, flags, lambda rows: step(
            to_dev(wmat[rows]), to_dev(vmat[rows]), to_dev(mwir[rows]),
            tables, self.hits_min, self.opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank, k=sk.kmerlen,
            sketchlen=sk.sketchlen, windows_per_query=wq,
            pack_bits=self._pack_bits, **flags))

    def _launch_sharded(self, wmat, vmat, mwir, wq, flags):
        """A row batch through the table shards (runner.py:1518-1551):
        escalated where JAX escalates (slot-packed two-tier shards whose
        head is shallower than their depth, one window a query, a
        summary-only run, MC_ESCALATE not 0) -- the head-only step, then
        the full-depth step on the flagged reads (``_ShardedRowsEsc``) --
        else the full-depth step, in launches that fit the busiest
        device's free memory where the batch takes the non-fused route.
        -> a QueryResult on the runner's device (``merge_blocks``)."""
        st = self._shards
        sk = self.sketching
        args = (self.hits_min, self.opt.classify.hits_diff_fraction,
                self.highest_rank, self.merge_rank)
        kw = dict(k=sk.kmerlen, sketchlen=sk.sketchlen, **flags)
        w, v, m = (torch.from_numpy(np.ascontiguousarray(x))
                   for x in (wmat, vmat, mwir))
        if (st.slot_bits and 0 < st.head_slots < st.slots_per_feature
                and wq == 1 and self._summary_only()
                and os.environ.get("MC_ESCALATE", "1") != "0"):
            kw.pop("emit_hits")
            blocks, over = sharded_query_step_rows_head(w, v, m, st, *args,
                                                        **kw)
            self.row_launches += 1

            def redo(rows, nreal):
                self.esc_reads += nreal
                self.row_launches += 1
                return merge_blocks(sharded_query_step_rows(
                    w[rows], v[rows], m[rows], st, *args, **kw),
                    self.device)
            return _ShardedRowsEsc(
                merge_blocks(blocks, self.device),
                torch.cat([o.to(self.device) for o in over]), redo,
                self._row_quantum)
        grid = st.grid
        busiest = max(distinct(grid), key=lambda d: int((grid == d).sum()))
        n = len(mwir)
        per_launch = self._nonfused_launch(
            n, wq * sk.sketchlen * st.slots_per_feature * self._ntab, flags,
            busiest, share=(grid == busiest).sum() / grid.size,
            quantum=self._row_quantum)
        return self._launches(n, per_launch, flags, lambda rows: merge_blocks(
            sharded_query_step_rows(w[rows], v[rows], m[rows], st, *args,
                                    **kw), self.device))

    def _collect_batch(self, batch, dispatched, results):
        kind, payload = dispatched
        if kind == "scanesc2":
            # the fused escalation dispatch (runner.py:1603-1616): count
            # the redone slice, whose first ``got`` reads are real, then
            # phase 1 as below
            n, la, got, cls_dev, over_dev, fk, ik, cls2 = payload
            if got:
                hist = rank_histogram(cls2, got, *self._hist_dev)
                results.statistics.assigned_ += \
                    hist.cpu().numpy().astype(np.int64)
                results.query_count += got
            kind, payload = "scanesc", (n, la, cls_dev, over_dev, fk, ik,
                                        None)
        if kind == "scanesc":
            # escalation phase 1 (runner.py:1617-1644): count the reads
            # the head classified exactly, queue the flagged ones for the
            # full-depth redo, with their sketches and bucket probes, or
            # their packed rows where phase 1 kept none (``rows``)
            n, la, cls_dev, over_dev, fk, ik, rows = payload
            hist = rank_histogram(cls_dev, n, *self._hist_dev,
                                  over_bits=over_dev)
            bits = over_dev.cpu().numpy().reshape(-1)
            mask = (((bits[:, None] >> np.arange(32)) & 1)
                    .astype(bool).reshape(-1))
            mask[n:] = False
            idxs = np.nonzero(mask)[0]
            if len(idxs) and rows is not None:
                self._esc_redo.append((np.concatenate(rows)[idxs],
                                       la[idxs]))
            elif len(idxs):
                F = fk.shape[-1]
                (sel,) = self._infeed.put(idxs)
                self._esc_redo.append((fk.reshape(-1, F)[sel],
                                       ik.reshape(-1, F)[sel], la[idxs]))
            if len(idxs):
                self._esc_nredo += len(idxs)
                self.esc_reads += len(idxs)
            results.statistics.assigned_ += \
                hist.cpu().numpy().astype(np.int64)
            results.query_count += n - len(idxs)
            return
        if kind == "scan":
            n, cls_dev = payload
            if self._hist_dev is not None:
                hist = rank_histogram(cls_dev, n, *self._hist_dev)
                results.statistics.assigned_ += \
                    hist.cpu().numpy().astype(np.int64)
                results.query_count += n
            else:
                self._accumulate_summary(
                    cls_dev.reshape(-1)[:n].cpu().numpy(), results)
            return
        self._collect_batch_rows(batch, payload, results)

    # copied from metacache_tpu/classify/runner.py:1973-1983
    def _accumulate_summary(self, cls: np.ndarray, results):
        """Vectorized per-rank statistics from classified taxon ids."""
        pos = np.searchsorted(self._taxid_sorted, cls)
        pos = np.minimum(pos, max(len(self._taxid_sorted) - 1, 0))
        found = (len(self._taxid_sorted) > 0) & \
            (self._taxid_sorted[pos] == cls) & (cls != 0)
        ranks = np.where(found, self._rank_of_taxid[pos],
                         np.uint8(int(Rank.NONE)))
        results.statistics.assigned_ += np.bincount(
            ranks, minlength=NUM_RANKS + 1).astype(np.int64)
        results.query_count += len(cls)

    # copied from metacache_tpu/classify/runner.py:1985-2033
    def _query_windows(self, q: QueryRecord):
        """All windows of one query (seq1 then seq2)."""
        sk = self.sketching
        w1, v1 = win_ops.sequence_windows(
            win_ops.encode_ascii(q.seq1), sk)
        if q.seq2:
            w2, v2 = win_ops.sequence_windows(
                win_ops.encode_ascii(q.seq2), sk)
            if len(w1) and len(w2):
                return np.concatenate([w1, w2]), np.concatenate([v1, v2])
            if len(w2):
                return w2, v2
        return w1, v1

    def _mwir(self, q: QueryRecord) -> int:
        return max_windows_in_range(
            len(q.seq1) + len(q.seq2),
            self.opt.classify.insert_size_max, self.db.sketching.winstride)

    def _dispatch_batch_rows(self, batch):
        sk = self.sketching
        k = self.opt.classify.max_candidates
        buckets: Dict[int, list] = {}
        wins_of = []
        for i, q in enumerate(batch):
            w, v = self._query_windows(q)
            wins_of.append((w, v))
            buckets.setdefault(_bucket_wq(len(w)), []).append(i)
        launched = []
        for wq, idxs in sorted(buckets.items()):
            rows = self._rows_for(len(idxs))
            wmat = np.full((rows, wq, sk.winlen), win_ops.PAD_CODE,
                           np.uint8)
            vmat = np.zeros((rows, wq), np.int32)
            mwir = np.full(rows, 2, np.int32)
            for r, i in enumerate(idxs):
                w, v = wins_of[i]
                wmat[r, :len(w)] = w
                vmat[r, :len(v)] = v
                mwir[r] = self._mwir(batch[i])
            launched.append((idxs, rows,
                             self._launch_rows(wmat, vmat, mwir, wq, k)))
        return launched

    # copied from metacache_tpu/classify/runner.py:2046-2121, without the
    # slim and micro fetches of the TPU link
    def _collect_batch_rows(self, batch, launched, results):
        if self._summary_only():
            for (idxs, _rows, res) in launched:
                self._accumulate_summary(
                    res.cls_tax[:len(idxs)].cpu().numpy(), results)
            return
        k = self.opt.classify.max_candidates
        n = len(batch)
        cand_tgt = np.full((n, k), -1, np.int32)
        cand_tax = np.zeros((n, k), np.int32)
        cand_hits = np.zeros((n, k), np.int32)
        cand_beg = np.zeros((n, k), np.int32)
        cand_end = np.zeros((n, k), np.int32)
        cls_tax = np.zeros(n, np.int32)
        allhits_of: Dict[int, tuple] = {}
        need_allhits = self.opt.output.analysis.show_all_hits
        for (idxs, rows, res) in launched:
            sel = np.asarray(idxs)
            m = len(idxs)
            # one device-to-host copy per launch
            packed = torch.cat([res.cand_tgt, res.cand_tax, res.cand_hits,
                                res.cand_beg, res.cand_end,
                                res.cls_tax[:, None]], dim=1)[:m]
            packed = packed.cpu().numpy()
            kk = res.cand_tgt.shape[1]
            cand_tgt[sel, :kk] = packed[:, 0 * kk:1 * kk]
            cand_tax[sel, :kk] = packed[:, 1 * kk:2 * kk]
            cand_hits[sel, :kk] = packed[:, 2 * kk:3 * kk]
            cand_beg[sel, :kk] = packed[:, 3 * kk:4 * kk]
            cand_end[sel, :kk] = packed[:, 4 * kk:5 * kk]
            cls_tax[sel] = packed[:, 5 * kk]
            if need_allhits:
                hq = res.hit_qid.cpu().numpy()
                ht = res.hit_tgt.cpu().numpy()
                hw = res.hit_win.cpu().numpy()
                order = np.argsort(hq, kind="stable")
                hq, ht, hw = hq[order], ht[order], hw[order]
                bounds = np.searchsorted(hq, np.arange(rows + 1))
                for r, i in enumerate(idxs):
                    lo, hi = bounds[r], bounds[r + 1]
                    allhits_of[i] = (ht[lo:hi], hw[lo:hi])
        self._postprocess_arrays(batch, cand_tgt, cand_tax, cand_hits,
                                 cand_beg, cand_end, cls_tax, allhits_of,
                                 results)

    # copied from metacache_tpu/classify/runner.py:2123-2253
    def _postprocess_arrays(self, batch, cand_tgt, cand_tax, cand_hits,
                            cand_beg, cand_end, cls_tax, allhits_of,
                            results):
        db = self.db
        opt = self.opt
        oopt = opt.output
        make_truth = oopt.evaluate.precision or \
            oopt.evaluate.determine_ground_truth
        if self._line_writer is None:
            self._line_writer = out_mod.MappingLineWriter(
                db.taxa, oopt, db.sketching)
        writer = self._line_writer
        write = results.per_read_out.write

        taxa = db.taxa
        targets_get = taxa.taxonomy.targets.get
        taxa_get = taxa.taxonomy.taxa.get

        def find(tid):
            return targets_get(tid) if tid < 0 else taxa_get(tid)

        precision = oopt.evaluate.precision
        track_matches = (oopt.analysis.show_hits_per_target or
                         opt.classify.cov_percentile > 0)
        save_mappings = opt.classify.cov_percentile > 0
        show_align = oopt.analysis.show_alignment
        hits_min = self.hits_min
        tax_counts = results.tax_counts
        tgt_matches = results.tgt_matches
        stats = results.statistics
        rank_counts = [0] * (NUM_RANKS + 1) if not precision else None

        need_allhits = oopt.analysis.show_all_hits
        raw_hdrs = getattr(batch, "headers", None)
        fast_ok = (raw_hdrs is not None and not need_allhits
                   and not make_truth and not track_matches
                   and not save_mappings and not show_align
                   and rank_counts is not None
                   and not writer.show_gt and not writer.show_allhits
                   and not writer.show_locations
                   and os.environ.get("MC_NATIVE_FMT", "1") != "0")
        if fast_ok:
            # native whole-batch formatter (MappingLineWriter.lines_batch)
            blob = b"" if writer.suppressed else writer.lines_batch(
                raw_hdrs, cand_tgt, cand_tax, cand_hits, cls_tax,
                results.query_count + 1, find)
            if blob is not None:
                if blob:
                    write(blob.decode("utf-8", "replace"))
                uc, ucnt = np.unique(cls_tax, return_counts=True)
                for ci, cn in zip(uc.tolist(), ucnt.tolist()):
                    best = find(ci) if ci != 0 else None
                    if best is not None:
                        tax_counts[best] = tax_counts.get(best, 0) + cn
                        rank_counts[best.rank] += cn
                    else:
                        rank_counts[Rank.NONE] += cn
                results.query_count += len(batch)
                stats.assigned_ += np.asarray(rank_counts, np.int64)
                return

        k = cand_tgt.shape[1]
        tgt_l = cand_tgt.tolist()
        tax_l = cand_tax.tolist()
        hits_l = cand_hits.tolist()
        beg_l = cand_beg.tolist()
        end_l = cand_end.tolist()
        cls_l = cls_tax.tolist()
        qid0 = results.query_count
        line = writer.line
        lines: list = []
        for i in range(len(batch)):
            qid_out = qid0 + i + 1
            header = _decode_header(raw_hdrs[i]) if raw_hdrs is not None \
                else batch[i].header
            ti = tgt_l[i]
            cands = []
            for j in range(k):
                tj = ti[j]
                if tj < 0:
                    break
                cands.append((find(tax_l[i][j]), tj, hits_l[i][j],
                              beg_l[i][j], end_l[i][j]))
            ci = cls_l[i]
            best = find(ci) if ci != 0 else None
            truth = cls_mod.ground_truth(taxa, header) \
                if make_truth else None

            if track_matches:
                for (tax, tgt, hits, beg, end) in cands:
                    if tax is not None and hits >= hits_min:
                        tgt_matches.setdefault(tgt, []).append(
                            (qid_out, beg, end, hits))
            if save_mappings:
                results.saved_mappings.append((qid_out, header, cands))
                continue

            if best is not None:
                tax_counts[best] = tax_counts.get(best, 0) + 1
                if rank_counts is not None:
                    rank_counts[best.rank] += 1
            elif rank_counts is not None:
                rank_counts[Rank.NONE] += 1
            if rank_counts is None:
                cls_mod.evaluate_classification(
                    best, truth, taxa, precision,
                    oopt.evaluate.taxon_coverage, stats)
            allhits = []
            if need_allhits and i in allhits_of:
                ht, hw = allhits_of[i]
                allhits = list(zip(ht.tolist(), hw.tolist()))
            align_text = ""
            if show_align and best is not None and cands:
                align_text = self._make_alignment_text(batch[i], cands[0])
            lines.append(line(qid_out, header, best, truth, cands, allhits,
                              align_text))
        if lines:
            write("".join(lines))
        results.query_count += len(batch)
        if rank_counts is not None:
            stats.assigned_ += np.asarray(rank_counts, np.int64)

    # copied from metacache_tpu/classify/runner.py:2256-2292
    def _make_alignment_text(self, q, cand) -> str:
        """Align the query to the top candidate's window range
        (reference: show_alignment, src/classification.cpp:384-427), on
        the host, as the reference's display (src/printing.cpp:105)."""
        from .alignment import make_semi_global_alignment
        from ..seqio.reader import read_sequences
        (tax, _tgt, _hits, beg, end) = cand
        if tax is None or tax.rank != Rank.SEQUENCE or tax.source is None:
            return ""
        sk = self.db.sketching
        try:
            it = read_sequences(tax.source.filename)
            rec = None
            for r in it:
                if r.index == tax.source.index:
                    rec = r
                    break
            if rec is None:
                return ""
            w = sk.winstride
            subject = rec.seq[w * beg: w * end + sk.winlen]
            (score, aq, asub), best_score = make_semi_global_alignment(
                q.seq1, q.seq2, subject)
            c = self.opt.output.format.tokens.comment
            return (f"\n{c}  score  {best_score}"
                    f"  aligned to {tax.source.filename} #{tax.source.index}"
                    f" in range [{w * beg},{w * end + w}]\n"
                    f"{c}  query  {aq.decode()}\n"
                    f"{c}  target {asub.decode()}")
        except OSError as e:
            # the subject sequence is re-read from its source file at
            # query time (reference: src/classification.cpp:384-426);
            # a missing/unreadable file skips the alignment display but
            # must not fail silently
            from ..utils import info as info_mod
            info_mod.error(f"WARNING: could not align against "
                           f"{tax.source.filename}: {e}")
            return ""

    # copied from metacache_tpu/classify/runner.py:2295-2323
    def redo_saved_classification(self, results: ClassificationResults):
        """Coverage-percentile second pass (reference:
        filter_targets_by_coverage + redo_classification_batched,
        src/classification.cpp:591-721)."""
        db = self.db
        opt = self.opt
        oopt = opt.output
        filter_targets_by_coverage(db.taxa, results.tgt_matches,
                                   opt.classify.cov_percentile)
        for (qid_out, header, cands) in results.saved_mappings:
            cands = [c for c in cands if c[1] in results.tgt_matches]
            host_cands = [cls_mod.HostCandidate(tax, tgt, hits, beg, end)
                          for (tax, tgt, hits, beg, end) in cands]
            best = cls_mod.classify(
                db.taxa, opt.classify, self.hits_min, host_cands,
                Rank(self.merge_rank), Rank(self.highest_rank))
            truth = (cls_mod.ground_truth(db.taxa, header)
                     if (oopt.evaluate.precision or
                         oopt.evaluate.determine_ground_truth) else None)
            if best is not None:
                results.tax_counts[best] = \
                    results.tax_counts.get(best, 0) + 1
            cls_mod.evaluate_classification(
                best, truth, db.taxa, oopt.evaluate.precision,
                oopt.evaluate.taxon_coverage, results.statistics)
            results.per_read_out.write(out_mod.show_query_mapping(
                db.taxa, oopt, db.sketching, qid_out, header, best, truth,
                cands, []))
        results.saved_mappings = []


# copied from metacache_tpu/classify/runner.py:2326-2347
def filter_targets_by_coverage(taxonomy, tgt_matches: Dict[int, list],
                               percentile: float):
    """Reference: filter_targets_by_coverage
    (src/classification.cpp:591-634)."""
    cov = []
    total = 0.0
    for tgt, cands in tgt_matches.items():
        tax = taxonomy.cached_taxon_of_target(tgt)
        nwin = tax.source.windows if tax and tax.source else 1
        hit_windows = set()
        for (_qid, beg, end, _hits) in cands:
            hit_windows.update(range(beg, end + 1))
        p = len(hit_windows) / nwin
        total += p
        cov.append((tgt, p))
    cov.sort(key=lambda tp: tp[1])
    part = 0.0
    for tgt, p in cov:
        part += p
        if part > percentile * total:
            break
        del tgt_matches[tgt]


def _split_rows(chunks: list, n: int):
    """The first ``n`` rows of ``chunks``, a list of tuples of arrays
    with rows along axis 0 (in order) -> (those rows as such a list, the
    rest); views, no copy."""
    head, rest, got = [], [], 0
    for c in chunks:
        m = len(c[0])
        use = min(m, n - got)
        if use:
            head.append(tuple(x[:use] for x in c))
            got += use
        if use < m:
            rest.append(tuple(x[use:] for x in c))
    return head, rest


def _fill_rows(out: np.ndarray, blocks) -> None:
    """Stack row ``blocks`` into ``out`` (rows, width): each block's
    rows in turn, zero-filled past its width, and zero rows after the
    last."""
    r = 0
    for b in blocks:
        w = b.shape[1]
        out[r:r + len(b), :w] = b
        out[r:r + len(b), w:] = 0
        r += len(b)
    out[r:] = 0


# copied from metacache_tpu/classify/runner.py:2350-2364
def _bucket_wq(x: int) -> int:
    """Window-count bucket: exact up to 8, multiples of 4 to 32, then
    pow2."""
    x = max(x, 1)
    if x <= 8:
        return x
    if x <= 32:
        return (x + 3) // 4 * 4
    return _round_up_pow2(x)


def _round_up_pow2(x: int) -> int:
    return 1 << (x - 1).bit_length()


# copied from metacache_tpu/classify/runner.py:2380-2443
def map_queries_to_targets(infiles: List[str], db: Database,
                           opt: QueryOptions,
                           results: ClassificationResults,
                           runner: QueryRunner | None = None, devices=None):
    """Reference: map_queries_to_targets (src/classification.cpp:870-881).
    ``runner`` reuses staged tables across calls; ``devices``: the
    devices a new runner's grid takes (QueryRunner)."""
    runner = runner or QueryRunner(db, opt, devices=devices)
    oopt = opt.output
    if oopt.format.map_view_mode != MapViewMode.NONE:
        results.per_read_out.write(
            out_mod.show_query_mapping_header(oopt))

    t0 = time.monotonic()
    # announce + stream each input file (pair) in order
    # (reference: query_database, src/database_query.hpp:345-360)
    comment = oopt.format.tokens.comment
    files = opt.pairing == PairingMode.FILES
    for i in range(0, len(infiles), 2 if files else 1):
        group = infiles[i:i + 2] if files else infiles[i:i + 1]
        if len(group) == 2:
            results.per_read_out.write(
                f"{comment}{group[0]} + {group[1]}\n")
            if runner.run_pair_files_native(group[0], group[1], results):
                continue
        else:
            results.per_read_out.write(f"{comment}{group[0]}\n")
            if opt.pairing == PairingMode.NONE and \
                    runner.run_file_native(group[0], results):
                continue
            if opt.pairing == PairingMode.SEQUENCES and \
                    runner.run_pair_seq_native(group[0], results):
                continue
        queries = read_queries(group, opt.pairing)
        if opt.query_limit >= 0:
            # the limit applies per sequence source
            # (reference: performance_tuning_options.queryLimit,
            # src/options.hpp:234-235)
            queries = itertools.islice(queries, opt.query_limit)
        runner.run_queries(queries, results)

    if opt.classify.cov_percentile > 0:
        runner.redo_saved_classification(results)
    results.time_ms = (time.monotonic() - t0) * 1000.0

    if oopt.analysis.show_hits_per_target:
        ordered = {t: sorted(v, key=lambda c: (c[1], c[2], c[0]))
                   for t, v in results.tgt_matches.items()}
        results.per_target_out.write(out_mod.show_matches_per_targets(
            db.taxa, db.sketching, ordered, oopt.format))

    if oopt.analysis.show_tax_abundances:
        results.per_taxon_out.write(out_mod.show_abundances(
            abd.sort_tax_counts(results.tax_counts), results.statistics,
            oopt.format))

    if oopt.analysis.abundance_per != Rank.NONE:
        est = abd.estimate_abundance(db.taxa, results.tax_counts,
                                     oopt.analysis.abundance_per)
        results.per_taxon_out.write(out_mod.show_abundance_estimates(
            oopt.analysis.abundance_per, abd.sort_tax_counts(est),
            results.statistics, oopt.format))
    return results
