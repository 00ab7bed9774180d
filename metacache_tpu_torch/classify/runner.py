"""Query execution: stream reads, classify on the card, produce output.

Port of metacache_tpu/classify/runner.py (QueryRunner) for single-end
reads against a single-part u32 database, with packed slots when they
fit int32 and (tgt, win) lane pairs when they do not (many targets,
long genomes). Two paths, as in the JAX package:

- summary only (``-no-map`` and no per-read analysis): the native
  reader's 2-bit packed short reads are stacked K batches deep and
  classified by ``query_step_rows_scan``; a rank histogram computed on
  the card is the only thing fetched;
- per-read output: coded read batches are bucketed by window count and
  classified by ``query_step_rows``, then formatted on the host.

The database stages on the card as the JAX runner stages it: a
database built in this process (``build+query``) keeps the tables its
build made there; a loaded one uploads its CSR stream and fills the
probe rows on the card (ops/table_device.py::device_layout_from_csr);
``MC_DEVICE_LAYOUT=0`` fills host rows in numpy and copies them. Dense
fused rows when they fit the card's budget, else two-tier head and
overflow rows or size-classed cells; with packed slots the summary path
then classifies head-only and redoes at full depth only the reads that
touched a deeper bucket (escalation). Options outside this slice raise
NotImplementedError naming their ROADMAP item. The JAX runner's
TPU-link workarounds (packed result fetches, fixed dispatch shapes) are
not carried over.
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

from .. import native
from ..config import SketchingOptions, max_windows_in_range
from ..db.database import Database
from ..native import decode_header as _decode_header
from ..ops import windows as win_ops
from ..seqio.reader import PairingMode, QueryRecord, read_queries
from ..taxonomy.model import NUM_RANKS, Rank, rank_from_name
from ..db.state import tables_from_device, tables_from_numpy
from ..device import get_device, hbm_budget_bytes
from ..ops.probe import make_bucket_index
from ..ops.rows import (query_step_rows, query_step_rows_redo_scan,
                        query_step_rows_scan, query_step_rows_scan_head)
from ..ops.table import device_layout, unpack_locations
from ..ops.table_device import dense_bytes, device_layout_from_csr
from . import abundance as abd
from . import classification as cls_mod
from . import output as out_mod
from .options import ClassificationResults, QueryOptions
from .output import MapViewMode


def rank_histogram(cls: torch.Tensor, n: int, taxid_sorted: torch.Tensor,
                   rank_of: torch.Tensor,
                   over_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Summary rank histogram on the card: (NUM_RANKS + 1,) counts of the
    first ``n`` classified taxa by rank (runner.py:106-128). Reads whose
    bit is set in ``over_bits`` (32 reads a word, escalation phase 1) are
    left out: the redo counts them (runner.py:76-102)."""
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


class _CodedBatch:
    """A coded read batch: raw header rows for the line formatter."""

    def __init__(self, headers):
        self.headers = headers

    def __len__(self):
        return len(self.headers)


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


def _unsupported(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


class QueryRunner:
    """Holds the device-resident database state across query runs."""

    # copied from metacache_tpu/classify/runner.py:700-701 and :722
    MAX_WALK_ELEMS = 64
    MAX_DEDUP_WALK = 48
    FUSED_MIN_SLOTS = 1024

    def __init__(self, db: Database, opt: QueryOptions,
                 device: torch.device | None = None):
        self.device = device or get_device()
        self.db = db
        self.opt = opt
        oa = opt.output.analysis
        if db.sketching.kmerlen > 16:
            _unsupported("k > 16 (64-bit features)", "queue A13")
        if opt.num_replicas != 1 or opt.table_shards != 1:
            _unsupported("-replicate / -table-shards", "queue A14")
        if opt.pairing != PairingMode.NONE:
            _unsupported("paired-end reads", "queue A12")
        if len(db.parts) + len(db.device_parts) != 1:
            _unsupported("multi-part databases", "queue A12")
        if oa.show_all_hits or oa.show_locations:
            _unsupported("-allhits / -locations", "queue A5")
        if oa.show_alignment:
            _unsupported("-align", "queue A7")
        if opt.classify.cov_percentile > 0:
            _unsupported("-cov-percentile", "queue A7")
        if opt.classify.max_candidates > 4:
            _unsupported("-maxcand above 4", "queue A5")
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
        if self.merge_rank != 0:
            _unsupported("taxon merging (-lowest above sequence)",
                         "queue A5")

        # staging (runner.py:481-565, 632-646): packed pk slots when they
        # fit int32, else (tgt, win) lane pairs (layout tag True)
        self.budget_bytes = hbm_budget_bytes(self.device)
        lineages = self.lineages if db.target_count else \
            np.zeros((1, NUM_RANKS), np.int32)
        if db.device_parts:
            # tables built on the card by this process (build+query)
            dtab = db.device_parts[0]
            self._pack_bits = slot_pack_bits(db.target_count, dtab.max_win)
            self._take(dtab, lineages, merge_tax)
        else:
            self._stage_part(db.parts[0], lineages, merge_tax)
        self.esc_reads = 0          # reads escalated to the full-depth redo

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

    def _take(self, dtab, lineages, merge_tax):
        """Probe through a DeviceTable (ops/table_device.py)."""
        self.tables = tables_from_device(dtab, lineages, merge_tax)
        self.dense_bytes = dense_bytes(dtab.nf, dtab.spf, dtab.slot_bits)
        self.staged_bytes = dtab.layout_bytes

    def _stage_part(self, p, lineages, merge_tax):
        """Stage a loaded part: its CSR stream filled into probe rows on
        the card (MC_DEVICE_LAYOUT=1, the default), or host rows copied
        (MC_DEVICE_LAYOUT=0). MC_DENSE_LIMIT caps only the dense option.
        Where no layout fits, the CSR probe it would need is not ported
        (queue A10): the builder's MemoryError raises so."""
        maxwin = int((p.locations & np.uint64(0xFFFFFFFF)).max()) \
            if p.num_locations else 0
        self._pack_bits = slot_pack_bits(self.db.target_count, maxwin)
        spf = min(p.max_bucket_size, self.db.max_locations_per_feature) or 1
        try:
            dense_cap = int(os.environ.get("MC_DENSE_LIMIT", 0)) or None
        except ValueError:
            dense_cap = None
        allow_dense = dense_cap is None or \
            p.dense_rows_bytes(spf) <= dense_cap
        if os.environ.get("MC_DEVICE_LAYOUT", "1") != "0" and \
                p.num_features:
            ltgt, lwin = unpack_locations(p.locations)
            try:
                dtab = device_layout_from_csr(
                    p.unique_features, p.offsets, ltgt, lwin,
                    device=self.device,
                    cap=self.db.max_locations_per_feature or 254,
                    budget_bytes=self.budget_bytes, allow_dense=allow_dense)
            except MemoryError as e:
                raise NotImplementedError(
                    f"{e}: the CSR probe layout is not ported yet (ROADMAP "
                    "queue A10)") from None
            del ltgt, lwin
            self._take(dtab, lineages, merge_tax)
            return
        hsl, self.dense_bytes, self.staged_bytes = device_layout(
            p, spf, self._pack_bits, self.budget_bytes,
            allow_dense=allow_dense)
        if hsl == spf:
            rows = p.fused_rows(spf, slot_bits=self._pack_bits)
            ovf, hsl = None, 0
        else:
            rows, ovf = p.fused_rows_two_tier(spf, hsl,
                                              slot_bits=self._pack_bits)
        brows, bits = make_bucket_index(p.unique_features)
        self.tables = tables_from_numpy(
            p.unique_features, p.offsets, rows, brows, bits, lineages,
            merge_tax, spf, self._pack_bits, self.device, ovf_rows=ovf,
            head_slots=hsl)

    @property
    def layout(self) -> str:
        """Probe layout tag of the staged table (e.g. "pk15",
        "('two_tier', 61, True, False, 15)" or "('classed', 61, False,
        False, 15)")."""
        return str(self.tables.dense)

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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

    # copied from metacache_tpu/classify/runner.py:957-1125 with the
    # escalation branches of the feats-reuse redo (:975-1034); the row
    # re-dispatch (:1035-1052) and the fused dispatch (MC_ESC_FUSED) serve
    # routes the port does not take
    def _run_scan_native_packed(self, reader, batch_reads: int,
                                scan_k: int, results, extra_readers=None):
        """Summary fast path fed by the native packed reader: clean short
        reads arrive 2-bit packed and are stacked scan_k batches deep;
        long/ambiguous reads ride the coded per-read path. The remainder
        pads to a full stack whose payload carries the real read count.
        On two-tier tables with packed slots the stacks classify
        head-only and the flagged reads are redone at full depth."""
        opt = self.opt
        wl = self.sketching.winlen
        pending: collections.deque = collections.deque()
        DEPTH = 3   # dispatches in flight
        take = scan_k * batch_reads
        esc = self._escalation_ok() and self._hist_dev is not None
        self._esc_redo = []      # (feats, idx, lens) of flagged reads
        self._esc_nredo = 0

        def flush(dispatched):
            while len(pending) >= DEPTH:
                self._collect_batch(*pending.popleft(), results)
            pending.append(dispatched)

        def scan_dispatch(pa, la, n):
            # crop rows to the stack's max read length (4-byte quantum)
            q = min(-(-int(la.max(initial=0)) // 16) * 4, pa.shape[1]) \
                if n else 4
            pac = np.ascontiguousarray(pa[:, :max(q, 4)])
            if esc:
                return (None, ("scanesc", (n, la, *self._dispatch_scan_head(
                    pac, la, scan_k, batch_reads))))
            return (None, ("scan", (n, self._dispatch_scan(
                pac, la, scan_k, batch_reads))))

        def flush_redo(final: bool = False):
            # full-depth phase 2 on phase 1's sketches and bucket probes
            # for the reads that touched a bucket deeper than the head;
            # unlike the JAX runner's fixed-shape stacks, a redo stack is
            # only as deep as its reads need
            while self._esc_nredo >= take or (final and self._esc_nredo):
                k2 = min(scan_k, -(-self._esc_nredo // batch_reads))
                rf, ri, rlens, got = self._carve_redo(k2 * batch_reads)
                flush((None, ("scan", (got, self._dispatch_redo(
                    rf, ri, rlens, k2, batch_reads)))))

        buf: list = []
        nbuf = 0
        # producer thread(s): the C parser releases the GIL, so parsing
        # overlaps device work
        readers = [reader] + list(extra_readers or [])
        chunks: queue.Queue = queue.Queue(maxsize=2 + 2 * len(readers))
        done = threading.Lock()
        live = [len(readers)]

        def _produce(rd):
            try:
                while True:
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
                pa = np.concatenate([c for c, _ in buf])
                la = np.concatenate([l for _, l in buf])
                flush(scan_dispatch(pa[:take], la[:take], take))
                buf = [(pa[take:], la[take:])]
                nbuf -= take
                flush_redo()
        if nbuf:
            pa = np.concatenate([c for c, _ in buf])
            la = np.concatenate([l for _, l in buf])
            n = len(la)
            pa = np.concatenate(
                [pa, np.zeros((take - n, pa.shape[1]), np.uint8)])
            la = np.concatenate([la, np.zeros(take - n, np.int32)])
            flush(scan_dispatch(pa, la, n))
        while pending:
            self._collect_batch(*pending.popleft(), results)
        flush_redo(final=True)
        while pending:
            self._collect_batch(*pending.popleft(), results)
        for th in ths:
            th.join()

    def _scan_inputs(self, codes, lens, scan_k: int, bsz: int):
        """Stacked 2-bit packed rows -> (windows, valid, mwir) host arrays
        of the scan steps (runner.py:1910-1921)."""
        sk = self.sketching
        opt = self.opt
        wl = sk.winlen
        stride = self.db.sketching.winstride
        wmat = np.ascontiguousarray(codes).reshape(
            scan_k, bsz, 1, codes.shape[1])
        mwir_max = 2 + max(wl, opt.classify.insert_size_max) // stride
        vdt = np.uint8 if wl < 256 else np.int32
        mdt = np.uint8 if mwir_max < 256 else np.int32
        vmat = np.where(lens >= sk.kmerlen, lens, 0).astype(
            vdt).reshape(scan_k, bsz, 1)
        mwir = (2 + np.maximum(lens, opt.classify.insert_size_max)
                // stride).astype(mdt).reshape(scan_k, bsz)
        return wmat, vmat, mwir

    def _dispatch_scan(self, codes, lens, scan_k: int, bsz: int):
        """One scan over scan_k stacked short-read batches of 2-bit packed
        rows; -> (scan_k, bsz) classified taxa on the device (adapted from
        metacache_tpu/classify/runner.py:1895-1932)."""
        sk = self.sketching
        opt = self.opt
        wmat, vmat, mwir = self._scan_inputs(codes, lens, scan_k, bsz)
        return query_step_rows_scan(
            self._to_dev(wmat), self._to_dev(vmat), self._to_dev(mwir),
            self.tables, self.hits_min, opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank,
            k=sk.kmerlen, sketchlen=sk.sketchlen, windows_per_query=1,
            max_candidates=opt.classify.max_candidates,
            pack_bits=self._pack_bits, infeed_packed=True,
            fast_top2=self._fast_top2,
            **self._sweep_params(mwir.reshape(-1).astype(np.int32), 1))

    # copied from metacache_tpu/classify/runner.py:1671-1693 for single
    # reads (wq = 1) and without the fused-candidates and part-count
    # tests: the port always takes the fused candidate branch and stages
    # one part
    def _escalation_ok(self) -> bool:
        """Escalation (head-only phase 1 + full-depth redo) is valid for
        slot-packed two-tier and classed layouts on the fused fast path;
        it pays off when buckets can exceed the head. MC_ESCALATE=0
        disables."""
        if os.environ.get("MC_ESCALATE", "1") == "0" or \
                not self._fast_top2 or not self._pack_bits:
            return False
        t = self.tables
        sk = self.sketching
        stride = self.db.sketching.winstride
        m = 2 + max(sk.winlen, self.opt.classify.insert_size_max) // stride
        sweep_ok = (m * sk.sketchlen <= self.MAX_WALK_ELEMS or
                    m <= self.MAX_DEDUP_WALK)
        return (t.head_slots > 0 and t.slot_bits == self._pack_bits and
                t.spf > t.head_slots and sweep_ok and
                sk.sketchlen * t.spf >= self.FUSED_MIN_SLOTS)

    # copied from metacache_tpu/classify/runner.py:1695-1731
    def _dispatch_scan_head(self, codes, lens, scan_k: int, bsz: int):
        """Escalation phase 1 (head-only probe) over prepacked rows;
        -> (cls (K, B), over_bits (K, B/32), feats (K, B, F), idx
        (K, B, F)) device tensors."""
        sk = self.sketching
        opt = self.opt
        wmat, vmat, mwir = self._scan_inputs(codes, lens, scan_k, bsz)
        return query_step_rows_scan_head(
            self._to_dev(wmat), self._to_dev(vmat), self._to_dev(mwir),
            self.tables, self.hits_min, opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank, k=sk.kmerlen,
            sketchlen=sk.sketchlen,
            max_candidates=opt.classify.max_candidates,
            walk_elems=int(mwir.max()) * sk.sketchlen, fast_top2=True,
            pack_bits=self._pack_bits, infeed_packed=True)

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
            fparts.append(torch.full((pad, F), -1, dtype=torch.int32,
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
        return query_step_rows_redo_scan(
            feats.reshape(scan_k, bsz, F), idx.reshape(scan_k, bsz, F),
            self._to_dev(mwir.reshape(scan_k, bsz)), self.tables,
            self.hits_min, opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank,
            max_candidates=opt.classify.max_candidates, fast_top2=True,
            pack_bits=self._pack_bits, **self._sweep_params(mwir, wq))

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
            rows = _round_up_pow2(len(idxs))
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
                rows = _round_up_pow2(len(idxs))
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
        return (_CodedBatch(headers), ("rows", launched))

    def _launch_rows(self, wmat, vmat, mwir, wq, k):
        sk = self.sketching
        return query_step_rows(
            self._to_dev(wmat), self._to_dev(vmat), self._to_dev(mwir),
            self.tables, self.hits_min,
            self.opt.classify.hits_diff_fraction, self.highest_rank,
            self.merge_rank, k=sk.kmerlen, sketchlen=sk.sketchlen,
            windows_per_query=wq, max_candidates=k,
            pack_bits=self._pack_bits, fast_top2=self._fast_top2,
            **self._sweep_params(mwir, wq))

    def _collect_batch(self, batch, dispatched, results):
        kind, payload = dispatched
        if kind == "scanesc":
            # escalation phase 1 (runner.py:1617-1644): count the reads
            # the head classified exactly, queue the flagged ones, with
            # their sketches and bucket probes, for the full-depth redo
            n, la, cls_dev, over_dev, fk, ik = payload
            hist = rank_histogram(cls_dev, n, *self._hist_dev,
                                  over_bits=over_dev)
            bits = over_dev.cpu().numpy().reshape(-1)
            mask = (((bits[:, None] >> np.arange(32)) & 1)
                    .astype(bool).reshape(-1))
            mask[n:] = False
            idxs = np.nonzero(mask)[0]
            if len(idxs):
                F = fk.shape[-1]
                sel = self._to_dev(idxs)
                self._esc_redo.append((fk.reshape(-1, F)[sel],
                                       ik.reshape(-1, F)[sel], la[idxs]))
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
            rows = _round_up_pow2(len(idxs))
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
        for (idxs, _rows, res) in launched:
            sel = np.asarray(idxs)
            m = len(idxs)
            # one device-to-host copy per launch
            packed = torch.cat([res.cand_tgt, res.cand_tax, res.cand_hits,
                                res.cand_beg, res.cand_end,
                                res.cls_tax[:, None]], dim=1)[:m]
            packed = packed.cpu().numpy()
            kk = res.cand_tgt.shape[1]
            cand_tgt[sel] = packed[:, 0 * kk:1 * kk]
            cand_tax[sel] = packed[:, 1 * kk:2 * kk]
            cand_hits[sel] = packed[:, 2 * kk:3 * kk]
            cand_beg[sel] = packed[:, 3 * kk:4 * kk]
            cand_end[sel] = packed[:, 4 * kk:5 * kk]
            cls_tax[sel] = packed[:, 5 * kk]
        self._postprocess_arrays(batch, cand_tgt, cand_tax, cand_hits,
                                 cand_beg, cand_end, cls_tax, results)

    # copied from metacache_tpu/classify/runner.py:2123-2253 without the
    # -allhits, -align and -cov-percentile branches (rejected above)
    def _postprocess_arrays(self, batch, cand_tgt, cand_tax, cand_hits,
                            cand_beg, cand_end, cls_tax, results):
        db = self.db
        oopt = self.opt.output
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
        track_matches = oopt.analysis.show_hits_per_target
        hits_min = self.hits_min
        tax_counts = results.tax_counts
        tgt_matches = results.tgt_matches
        stats = results.statistics
        rank_counts = [0] * (NUM_RANKS + 1) if not precision else None

        raw_hdrs = getattr(batch, "headers", None)
        fast_ok = (raw_hdrs is not None and not make_truth
                   and not track_matches and rank_counts is not None
                   and not writer.show_gt and not writer.show_allhits
                   and not writer.show_locations)
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
            lines.append(line(qid_out, header, best, truth, cands, [], ""))
        if lines:
            write("".join(lines))
        results.query_count += len(batch)
        if rank_counts is not None:
            stats.assigned_ += np.asarray(rank_counts, np.int64)


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


# copied from metacache_tpu/classify/runner.py:2382-2443, single-end
def map_queries_to_targets(infiles: List[str], db: Database,
                           opt: QueryOptions,
                           results: ClassificationResults,
                           runner: QueryRunner | None = None):
    """Reference: map_queries_to_targets (src/classification.cpp:870-881).
    ``runner`` reuses staged tables across calls."""
    runner = runner or QueryRunner(db, opt)
    oopt = opt.output
    if oopt.format.map_view_mode != MapViewMode.NONE:
        results.per_read_out.write(
            out_mod.show_query_mapping_header(oopt))

    t0 = time.monotonic()
    comment = oopt.format.tokens.comment
    for path in infiles:
        results.per_read_out.write(f"{comment}{path}\n")
        if runner.run_file_native(path, results):
            continue
        queries = read_queries([path], PairingMode.NONE)
        if opt.query_limit >= 0:
            queries = itertools.islice(queries, opt.query_limit)
        runner.run_queries(queries, results)
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
