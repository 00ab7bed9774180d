"""Query execution: stream reads, classify on the card, produce output.

Port of metacache_tpu/classify/runner.py (QueryRunner) for single-end
reads against a single-part u32 database staged in the dense layout,
with packed slots when they fit int32 and (tgt, win) lane pairs when
they do not (many targets, long genomes). Two paths, as in the JAX
package:

- summary only (``-no-map`` and no per-read analysis): the native
  reader's 2-bit packed short reads are stacked K batches deep and
  classified by ``query_step_rows_scan``; a rank histogram computed on
  the card is the only thing fetched;
- per-read output: coded read batches are bucketed by window count and
  classified by ``query_step_rows``, then formatted on the host.

Options outside this slice raise NotImplementedError naming their
ROADMAP item. The JAX runner's TPU-link workarounds (packed result
fetches, fixed dispatch shapes, escalation) are not carried over.
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
from ..db.state import tables_from_numpy
from ..device import get_device, hbm_budget_bytes
from ..ops.probe import make_bucket_index
from ..ops.rows import query_step_rows, query_step_rows_scan
from . import abundance as abd
from . import classification as cls_mod
from . import output as out_mod
from .options import ClassificationResults, QueryOptions
from .output import MapViewMode


def rank_histogram(cls: torch.Tensor, n: int, taxid_sorted: torch.Tensor,
                   rank_of: torch.Tensor) -> torch.Tensor:
    """Summary rank histogram on the card: (NUM_RANKS + 1,) counts of the
    first ``n`` classified taxa by rank (runner.py:106-128)."""
    cls = cls.reshape(-1)
    nt = taxid_sorted.shape[0]
    pos = torch.clamp(torch.searchsorted(taxid_sorted, cls), max=nt - 1)
    found = (taxid_sorted[pos] == cls) & (cls != 0)
    ranks = torch.where(found, rank_of[pos], NUM_RANKS)
    valid = torch.arange(cls.shape[0], device=cls.device) < n
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

    # copied from metacache_tpu/classify/runner.py:700-701
    MAX_WALK_ELEMS = 64
    MAX_DEDUP_WALK = 48

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
        if len(db.parts) != 1:
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

        # dense staging: packed pk slots when they fit int32, else
        # (tgt, win) lane pairs (layout tag True)
        p = db.parts[0]
        maxwin = int((p.locations & np.uint64(0xFFFFFFFF)).max()) \
            if p.num_locations else 0
        self._pack_bits = slot_pack_bits(db.target_count, maxwin)
        spf = min(p.max_bucket_size, db.max_locations_per_feature) or 1
        kind, _head = p.choose_layout(spf, hbm_budget_bytes(self.device))
        if kind != "dense":
            _unsupported(f"the {kind} probe layout", "queue A10")
        fused = p.fused_rows(spf, slot_bits=self._pack_bits)
        brows, bits = make_bucket_index(p.unique_features)
        lineages = self.lineages if db.target_count else \
            np.zeros((1, NUM_RANKS), np.int32)
        self.tables = tables_from_numpy(
            p.unique_features, p.offsets, fused, brows, bits, lineages,
            merge_tax, spf, self._pack_bits, self.device)
        del fused

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

    @property
    def layout(self) -> str:
        """Probe layout tag of the staged table (e.g. "pk15")."""
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

    # copied from metacache_tpu/classify/runner.py:957-1125 without the
    # escalation branches (the dense layout never escalates)
    def _run_scan_native_packed(self, reader, batch_reads: int,
                                scan_k: int, results, extra_readers=None):
        """Summary fast path fed by the native packed reader: clean short
        reads arrive 2-bit packed and are stacked scan_k batches deep;
        long/ambiguous reads ride the coded per-read path. The remainder
        pads to a full stack whose payload carries the real read count."""
        opt = self.opt
        wl = self.sketching.winlen
        pending: collections.deque = collections.deque()
        DEPTH = 3   # dispatches in flight
        take = scan_k * batch_reads

        def flush(dispatched):
            while len(pending) >= DEPTH:
                self._collect_batch(*pending.popleft(), results)
            pending.append(dispatched)

        def scan_dispatch(pa, la, n):
            # crop rows to the stack's max read length (4-byte quantum)
            q = min(-(-int(la.max(initial=0)) // 16) * 4, pa.shape[1]) \
                if n else 4
            pac = np.ascontiguousarray(pa[:, :max(q, 4)])
            return (None, ("scan", (n, self._dispatch_scan(
                pac, la, scan_k, batch_reads))))

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
        for th in ths:
            th.join()

    def _dispatch_scan(self, codes, lens, scan_k: int, bsz: int):
        """One scan over scan_k stacked short-read batches of 2-bit packed
        rows; -> (scan_k, bsz) classified taxa on the device (adapted from
        metacache_tpu/classify/runner.py:1895-1932)."""
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
        return query_step_rows_scan(
            self._to_dev(wmat), self._to_dev(vmat), self._to_dev(mwir),
            self.tables, self.hits_min, opt.classify.hits_diff_fraction,
            self.highest_rank, self.merge_rank,
            k=sk.kmerlen, sketchlen=sk.sketchlen, windows_per_query=1,
            max_candidates=opt.classify.max_candidates,
            pack_bits=self._pack_bits, infeed_packed=True,
            fast_top2=self._fast_top2,
            **self._sweep_params(mwir.reshape(-1).astype(np.int32), 1))

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
