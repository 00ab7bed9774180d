# copied from metacache_tpu/classify/output.py
"""Classification output formatting.

Byte-compatible re-implementation of the reference's printing layer
(src/printing.cpp:40-698, src/classification.cpp:435-533) — mapping rows,
lineages, tophits/allhits lists, hits-per-target tables, abundance tables and
the per-rank summary. Float formatting matches C++ default ostream precision
(6 significant digits).
"""
from __future__ import annotations

import dataclasses
from enum import Enum
from typing import Optional

from ..taxonomy.model import (NUM_RANKS, Rank, Taxon, TaxonomyCache,
                              rank_name)


def cpp_num(x: float, precision: int = 6) -> str:
    """Format like C++ `os << double` (default precision 6)."""
    if x != x:  # nan (C++ prints the sign bit: 0.0/0.0 is "-nan")
        import math
        return "-nan" if math.copysign(1.0, x) < 0 else "nan"
    s = f"{x:.{precision}g}"
    # C++ prints exponents with at least 2 digits: 4.2e+07
    if "e" in s:
        mant, exp = s.split("e")
        sign = exp[0]
        digits = exp[1:].lstrip("0") or "0"
        if len(digits) < 2:
            digits = "0" + digits
        s = f"{mant}e{sign}{digits}"
    return s


class MapViewMode(Enum):
    NONE = "none"
    MAPPED_ONLY = "mapped_only"
    ALL = "all"


@dataclasses.dataclass
class FormattingTokens:
    """Reference: formatting_tokens (src/options.hpp:288-305)."""
    comment: str = "# "
    none: str = "--"
    column: str = "\t|\t"
    tax_separator: str = ","
    rank_suffix: str = ":"
    taxid_prefix: str = "("
    taxid_suffix: str = ")"


@dataclasses.dataclass
class TaxonPrintStyle:
    show_name: bool = True
    show_rank_name: bool = True
    show_id: bool = False


@dataclasses.dataclass
class OutputFormatting:
    """Reference: classification_output_formatting (src/options.hpp:310-330)."""
    map_view_mode: MapViewMode = MapViewMode.ALL
    show_lineage: bool = False
    show_query_ids: bool = False
    collapse_unclassified: bool = True
    lowest_rank: Rank = Rank.SEQUENCE
    highest_rank: Rank = Rank.DOMAIN
    tokens: FormattingTokens = dataclasses.field(
        default_factory=FormattingTokens)
    style: TaxonPrintStyle = dataclasses.field(
        default_factory=TaxonPrintStyle)
    use_separate_cols: bool = False

    def apply_separate_cols(self):
        """Reference: process_query_options (src/options.cpp:1346-1353)."""
        if self.use_separate_cols:
            self.collapse_unclassified = False
            self.tokens.tax_separator = self.tokens.column
            self.tokens.rank_suffix = self.tokens.column
            self.tokens.taxid_prefix = self.tokens.column
            self.tokens.taxid_suffix = ""


# ---------------------------------------------------------------------------
def print_taxon(name: str, taxid: int, rank: Rank,
                style: TaxonPrintStyle, fmt: FormattingTokens) -> str:
    out = []
    if style.show_rank_name:
        if rank == Rank.NONE:
            out.append(fmt.none + fmt.rank_suffix)
        else:
            out.append(rank_name(rank) + fmt.rank_suffix)
    if style.show_name:
        out.append(name)
        if style.show_id:
            out.append(f"{fmt.taxid_prefix}{taxid}{fmt.taxid_suffix}")
    elif style.show_id:
        out.append(str(taxid))
    return "".join(out)


def show_lineage(lineage, style: TaxonPrintStyle, lowest: Rank,
                 highest: Rank, fmt: FormattingTokens) -> str:
    """Reference: show_lineage (src/printing.cpp:210-232)."""
    if lowest == Rank.NONE:
        return ""
    if highest == Rank.NONE:
        highest = Rank.ROOT
    parts = []
    for r in range(int(lowest), int(highest) + 1):
        tax = lineage[r]
        if tax is not None:
            parts.append(print_taxon(tax.name, tax.id, tax.rank, style, fmt))
        else:
            parts.append(print_taxon(fmt.none, 0, Rank(r), style, fmt))
    return fmt.tax_separator.join(parts)


def show_blank_lineage(style, lowest: Rank, highest: Rank,
                       fmt: FormattingTokens) -> str:
    parts = [print_taxon(fmt.none, 0, Rank.NONE, style, fmt)
             for _ in range(int(lowest), int(highest) + 1)]
    return fmt.tax_separator.join(parts)


def show_taxon(taxonomy: TaxonomyCache, opt: OutputFormatting,
               tax: Optional[Taxon]) -> str:
    """Reference: show_taxon (src/printing.cpp:250-280)."""
    if tax is None or tax.rank > opt.highest_rank:
        if opt.collapse_unclassified:
            if opt.style.show_id and not opt.style.show_name and \
                    not opt.style.show_rank_name:
                return "0"
            return opt.tokens.none
        rmax = opt.highest_rank if opt.show_lineage else opt.lowest_rank
        return show_blank_lineage(opt.style, opt.lowest_rank, rmax,
                                  opt.tokens)
    rmin = max(opt.lowest_rank, tax.rank)
    rmax = opt.highest_rank if opt.show_lineage else rmin
    return show_lineage(taxonomy.cached_ranks(tax), opt.style,
                        Rank(rmin), Rank(rmax), opt.tokens)


def show_taxon_header(opt: OutputFormatting, prefix: str = "") -> str:
    """Reference: show_taxon_header (src/printing.cpp:131-175)."""
    rmax = opt.highest_rank if opt.show_lineage else opt.lowest_rank
    style, fmt = opt.style, opt.tokens

    def one(rname: str) -> str:
        out = []
        if style.show_rank_name:
            out.append(prefix + rname + fmt.rank_suffix)
        if style.show_name:
            out.append(prefix + "taxname")
            if style.show_id:
                out.append(fmt.taxid_prefix + prefix + "taxid" +
                           fmt.taxid_suffix)
        elif style.show_id:
            out.append(prefix + "taxid")
        return "".join(out)

    if opt.lowest_rank == rmax:
        return one("rank")
    return fmt.tax_separator.join(
        one(rank_name(Rank(r)))
        for r in range(int(opt.lowest_rank), int(rmax) + 1))


# ---------------------------------------------------------------------------
def show_candidates(taxonomy: TaxonomyCache, candidates,
                    lowest: Rank) -> str:
    """Tophits list (reference: show_candidates, src/printing.cpp:287-310).

    candidates: list of (tax: Taxon, tgt: int, hits: int).
    """
    parts = []
    for (tax, tgt, hits, *_rest) in candidates:
        if hits <= 0:
            break
        if lowest == Rank.SEQUENCE:
            if tax is not None:
                parts.append(f"{tax.name}:{hits}")
            else:
                parts.append("")
        else:
            t = tax
            if tax is not None and tax.rank < lowest:
                t = taxonomy.lowest_ranked_ancestor(tgt, lowest)
            if t is not None:
                parts.append(f"{t.id}:{hits}")
            else:
                parts.append(f"{tax.name}:{hits}")
    return ",".join(parts)


def show_matches(taxonomy: TaxonomyCache, matches, lowest: Rank) -> str:
    """Allhits list: RLE over sorted (tgt, win) matches
    (reference: show_matches, src/printing.cpp:315-365)."""
    if len(matches) == 0:
        return ""
    out = []
    if lowest == Rank.SEQUENCE:
        cur, count = matches[0], 1
        for m in matches[1:]:
            if m == cur:
                count += 1
            else:
                tax = taxonomy.cached_taxon_of_target(cur[0])
                if tax is not None:
                    out.append(f"{tax.name}/{cur[1]}:{count},")
                cur, count = m, 1
        tax = taxonomy.cached_taxon_of_target(cur[0])
        if tax is not None:
            out.append(f"{tax.name}/{cur[1]}:{count},")
    else:
        cur, count = matches[0], 1
        for m in matches[1:]:
            if m == cur:
                count += 1
            else:
                tax = taxonomy.lowest_ranked_ancestor(cur[0], lowest) or \
                    taxonomy.cached_taxon_of_target(cur[0])
                out.append(f"{tax.name}:{count},")
                cur, count = m, 1
        tax = taxonomy.lowest_ranked_ancestor(cur[0], lowest) or \
            taxonomy.cached_taxon_of_target(cur[0])
        out.append(f"{tax.name}:{count},")
    return "".join(out)


def show_candidate_ranges(sketching, candidates) -> str:
    """Reference: show_candidate_ranges (src/printing.cpp:369-380)."""
    w = sketching.winstride
    return "".join(
        f"[{w * beg},{w * end + sketching.winlen}] "
        for (_tax, _tgt, _hits, beg, end) in candidates)


# ---------------------------------------------------------------------------
def show_query_mapping_header(opt) -> str:
    """Reference: show_query_mapping_header (src/classification.cpp:435-463).

    `opt` carries .format (OutputFormatting), .show_ground_truth,
    .show_all_hits, .show_top_hits, .show_locations.
    """
    fmt = opt.format
    if fmt.map_view_mode == MapViewMode.NONE:
        return ""
    colsep = fmt.tokens.column
    out = [fmt.tokens.comment + "TABLE_LAYOUT: "]
    if fmt.show_query_ids:
        out.append("query_id" + colsep)
    out.append("query_header" + colsep)
    if opt.show_ground_truth:
        out.append(show_taxon_header(fmt, "truth_") + colsep)
    if opt.show_all_hits:
        out.append("all_hits" + colsep)
    if opt.show_top_hits:
        out.append("top_hits" + colsep)
    if opt.show_locations:
        out.append("candidate_locations" + colsep)
    out.append(show_taxon_header(fmt))
    return "".join(out) + "\n"


def show_query_mapping(taxonomy: TaxonomyCache, opt, sketching,
                       query_id: int, header: str,
                       best: Optional[Taxon], ground_truth: Optional[Taxon],
                       candidates, allhits, align_text: str = "") -> str:
    """One mapping row (reference: show_query_mapping,
    src/classification.cpp:470-533). Returns "" when suppressed."""
    fmt = opt.format
    if fmt.map_view_mode == MapViewMode.NONE or \
            (fmt.map_view_mode == MapViewMode.MAPPED_ONLY and best is None):
        return ""
    colsep = fmt.tokens.column
    out = []
    if fmt.show_query_ids:
        out.append(f"{query_id}{colsep}")
    out.append(header.split(" ", 1)[0] + colsep)
    if opt.show_ground_truth:
        out.append(show_taxon(taxonomy, fmt, ground_truth) + colsep)
    if opt.show_all_hits:
        out.append(show_matches(taxonomy, allhits, fmt.lowest_rank) + colsep)
    if opt.show_top_hits:
        out.append(show_candidates(taxonomy, candidates, fmt.lowest_rank) +
                   colsep)
    if opt.show_locations:
        out.append(show_candidate_ranges(sketching, candidates) + colsep)
    out.append(show_taxon(taxonomy, fmt, best))
    if align_text and best is not None:
        out.append(align_text)
    return "".join(out) + "\n"


# ---------------------------------------------------------------------------
class MappingLineWriter:
    """Memoizing fast path for per-read mapping rows.

    Byte-identical to show_query_mapping: the taxon columns depend only
    on the taxon id and the tophits entry prefix only on (target,
    taxon id), so both are computed once per distinct value and reused
    across the whole run (a metagenomic sample hits a few thousand taxa
    across millions of reads). Rare columns (allhits, locations,
    alignment) delegate to the general helpers.

    Reference: show_query_mapping (src/classification.cpp:470-533) —
    the reference pays the formatting cost per read on 128 threads; we
    amortize it instead.
    """

    def __init__(self, taxonomy: TaxonomyCache, opt, sketching):
        self.taxonomy = taxonomy
        self.opt = opt
        self.sketching = sketching
        fmt = opt.format
        self.fmt = fmt
        self.suppressed = fmt.map_view_mode == MapViewMode.NONE
        self.mapped_only = fmt.map_view_mode == MapViewMode.MAPPED_ONLY
        self.colsep = fmt.tokens.column
        self.show_query_ids = fmt.show_query_ids
        self.show_gt = opt.show_ground_truth
        self.show_allhits = opt.show_all_hits
        self.show_tophits = opt.show_top_hits
        self.show_locations = opt.show_locations
        self.lowest = fmt.lowest_rank
        self.seq_level = fmt.lowest_rank == Rank.SEQUENCE
        self._taxstr: dict = {}    # taxid|None -> final-column string
        self._candstr: dict = {}   # (tgt, taxid) -> tophits entry prefix
        # native-formatter string table (indices shipped to C)
        self._tab_chunks: list = []
        self._tab_off: list = [0]
        self._tab_dirty = True
        self._strtab = b""
        self._stroff = None
        self._best_sidx: dict = {}   # cls taxid -> string idx
        self._cand_sidx: dict = {}   # (tgt<<32)|tax key -> (idx, flag)

    def taxon_str(self, tax: Optional[Taxon]) -> str:
        key = tax.id if tax is not None else None
        s = self._taxstr.get(key)
        if s is None:
            s = show_taxon(self.taxonomy, self.fmt, tax)
            self._taxstr[key] = s
        return s

    def _cand_prefix(self, tax: Optional[Taxon], tgt: int) -> str:
        # mirrors one show_candidates entry sans the ":hits" suffix
        key = (tgt, tax.id if tax is not None else None)
        s = self._candstr.get(key)
        if s is None:
            t = tax
            if tax is not None and tax.rank < self.lowest:
                t = self.taxonomy.lowest_ranked_ancestor(tgt, self.lowest)
            s = str(t.id) if t is not None else tax.name
            self._candstr[key] = s
        return s

    def tophits_str(self, candidates) -> str:
        parts = []
        for (tax, tgt, hits, *_rest) in candidates:
            if hits <= 0:
                break
            if self.seq_level:
                parts.append(f"{tax.name}:{hits}" if tax is not None
                             else "")
            else:
                parts.append(f"{self._cand_prefix(tax, tgt)}:{hits}")
        return ",".join(parts)

    def _add_str(self, s: str) -> int:
        b = s.encode()
        self._tab_chunks.append(b)
        self._tab_off.append(self._tab_off[-1] + len(b))
        self._tab_dirty = True
        return len(self._tab_chunks) - 1

    def lines_batch(self, raw_hdrs, cand_tgt, cand_tax, cand_hits,
                    cls_tax, qid0: int, find):
        """Whole-batch mapping rows through the native C formatter.

        Byte-identical to mapping line() over the batch for the hot
        flag combination (tophits/plain columns; no gt/allhits/
        locations/alignment — the caller guards those). Taxon and
        candidate strings resolve once per DISTINCT value via np.unique
        + the same memo dicts line() uses; the C loop only concatenates.
        Returns utf-8 bytes or None (native lib missing / unhandled
        edge -> caller falls back to the per-read path)."""
        import numpy as np

        from .. import native
        if native.get_lib() is None or self.suppressed:
            return None
        n, k = cand_tgt.shape

        u, inv = np.unique(cls_tax, return_inverse=True)
        us = np.empty(len(u), np.int32)
        unone = np.zeros(len(u), bool)
        for j, ci in enumerate(u.tolist()):
            memo = self._best_sidx.get(ci)
            if memo is None:
                tax = find(ci) if ci != 0 else None
                memo = (self._add_str(self.taxon_str(tax)), tax is None)
                self._best_sidx[ci] = memo
            us[j], unone[j] = memo
        best_sidx = us[inv]
        skip = unone[inv].astype(np.uint8) if self.mapped_only else None

        if self.show_tophits:
            valid = (cand_tgt >= 0) & (cand_hits > 0)
            key = ((cand_tgt.astype(np.int64) << 32) |
                   (cand_tax.astype(np.int64) & 0xFFFFFFFF))
            key = np.where(valid, key, -1)
            uk, kinv = np.unique(key, return_inverse=True)
            uks = np.empty(len(uk), np.int32)
            ukf = np.zeros(len(uk), np.uint8)
            for j, kv in enumerate(uk.tolist()):
                if kv < 0:
                    uks[j] = -1
                    continue
                memo = self._cand_sidx.get(kv)
                if memo is None:
                    taxid = kv & 0xFFFFFFFF
                    if taxid >= 1 << 31:
                        taxid -= 1 << 32
                    tax = find(taxid)
                    if self.seq_level:
                        s, fl = ("", 1) if tax is None else (tax.name, 0)
                    else:
                        if tax is None:       # line() would raise here;
                            return None       # keep parity via fallback
                        s, fl = self._cand_prefix(tax, kv >> 32), 0
                    memo = (self._add_str(s), fl)
                    self._cand_sidx[kv] = memo
                uks[j], ukf[j] = memo
            cand_sidx = uks[kinv].reshape(n, k)
            cand_flag = ukf[kinv].reshape(n, k)
        else:
            cand_sidx = np.full((n, 1), -1, np.int32)
            cand_flag = np.zeros((n, 1), np.uint8)
            cand_hits = np.zeros((n, 1), np.int32)

        if self._tab_dirty:
            self._strtab = b"".join(self._tab_chunks)
            self._stroff = np.asarray(self._tab_off, np.int64)
            self._tab_dirty = False
        return native.format_map_lines(
            raw_hdrs, qid0 if self.show_query_ids else -1,
            best_sidx, skip, cand_sidx, cand_flag, cand_hits,
            self.show_tophits, self._strtab, self._stroff,
            self.colsep.encode())

    def line(self, query_id: int, header: str, best: Optional[Taxon],
             ground_truth: Optional[Taxon], candidates, allhits,
             align_text: str = "") -> str:
        if self.suppressed or (self.mapped_only and best is None):
            return ""
        colsep = self.colsep
        out = []
        if self.show_query_ids:
            out.append(f"{query_id}{colsep}")
        out.append(header.split(" ", 1)[0])
        out.append(colsep)
        if self.show_gt:
            out.append(self.taxon_str(ground_truth))
            out.append(colsep)
        if self.show_allhits:
            out.append(show_matches(self.taxonomy, allhits, self.lowest))
            out.append(colsep)
        if self.show_tophits:
            out.append(self.tophits_str(candidates))
            out.append(colsep)
        if self.show_locations:
            out.append(show_candidate_ranges(self.sketching, candidates))
            out.append(colsep)
        out.append(self.taxon_str(best))
        if align_text and best is not None:
            out.append(align_text)
        out.append("\n")
        return "".join(out)


# ---------------------------------------------------------------------------
def show_matches_per_targets(taxonomy: TaxonomyCache, sketching,
                             tgt_matches, fmt: OutputFormatting) -> str:
    """Reference: show_matches_per_targets (src/printing.cpp:385-420).

    tgt_matches: dict target_id -> list of (qid, beg, end, hits), sorted.
    """
    t = fmt.tokens
    out = [
        f"{t.comment}--- list of hits for each reference sequence ---\n",
        f"{t.comment}window start position within sequence = "
        f"window_index * window_stride(={sketching.winstride})\n",
        f"{t.comment}TABLE_LAYOUT:  sequence {t.column} windows_in_sequence "
        f"{t.column}queryid/first_window_index+additional_windows:hits,"
        f"queryid/...\n",
    ]
    rmin = Rank.SEQUENCE
    rmax = fmt.highest_rank if fmt.show_lineage else rmin
    for tgt, cands in tgt_matches.items():
        tax = taxonomy.cached_taxon_of_target(tgt)
        out.append(show_lineage(taxonomy.cached_ranks_of_target(tgt),
                                fmt.style, rmin, rmax, t))
        out.append(f"{t.column}{tax.source.windows}{t.column}")
        out.append(",".join(
            f"{qid}/{beg}+{end - beg}:{hits}"
            for (qid, beg, end, hits) in cands))
        out.append("\n")
    return "".join(out)


def show_abundance_table(tax_counts, statistics, fmt: OutputFormatting
                         ) -> str:
    """Reference: show_abundance_table (src/printing.cpp:425-470).

    tax_counts: ordered list of (taxon, count) in rank-desc/id-asc order.
    """
    t = fmt.tokens
    out = [f"{t.comment}rank{t.rank_suffix}name{t.column}taxid{t.column}"
           f"number of reads{t.column}abundance\n"]
    total = statistics.total()
    for tax, count in tax_counts:
        if tax is not None:
            out.append(f"{tax.rank_name()}{t.rank_suffix}{tax.name}"
                       f"{t.column}")
            out.append(str(tax.parent_id if tax.rank == Rank.SEQUENCE
                           else tax.id))
        else:
            out.append("none")
        out.append(t.column)
        if float(count).is_integer():
            out.append(cpp_num(float(count)))
        else:
            out.append(cpp_num(float(count), 15))
        pct = count / total * 100 if total else 0.0
        out.append(f"{t.column}{cpp_num(pct)}%\n")
    out.append(f"unclassified{t.column}--{t.column}0{t.column}"
               f"{statistics.unassigned()}{t.column}"
               f"{cpp_num(statistics.unclassified_rate() * 100)}%\n")
    return "".join(out)


def show_abundances(tax_counts, statistics, fmt: OutputFormatting) -> str:
    return (fmt.tokens.comment +
            "query summary: number of queries mapped per taxon\n" +
            show_abundance_table(tax_counts, statistics, fmt))


def show_abundance_estimates(rank: Rank, tax_counts, statistics,
                             fmt: OutputFormatting) -> str:
    return (fmt.tokens.comment +
            f"estimated abundance (number of queries) per {rank_name(rank)}\n"
            + show_abundance_table(tax_counts, statistics, fmt))


# ---------------------------------------------------------------------------
_SUMMARY_RANKS = (Rank.SEQUENCE, Rank.SUBSPECIES, Rank.SPECIES, Rank.GENUS,
                  Rank.FAMILY, Rank.ORDER, Rank.CLASS, Rank.PHYLUM,
                  Rank.KINGDOM, Rank.DOMAIN, Rank.ROOT)


def show_taxon_statistics(stats, prefix: str) -> str:
    """Reference: show_taxon_statistics (src/printing.cpp:475-596)."""
    out = []
    if stats.assigned() < 1:
        return "None of the input sequences could be classified.\n"
    if stats.unassigned() > 0:
        out.append(f"{prefix}unclassified: "
                   f"{cpp_num(100 * stats.unclassified_rate())}% "
                   f"({stats.unassigned()})\n")
    out.append(f"{prefix}classified:\n")

    def rn(r):
        return rank_name(r).ljust(11)[:11] if len(rank_name(r)) < 11 \
            else rank_name(r)

    for r in _SUMMARY_RANKS:
        if stats.assigned(r) > 0:
            out.append(f"{prefix}  {rn(r)}"
                       f"{cpp_num(100 * stats.classification_rate(r))}% "
                       f"({stats.assigned(r)})\n")
    if stats.known() > 0:
        if stats.unknown() > 0:
            out.append(f"{prefix}ground truth unknown: "
                       f"{cpp_num(100 * stats.unknown_rate())}% "
                       f"({stats.unknown()})\n")
        out.append(f"{prefix}ground truth known:\n")
        for r in _SUMMARY_RANKS:
            if stats.assigned(r) > 0:
                out.append(f"{prefix}  {rn(r)}"
                           f"{cpp_num(100 * stats.known_rate(r))}% "
                           f"({stats.known(r)})\n")
        out.append(f"{prefix}correctly classified:\n")
        for r in _SUMMARY_RANKS:
            if stats.assigned(r) > 0:
                out.append(f"{prefix}  {rn(r)}{stats.correct(r)}\n")
        out.append(f"{prefix}precision (correctly classified / classified) "
                   "if ground truth known:\n")
        for r in _SUMMARY_RANKS:
            if stats.assigned(r) > 0:
                out.append(f"{prefix}  {rn(r)}"
                           f"{cpp_num(100 * stats.precision_(r))}%\n")
        out.append(f"{prefix}sensitivity (correctly classified / all) "
                   "if ground truth known:\n")
        for r in _SUMMARY_RANKS:
            if stats.assigned(r) > 0:
                out.append(f"{prefix}  {rn(r)}"
                           f"{cpp_num(100 * stats.sensitivity(r))}%\n")
        if stats.coverage(Rank.DOMAIN).total() > 0:
            out.append(f"{prefix}false positives (hit on taxa not covered "
                       "in DB):\n")
            for r in _SUMMARY_RANKS:
                if stats.assigned(r) > 0:
                    out.append(f"{prefix}  {rn(r)}"
                               f"{stats.coverage(r).fp}\n")
    return "".join(out)


def show_query_parameters(opt, pairing, num_threads: int,
                          min_read_length: int = 0,
                          max_read_length: int = 0) -> str:
    """Reference: show_query_parameters (src/printing.cpp:47-125).

    `opt` is an OutputOptions-like object with .format, .analysis,
    .evaluate; classification thresholds ride on opt.classify_resolved =
    (lowest, highest, hits_min, max_candidates, insert_size_max).
    """
    fmt = opt.format
    c = fmt.tokens.comment
    (lowest, highest, hits_min, max_cand, insert_size_max) = \
        opt.classify_resolved
    out = []
    if fmt.map_view_mode != MapViewMode.NONE:
        out.append(f"{c}Reporting per-read mappings (non-mapping lines "
                   f"start with '{c}').\n")
        if fmt.show_lineage:
            out.append(f"{c}The complete lineage will be reported "
                       "starting with the lowest match.\n")
        else:
            out.append(f"{c}Only the lowest matching rank will be "
                       "reported.\n")
    else:
        out.append(f"{c}Per-Read mappings will not be shown.\n")
    if min_read_length > 0:
        out.append(f"{c}Only reads with a minimum length of "
                   f"{min_read_length} bp will be mapped.\n")
    if max_read_length > 0:
        out.append(f"{c}Only reads with a maximum length of "
                   f"{max_read_length} bp will be mapped.\n")
    out.append(f"{c}Classification will be constrained to ranks from '"
               f"{rank_name(lowest)}' to '{rank_name(highest)}'.\n")
    out.append(f"{c}Classification hit threshold is {hits_min} "
               "per query\n")
    out.append(f"{c}At maximum {max_cand} classification candidates will "
               "be considered per query.\n")
    from ..seqio.reader import PairingMode
    if pairing == PairingMode.FILES:
        out.append(f"{c}File based paired-end mode:\n")
        out.append(f"{c}  Reads from two consecutive files will be "
                   "interleaved.\n")
        out.append(f"{c}  Max insert size considered {insert_size_max}.\n")
    elif pairing == PairingMode.SEQUENCES:
        out.append(f"{c}Per file paired-end mode:\n")
        out.append(f"{c}  Reads from two consecutive sequences in each "
                   "file will be paired up.\n")
        out.append(f"{c}  Max insert size considered {insert_size_max}.\n")
    ana = opt.analysis
    if ana.show_alignment:
        out.append(f"{c}Query sequences will be aligned to best "
                   "candidate target => SLOW!\n")
    if ana.show_hits_per_target:
        out.append(f"{c}A list of hits per reference sequence will be "
                   "generated after the read mapping.\n")
    if ana.show_tax_abundances:
        out.append(f"{c}A list of absolute and relative abundances per "
                   "taxon will be generated after the read mapping.\n")
    if ana.abundance_per != Rank.NONE:
        out.append(f"{c}A list of absolute and relative abundances for "
                   f"each '{rank_name(ana.abundance_per)}' will be "
                   "generated after the read mapping.\n")
    out.append(f"{c}Using {num_threads} threads\n")
    return "".join(out)


def show_summary(stats, num_queries: int, time_ms: float,
                 comment: str = "# ") -> str:
    """Reference: show_summary (src/printing.cpp:602-624)."""
    minutes = time_ms / 60000.0
    speed = num_queries / minutes if minutes > 0 else 0.0
    out = [f"{comment}queries: {num_queries}\n",
           f"{comment}time:    {int(time_ms)} ms\n",
           f"{comment}speed:   {cpp_num(speed)} queries/min\n"]
    if stats.total() > 0:
        out.append(show_taxon_statistics(stats, comment))
    else:
        out.append(f"{comment}No valid query sequences found.\n")
    return "".join(out)
