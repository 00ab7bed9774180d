# copied from metacache_tpu/cli/info.py
"""Info mode (reference: src/mode_info.cpp:140-287).

Output layouts are byte-compatible with the reference binary's
(print_static_properties / print_content_properties / print_query_config,
src/printing.cpp:625-698 and src/mode_info.cpp:30-240) so downstream
tooling that parses `metacache info` keeps working; the golden test
consumes tests/data/golden/info_basic.txt captured from the reference.
The type-name strings mirror the reference's default type configuration
(src/config.hpp:45-157) — this framework's u32 feature/target/window
types correspond exactly.

Exception: featuremap/featurecounts are emitted in ascending feature
order; the reference iterates its hash table in bucket order
(src/host_hashmap.hpp:413-445), which is not stable across table sizes,
so there is no canonical byte order to match.
"""
from __future__ import annotations

import sys

SEP = "------------------------------------------------"
MC_VERSION = 20260121        # reference: src/version.hpp:27
MC_VERSION_STRING = "2.6.0"  # reference: src/version.hpp:31
MC_DB_VERSION = 20200820     # reference: src/version.hpp:29

_CLASSIFIER = "mc::best_distinct_matches_in_contiguous_window_ranges"
U32_MAX = 4294967295


def _print_static_properties(sk, max_loc: int, out):
    """Reference: print_static_properties (src/printing.cpp:625-658).

    Type strings follow the feature width: k <= 16 is the u32 config,
    k > 16 the -DMC_KMER_TYPE=uint64_t config (src/config.hpp:45-60)."""
    wide = sk.kmerlen > 16
    ctype = "unsigned long" if wide else "unsigned int"
    cbits = 64 if wide else 32
    sketcher = (f"mc::single_function_unique_min_hasher<{ctype}, "
                f"mc::same_size_hash<{ctype}> >")
    out.write(
        f"{SEP}\n"
        f"MetaCache version  {MC_VERSION_STRING} ({MC_VERSION})\n"
        f"database version   {MC_DB_VERSION}\n"
        f"{SEP}\n"
        f"sequence type      mc::char_sequence\n"
        f"target id type     unsigned int 32 bits\n"
        f"target limit       {U32_MAX}\n"
        f"{SEP}\n"
        f"window id type     unsigned int 32 bits\n"
        f"window limit       {U32_MAX}\n"
        f"window length      {sk.winlen}\n"
        f"window stride      {sk.winstride}\n"
        f"{SEP}\n"
        f"sketcher type      {sketcher}\n"
        f"feature type       {ctype}{' int' if wide else ''} "
        f"{cbits} bits\n"
        f"feature hash       mc::same_size_hash<{ctype}>\n"
        f"kmer size          {sk.kmerlen}\n"
        f"kmer limit         {32 if wide else 16}\n"
        f"sketch size        {sk.sketchlen}\n"
        f"{SEP}\n"
        f"bucket size type   unsigned char 8 bits\n"
        f"max. locations     {max_loc}\n"
        f"location limit     254\n"
        f"{SEP}\n")


def _print_query_config(out):
    """Reference: print_query_config (src/mode_info.cpp:46-50)."""
    out.write(f"hit classifier       {_CLASSIFIER}\n{SEP}\n")


def _print_content_properties(db, out):
    """Reference: print_content_properties (src/printing.cpp:662-698)."""
    from ..classify.output import cpp_num as cpp_g
    out.write(f"{SEP}\n"
              f"database parts     {max(len(db.parts), 1)}\n")
    if db.target_count > 0:
        db.taxa.update()
        ranked = sum(1 for t in db.taxa.taxonomy.targets.values()
                     if t.parent_id != 0)
        out.write(f"targets            {db.target_count}\n"
                  f"ranked targets     {ranked}\n"
                  f"taxa in tree       {len(db.taxa.taxonomy.taxa)}\n")
    if db.feature_count > 0:
        import numpy as np

        from ..utils.moments import StatisticsAccumulator
        sizes = np.concatenate([p.bucket_sizes() for p in db.parts]) \
            if db.parts else np.zeros(0, np.int64)
        s = sizes.astype(np.float64)
        acc = StatisticsAccumulator()
        acc.push_array(s)
        mean = acc.mean() if len(s) else 0.0
        std = acc.stddev() if len(s) else 0.0
        # degenerate distributions: the reference's skewness is 0/0,
        # printed "-nan" (stat_moments.hpp skewness, IEEE semantics)
        skew_v = acc.skewness()
        skew = cpp_g(skew_v) if len(s) and skew_v == skew_v else "-nan"
        if len(db.parts) > 1:
            out.write(f"{SEP}\ncomplete database (all parts):\n")
        out.write(f"buckets            {db.feature_count}\n"
                  f"bucket size        max: {int(s.max()) if len(s) else 0}"
                  f" mean: {cpp_g(mean)} +/- {cpp_g(std)}"
                  f" <> {skew}\n"
                  f"features           {db.feature_count}\n"
                  f"dead features      0\n"
                  f"locations          {db.location_count}\n")
    out.write(f"{SEP}\n")


def _show_target(db, tax, out):
    """Reference: show_target_info (src/mode_info.cpp:111-128)."""
    from ..taxonomy.model import rank_name
    src = tax.source
    out.write(f"Target {tax.name}):\n"
              f"    source:     {src.filename} / {src.index}\n"
              f"    length:     {src.windows} windows")
    tgt = -tax.id - 1
    for t in db.taxa.cached_ranks_of_target(tgt):
        if t is not None:
            rn = (rank_name(t.rank) + ":").ljust(12)
            out.write(f"\n    {rn}({t.id}) {t.name}")
    out.write("\n")


def show_info(argv) -> int:
    from ..db.database import Database
    from ..taxonomy.model import NUM_RANKS, Rank, rank_from_name, rank_name

    out = sys.stdout
    if not argv:
        # reference: show_basic_exec_info (src/mode_info.cpp:240-247)
        # prints the DEFAULT-constructed database's properties
        from ..config import SketchingOptions
        _print_static_properties(SketchingOptions().resolved(), 254, out)
        _print_query_config(out)
        out.write("\n")
        return 0
    dbfile = argv[0]
    what = argv[1] if len(argv) > 1 else "config"
    metadata_only = what in ("config", "targets", "lineages", "rank")
    db = Database.load(dbfile, metadata_only=metadata_only)

    if what == "config":
        _print_static_properties(db.sketching,
                                 db.max_locations_per_feature, out)
        _print_query_config(out)
        out.write(f"database parts       {max(len(db.parts), 1)}\n{SEP}\n")
    elif what == "statistics":
        _print_static_properties(db.sketching,
                                 db.max_locations_per_feature, out)
        _print_content_properties(db, out)
    elif what == "targets":
        db.taxa.update()
        names = argv[2:]
        if names:
            for name in names:
                tax = db.taxa.taxon_with_name(name)
                if tax is not None and tax.id < 0:
                    _show_target(db, tax, out)
                else:
                    out.write(f"Target (reference sequence) '{name}'"
                              " not found in database.\n")
        else:
            out.write("Targets (reference sequences) in database:\n")
            for tid in range(db.target_count):
                tax = db.taxa.cached_taxon_of_target(tid)
                if tax is not None:
                    _show_target(db, tax, out)
    elif what == "lineages":
        # reference: show_lineage_table (src/mode_info.cpp:163-188)
        db.taxa.update()
        if db.target_count < 1:
            return 0
        out.write("name")
        for r in range(NUM_RANKS):
            out.write("\t" + rank_name(Rank(r)))
        out.write("\n")
        for tid in range(db.target_count):
            tax = db.taxa.cached_taxon_of_target(tid)
            lin = db.taxa.cached_ranks_of_target(tid)
            out.write(tax.name)
            for r in range(NUM_RANKS):
                out.write(f"\t{lin[r].id if lin[r] is not None else 0}")
            out.write("\n")
    elif what == "rank":
        # reference: show_rank_statistics (src/mode_info.cpp:196-234)
        if len(argv) < 3:
            print("Please specify a taxonomic rank:", file=sys.stderr)
            for r in range(NUM_RANKS):
                print(f"    {rank_name(Rank(r))}", file=sys.stderr)
            return 0
        rank = rank_from_name(argv[2])
        db.taxa.update()
        stat: dict = {}
        for tid in range(db.target_count):
            lin = db.taxa.cached_ranks_of_target(tid)
            t = lin[int(rank)]
            if t is not None:
                stat[t] = stat.get(t, 0) + 1
        out.write(f"Sequence distribution for rank "
                  f"'{rank_name(rank)}':\n"
                  "taxid \t taxon_name \t sequences\n")
        for t in sorted(stat, key=lambda x: x.id):
            out.write(f"{t.id} \t {t.name} \t {stat[t]}\n")
    elif what == "featuremap":
        _print_static_properties(db.sketching,
                                 db.max_locations_per_feature, out)
        _print_content_properties(db, out)
        out.write("===================================================\n")
        from ..ops.table import unpack_locations
        for i, p in enumerate(db.parts):
            if len(db.parts) > 1:
                out.write(f"database part {i + 1}:\n")
            tgts, wins = unpack_locations(p.locations)
            for j in range(p.num_features):
                lo, hi = p.offsets[j], p.offsets[j + 1]
                locs = "".join(f"({tgts[x]},{wins[x]})"
                               for x in range(lo, hi))
                out.write(f"{p.unique_features[j]} -> {locs}\n")
        out.write("===================================================\n")
    elif what == "featurecounts":
        _print_static_properties(db.sketching,
                                 db.max_locations_per_feature, out)
        _print_content_properties(db, out)
        out.write("===================================================\n")
        for i, p in enumerate(db.parts):
            if len(db.parts) > 1:
                out.write(f"database part {i + 1}:\n")
            for f, s in zip(p.unique_features, p.bucket_sizes()):
                out.write(f"{f} -> {s}\n")
        out.write("===================================================\n")
    else:
        print(f"info: unknown submode '{what}' (expected targets, "
              "lineages, rank, statistics, featuremap or featurecounts)",
              file=sys.stderr)
        return 1
    return 0
