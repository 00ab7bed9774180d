"""Command-line interface of the port: build, modify, query, build+query,
merge, info, help.

Same flags as metacache_tpu's CLI (and the reference binary): the flag
parser and the mode functions are copied from metacache_tpu/cli/main.py
onto the port's database and runner.
"""
from __future__ import annotations

import os
import sys
from typing import List

from .. import __version__
from ..config import SketchingOptions
from ..seqio.reader import PairingMode
from ..taxonomy.model import Rank, rank_from_name
from .help import MODES


# copied from metacache_tpu/cli/main.py:19-124 (the flag parser)
class CliError(RuntimeError):
    pass


class Args:
    """Sequential flag consumer over reference-style args."""

    def __init__(self, argv: List[str]):
        self.argv = list(argv)

    def take_flag(self, *names) -> bool:
        for n in names:
            if n in self.argv:
                self.argv.remove(n)
                return True
        return False

    def take_value(self, *names, default=None):
        for n in names:
            if n in self.argv:
                i = self.argv.index(n)
                if i + 1 >= len(self.argv):
                    raise CliError(f"missing value after '{n}'")
                v = self.argv[i + 1]
                del self.argv[i:i + 2]
                return v
        return default

    def take_optional_value(self, *names, default=None, missing=""):
        """Flag with optional value (e.g. -abundances [<file>])."""
        for n in names:
            if n in self.argv:
                i = self.argv.index(n)
                if i + 1 < len(self.argv) and \
                        not self.argv[i + 1].startswith("-"):
                    v = self.argv[i + 1]
                    del self.argv[i:i + 2]
                    return v
                del self.argv[i]
                return missing
        return default

    def take_values(self, *names) -> list[str]:
        """Flag followed by one or more non-flag values."""
        out = []
        for n in names:
            while n in self.argv:
                i = self.argv.index(n)
                del self.argv[i]
                while i < len(self.argv) and \
                        not self.argv[i].startswith("-"):
                    out.append(self.argv.pop(i))
        return out

    def positionals(self) -> list[str]:
        bad = [a for a in self.argv if a.startswith("-")]
        if bad:
            raise CliError(f"unknown option(s): {' '.join(bad)}")
        return self.argv


def _apply_info_level(a: Args) -> None:
    """-silent / -verbose -> status verbosity (reference: info_level_cli,
    src/options.cpp + io_options.hpp:27-33)."""
    from ..utils import info as info_mod
    if a.take_flag("-silent"):
        info_mod.set_level(info_mod.SILENT)
    if a.take_flag("-verbose"):
        info_mod.set_level(info_mod.VERBOSE)
    if a.take_flag("-no-info", "-noinfo"):
        info_mod.set_level(info_mod.SILENT)
    if a.take_flag("-no-err", "-noerr", "-no-errors"):
        info_mod.set_show_errors(False)


def _parse_rank(s: str) -> Rank:
    r = rank_from_name(s)
    if r == Rank.NONE and s.strip().lower() not in ("none",):
        raise CliError(f"unknown taxonomic rank '{s}'")
    return r


def _check_kmerlen(k: int) -> int:
    """k <= 16 uses the 32-bit kmer/feature config (the reference's
    default MC_KMER_TYPE=uint32_t); 17 <= k <= 32 switches to the
    64-bit config (the reference's -DMC_KMER_TYPE=uint64_t build,
    src/config.hpp:45-60) with u64 features end-to-end."""
    if k > 32 or k < 1:
        raise CliError(
            f"-kmerlen {k} is not supported: the kmer length must be "
            "between 1 and 32 (k > 16 uses 64-bit kmers)")
    return k


def _parse_sketching(a: Args) -> SketchingOptions | None:
    k = a.take_value("-kmerlen")
    s = a.take_value("-sketchlen")
    w = a.take_value("-winlen")
    st = a.take_value("-winstride")
    if k is None and s is None and w is None and st is None:
        return None
    return SketchingOptions(
        kmerlen=_check_kmerlen(int(k)) if k else 16,
        sketchlen=int(s) if s else 0,
        winlen=int(w) if w else 0,
        winstride=int(st) if st else 0)


# copied from metacache_tpu/cli/main.py:486-488

def _expand(paths):
    from ..db.build import expand_input_paths
    return expand_input_paths(paths)


# copied from metacache_tpu/cli/main.py:128-219
def mode_build(argv: List[str], modify: bool = False) -> int:
    from ..db.build import BuildOptions, build_database
    from ..db.database import Database
    from ..seqio.ids import SequenceIdType
    from ..utils import info as info_mod

    a = Args(argv)
    opt = BuildOptions()
    opt.taxonomy_dir = a.take_value("-taxonomy", default="")
    opt.taxpostmap = a.take_values("-taxpostmap")
    sk = a.take_value("-sketchlen")
    km = a.take_value("-kmerlen")
    wl = a.take_value("-winlen")
    ws = a.take_value("-winstride")
    base = SketchingOptions()
    opt.sketching = SketchingOptions(
        kmerlen=_check_kmerlen(int(km)) if km else base.kmerlen,
        sketchlen=int(sk) if sk else base.sketchlen,
        winlen=int(wl) if wl else base.winlen,
        winstride=int(ws) if ws else 0)
    v = a.take_value("-max-locations-per-feature")
    if v:
        opt.max_locations_per_feature = int(v)
    opt.remove_overpopulated_features = a.take_flag(
        "-remove-overpopulated-features")
    v = a.take_value("-max-ambig-per-feature")
    if v:
        opt.max_ambig_per_feature = int(v)
    if a.take_flag("-remove-ambig-features"):
        if opt.max_ambig_per_feature < 1:
            opt.max_ambig_per_feature = 1
    v = a.take_value("-ambig-rank")
    if v:
        opt.ambig_rank = _parse_rank(v)
    v = a.take_value("-parts")
    if v:
        opt.parts = int(v)
    v = a.take_value("-max-part-size")
    if v:
        opt.max_part_bytes = int(float(v) * (1 << 30))
    a.take_value("-max-load-fac", "-max-load-factor")
    v = a.take_value("-threads")
    if v:
        opt.num_threads = max(1, int(v))
    _apply_info_level(a)
    opt.reset_parents = a.take_flag("-reset-taxa", "-reset-parents")
    ref_format = a.take_flag("-ref-format", "-reference-format")
    v = a.take_value("-sequence-id-format")
    if v:
        opt.seq_id_type = SequenceIdType(v.replace("-", "_"))

    pos = a.positionals()
    if not pos:
        raise CliError("database filename missing")
    opt.dbfile = pos[0]
    opt.infiles = pos[1:]
    # on-card table construction whenever eligible (single part, no
    # culls, 32-bit features: build_database gates); save() exports the
    # tables as CSR
    opt.device_tables = True
    if modify:
        # incremental build resume (reference: mode_build.cpp:74-87)
        db = Database.load(opt.dbfile)
        opt.sketching = db.sketching  # sketching is fixed by the database
        if opt.reset_parents:
            for t in db.taxa.target_taxa:
                if t is not None:
                    t.parent_id = 0
            db.taxa._outdated = True
    else:
        db = Database(opt.sketching)
    db = build_database(opt, db)
    if ref_format:
        # the reference MetaCache binary format (src/database.cpp:247-325)
        from ..db.mcformat import save_reference_db
        save_reference_db(db, opt.dbfile)
    else:
        db.save(opt.dbfile)
    info_mod.status(f"Database saved to {opt.dbfile}")
    return 0


# copied from metacache_tpu/cli/main.py:223-369
def parse_query_options(a: Args):
    from ..classify.options import QueryOptions
    from ..classify.output import MapViewMode

    opt = QueryOptions()
    o = opt.output
    fmt = o.format

    opt.sketching = _parse_sketching(a)
    cl = opt.classify
    v = a.take_value("-lowest")
    if v:
        cl.lowest_rank = v
    v = a.take_value("-highest")
    if v:
        cl.highest_rank = v
    v = a.take_value("-hitmin", "-hit-min", "-hits-min", "-hitsmin")
    if v:
        cl.hits_min = int(v)
    v = a.take_value("-hitdiff", "-hit-diff", "-hits-diff", "-hitsdiff")
    if v:
        cl.hits_diff_fraction = float(v) / 100.0
    v = a.take_value("-maxcand", "-max-cand")
    if v:
        cl.max_candidates = int(v)
    v = a.take_value("-insertsize", "-insert-size")
    if v:
        cl.insert_size_max = int(v)
    v = a.take_value("-cov-percentile")
    if v:
        cl.cov_percentile = float(v) / 100.0

    if a.take_flag("-pairfiles", "-pair-files", "-paired-files"):
        opt.pairing = PairingMode.FILES
    if a.take_flag("-pairseq", "-pair-seq", "-paired-seq",
                   "-paired-sequences"):
        opt.pairing = PairingMode.SEQUENCES

    if a.take_flag("-no-map", "-nomap"):
        fmt.map_view_mode = MapViewMode.NONE
    if a.take_flag("-mapped-only", "-mappedonly"):
        fmt.map_view_mode = MapViewMode.MAPPED_ONLY
    if a.take_flag("-taxids", "-taxid"):
        fmt.style.show_id = True
    if a.take_flag("-taxids-only", "-taxidsonly"):
        fmt.style.show_id = True
        fmt.style.show_name = False
    if a.take_flag("-omit-ranks", "-omitranks"):
        fmt.style.show_rank_name = False
    if a.take_flag("-separate-cols", "-separatecols"):
        fmt.use_separate_cols = True
    if a.take_flag("-lineage", "-lineages"):
        fmt.show_lineage = True
    if a.take_flag("-queryids", "-query-ids"):
        fmt.show_query_ids = True
    v = a.take_value("-separator")
    if v:
        fmt.tokens.column = v
    v = a.take_value("-comment")
    if v:
        fmt.tokens.comment = v

    ana = o.analysis
    if a.take_flag("-tophits", "-top-hits"):
        ana.show_top_hits = True
    if a.take_flag("-allhits", "-all-hits"):
        ana.show_all_hits = True
    if a.take_flag("-locations"):
        ana.show_locations = True
        ana.show_top_hits = True
    if a.take_flag("-align", "-alignment"):
        ana.show_alignment = True
    v = a.take_optional_value("-hits-per-ref", "-hits-per-seq",
                              "-hits-per-tgt", "-hits-per-target",
                              missing="")
    if v is not None:
        ana.show_hits_per_target = True
        ana.target_mappings_file = v
    v = a.take_optional_value("-abundances", "-abundance", missing="")
    if v is not None:
        ana.show_tax_abundances = True
        ana.abundance_file = v
    v = a.take_value("-abundance-per")
    if v:
        ana.abundance_per = _parse_rank(v)

    ev = o.evaluate
    if a.take_flag("-ground-truth", "-groundtruth"):
        ev.determine_ground_truth = True
        ev.show_ground_truth = True
    if a.take_flag("-precision"):
        ev.precision = True
        ev.determine_ground_truth = True
    if a.take_flag("-taxon-coverage"):
        ev.taxon_coverage = True
        ev.precision = True
        ev.determine_ground_truth = True

    v = a.take_value("-threads")
    opt.num_threads = int(v) if v else 1
    v = a.take_value("-batch-size", "-batchsize")
    if v:
        opt.batch_windows = int(v)
    v = a.take_value("-query-limit", "-querylimit")
    if v:
        opt.query_limit = int(v)
    v = a.take_value("-min-readlen")
    if v:
        opt.min_read_length = int(v)
    v = a.take_value("-max-readlen")
    if v:
        opt.max_read_length = int(v)
    if a.take_flag("-no-summary", "-nosummary"):
        opt.show_summary = False
    if a.take_flag("-no-query-params", "-noqueryparams"):
        opt.show_query_params = False
    _apply_info_level(a)
    v = a.take_value("-replicate")
    if v:
        opt.num_replicas = int(v)
    v = a.take_value("-table-shards")
    if v:
        opt.table_shards = int(v)

    out_file = a.take_value("-out")
    split_out = a.take_value("-split-out", "-splitout")

    # post-processing (reference: process_query_options,
    # src/options.cpp:1330-1361)
    fmt.lowest_rank = _parse_rank(cl.lowest_rank)
    fmt.highest_rank = _parse_rank(cl.highest_rank)
    if ana.show_hits_per_target:
        fmt.show_query_ids = True
    fmt.apply_separate_cols()
    if fmt.map_view_mode == MapViewMode.NONE and ana.show_top_hits:
        fmt.map_view_mode = MapViewMode.MAPPED_ONLY
    elif ana.show_all_hits:
        fmt.map_view_mode = MapViewMode.ALL
    return opt, out_file, split_out


# copied from metacache_tpu/cli/main.py:372-415
def run_query(db, infiles, opt, out_file=None, runner=None):
    from ..classify import output as out_mod
    from ..classify.options import ClassificationResults
    from ..classify.runner import map_queries_to_targets

    stream = open(out_file, "w") if out_file else sys.stdout
    try:
        per_target = (open(opt.output.analysis.target_mappings_file, "w")
                      if opt.output.analysis.target_mappings_file
                      else stream)
        per_taxon = (open(opt.output.analysis.abundance_file, "w")
                     if opt.output.analysis.abundance_file else stream)
        results = ClassificationResults(stream, per_target, per_taxon)
        if opt.show_query_params:
            hits_min = opt.classify.resolve_hits_min(db.sketching.sketchlen)

            class _P:
                format = opt.output.format
                analysis = opt.output.analysis
                evaluate = opt.output.evaluate
                classify_resolved = (
                    opt.output.format.lowest_rank,
                    opt.output.format.highest_rank,
                    hits_min, opt.classify.max_candidates,
                    opt.classify.insert_size_max)
            stream.write(out_mod.show_query_parameters(
                _P, opt.pairing, opt.num_threads, opt.min_read_length,
                opt.max_read_length))
        map_queries_to_targets(infiles, db, opt, results, runner)
        if opt.show_summary:
            nq = results.statistics.total() * \
                (2 if opt.pairing != PairingMode.NONE else 1)
            stream.write(out_mod.show_summary(
                results.statistics, nq, results.time_ms,
                opt.output.format.tokens.comment))
        if per_target is not stream:
            per_target.close()
        if per_taxon is not stream:
            per_taxon.close()
    finally:
        if out_file:
            stream.close()
    return 0


# copied from metacache_tpu/cli/main.py:418-459
def mode_query(argv: List[str]) -> int:
    from ..config import MAX_SUPPORTED_LOCATIONS_PER_FEATURE
    from ..db.database import Database

    a = Args(argv)
    part = a.take_value("-part")
    remove_overpop = a.take_flag("-remove-overpopulated-features")
    maxlocs = a.take_value("-max-locations-per-feature")
    opt, out_file, split_out = parse_query_options(a)
    pos = a.positionals()
    if not pos:
        raise CliError("database filename missing")
    infiles = _expand(pos[1:])
    db = Database.load(pos[0], part=int(part) if part else None)
    if remove_overpop:
        maxlpf = (int(maxlocs) - 1) if maxlocs else -1
        if maxlpf < 0 or maxlpf >= MAX_SUPPORTED_LOCATIONS_PER_FEATURE:
            maxlpf = MAX_SUPPORTED_LOCATIONS_PER_FEATURE - 1
        maxlpf = min(maxlpf, db.max_locations_per_feature - 1)
        if maxlpf > 0:
            db.remove_features_with_more_locations_than(maxlpf)
        if maxlocs:
            db.set_max_locations_per_feature(int(maxlocs))
    elif maxlocs and int(maxlocs) > 1:
        db.set_max_locations_per_feature(int(maxlocs))
    if not infiles:
        return interactive_query(db, opt)
    if split_out:
        for path in infiles:
            suffix = "_" + os.path.basename(path) + ".txt"
            run_query(db, [path], opt, split_out + suffix)
        return 0
    return run_query(db, infiles, opt, out_file)


# copied from metacache_tpu/cli/main.py:498-541
def mode_build_query(argv: List[str]) -> int:
    """Build DB in memory, then query (reference: mode_build_query.cpp)."""
    from ..db.build import BuildOptions, build_database

    a = Args(argv)
    save_db = a.take_value("-save-db")
    taxonomy_dir = a.take_value("-taxonomy", default="")
    taxpostmap = a.take_values("-taxpostmap")
    bopt = BuildOptions(taxonomy_dir=taxonomy_dir, taxpostmap=taxpostmap)
    v = a.take_value("-max-locations-per-feature")
    if v:
        bopt.max_locations_per_feature = int(v)

    # reference syntax: -targets <files...> [-query <files...>]
    # (src/options.cpp:1701-1712); everything after '-query' is query input
    if "-query" in a.argv:
        i = a.argv.index("-query")
        build_args, query_args = a.argv[:i], a.argv[i + 1:]
    else:
        build_args, query_args = a.argv, []
    ab = Args(build_args)
    sk = _parse_sketching(ab)
    if sk is not None:
        bopt.sketching = SketchingOptions(
            kmerlen=sk.kmerlen or 16, sketchlen=sk.sketchlen or 16,
            winlen=sk.winlen or 127, winstride=sk.winstride)
    bopt.infiles = ab.take_values("-targets")
    bopt.infiles += ab.positionals()
    if not bopt.infiles:
        raise CliError("No reference sequence files provided or found!")
    aq = Args(query_args)
    opt, out_file, _split = parse_query_options(aq)
    infiles = _expand(aq.positionals())
    # build the tables on the card whenever the query config allows;
    # -save-db exports them as CSR parts
    bopt.device_tables = (opt.num_replicas == 1
                          and opt.table_shards == 1)
    db = build_database(bopt)
    if save_db:
        db.save(save_db)
    if not infiles:
        return interactive_query(db, opt)
    return run_query(db, infiles, opt, out_file)


# copied from metacache_tpu/cli/main.py:462-485
def interactive_query(db, default_opt) -> int:
    """Interactive REPL (reference: querying.cpp:275-316): each input line
    is parsed as `[options] file(s)` and queried as its own run (the
    initial options are the reference's defaults); an empty line or the
    end of input quits."""
    print("Waiting for input, hit return to quit ...", file=sys.stderr)
    print("  for query parameter help type ':help'", file=sys.stderr)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            break
        if line.startswith(":help"):
            print(query_mode_docs(), file=sys.stderr)
            continue
        try:
            a = Args(line.split())
            opt, out_file, _split = parse_query_options(a)
            infiles = _expand(a.positionals())
            if infiles:
                run_query(db, infiles, opt, out_file)
                sys.stdout.flush()
        except Exception as e:  # REPL keeps running on errors
            print(f"error: {e}", file=sys.stderr)
    return 0


# copied from metacache_tpu/cli/main.py:549-555
def query_mode_docs() -> str:
    return ("query mode options: -lowest/-highest <rank>, -hitmin <t>, "
            "-hitdiff <t>, -maxcand <n>, -pairfiles/-pairseq, -tophits, "
            "-allhits, -taxids[-only], -omit-ranks, -separate-cols, "
            "-lineage, -queryids, -mapped-only, -no-map, -precision, "
            "-ground-truth, -abundances [<f>], -abundance-per <rank>, "
            "-hits-per-ref [<f>], -out <f>")


# copied from metacache_tpu/cli/main.py:544-546
def mode_merge(argv: List[str]) -> int:
    from .merge import main_mode_merge
    return main_mode_merge(argv)


HELP = f"""metacache_tpu_torch {__version__} - metagenomic classifier on one
NVIDIA GPU (PyTorch + hand-written CUDA kernels)

USAGE: python -m metacache_tpu_torch <MODE> [OPTION...]

modes:
    build       build a new database from reference sequences
    modify      add reference sequences/taxonomy to an existing database
    query       classify read sequences using an existing database
    build+query build a database and query it immediately
    merge       merge results of independent queries
    info        show database and taxonomy information
    help        show documentation
"""


def mode_help(args) -> int:
    if args and args[0] in MODES:
        print(MODES[args[0]])
        return 0
    print(HELP)
    if args:
        print(f"no documentation for '{args[0]}'")
    return 0


def main(argv: List[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(HELP)
        return 0
    if argv[0] in ("help", "-h", "--help"):
        return mode_help(argv[1:])
    mode, rest = argv[0], argv[1:]
    try:
        if mode == "build":
            return mode_build(rest)
        if mode == "modify":
            return mode_build(rest, modify=True)
        if mode == "query":
            return mode_query(rest)
        if mode == "build+query":
            return mode_build_query(rest)
        if mode == "merge":
            return mode_merge(rest)
        if mode == "info":
            from .info import show_info
            return show_info(rest)
        print(HELP)
        print(f"unknown mode '{mode}'", file=sys.stderr)
        return 1
    except CliError as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    except ValueError as e:
        print(f"ERROR: invalid argument value: {e}", file=sys.stderr)
        return 1
