"""metacache_tpu_torch's `build` and `query` CLI, in-process on the CPU:
the build (through the device table builder) equals metacache_tpu's and
each package loads the other's database, and the query output equals the
reference binary's goldens (single-end reads, short and long, with taxon
merging, any number of candidates, per-hit lists and locations; 64-bit
features at k = 18; -cov-percentile, -align and the interactive mode,
the formatting matrix through it), with packed slots and, under
MC_PACK_SLOTS=0, with unpacked (tgt, win) slots through kernel B5's
plain version; under each staging: the tables filled from the CSR by the
device builder (the default), host rows (MC_DEVICE_LAYOUT=0), the
size-classed cells (MC_DENSE_LIMIT=1 MC_CLASSED=1), B9's plain version
(MC_PROBE_PALLAS=1), and `build+query`'s tables kept from its build; and
with the fused candidate kernels off (MC_FUSED_CANDIDATES=0)."""
import contextlib
import io
import os
import threading

import numpy as np
import pytest
import torch

from metacache_tpu.config import SketchingOptions
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.db.database import Database
from metacache_tpu_torch.cli.main import main

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(DATA, "golden")

# tests/test_golden_parity.py:96-116
FMT_FLAGS = {
    0: [], 1: ["-lineage"], 2: ["-taxids"], 3: ["-taxids-only"],
    4: ["-taxids-only", "-omit-ranks"], 5: ["-omit-ranks"],
    6: ["-taxids", "-omit-ranks"], 7: ["-separate-cols"],
    8: ["-taxids", "-separate-cols"],
    9: ["-taxids-only", "-separate-cols", "-omit-ranks"],
    10: ["-queryids"], 11: ["-queryids", "-lineage"],
    12: ["-mapped-only"], 13: ["-separator", ":::"],
    14: ["-lowest", "species"], 15: ["-lowest", "genus", "-taxids"],
    16: ["-hitmin", "8"], 17: ["-hitdiff", "50"],
    18: ["-maxcand", "4", "-tophits"],
}


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def dbfile(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("tdb") / "testdb")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                     f"{DATA}/taxonomy", "-parts", "1"]) == 0
    return db


def _strip(text):
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    return [l for l in text.splitlines() if not any(d in l for d in drop)]


def _golden(name):
    with open(os.path.join(GOLD, name)) as f:
        return _strip(f.read())


def _query(db, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["query", db] + args) == 0
    return _strip(buf.getvalue())


def test_build_matches_metacache_tpu(dbfile):
    ours = Database.load(dbfile)
    ref = build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy"))
    assert ours.target_count == ref.target_count
    for name in ("unique_features", "offsets", "locations"):
        np.testing.assert_array_equal(getattr(ours.parts[0], name),
                                      getattr(ref.parts[0], name),
                                      err_msg=name)


def test_build_takes_the_device_builder(tmp_path, monkeypatch):
    """`build` builds its tables with the device builder and saves them
    exported as CSR; `modify` (a loaded database) takes the host CSR."""
    from metacache_tpu_torch.ops import table_device
    built = []
    real = table_device.build_device_table_chunked
    monkeypatch.setattr(table_device, "build_device_table_chunked",
                        lambda *a, **kw: built.append(1) or real(*a, **kw))
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    assert built == [1]
    assert main(["modify", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    assert built == [1]


def test_database_of_metacache_tpu_loads_in_the_port(tmp_path):
    """The converse: a database written by metacache_tpu loads in the
    port with equal tables and taxonomy."""
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    path = str(tmp_path / "refdb")
    build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"],
        taxonomy_dir=f"{DATA}/taxonomy")).save(path)
    ref, ours = Database.load(path), TorchDatabase.load(path)
    assert ours.target_count == ref.target_count
    assert vars(ours.sketching) == vars(ref.sketching)
    for name in ("unique_features", "offsets", "locations"):
        np.testing.assert_array_equal(getattr(ours.parts[0], name),
                                      getattr(ref.parts[0], name),
                                      err_msg=name)

    def taxa(db):
        db.taxa.update()
        tx = db.taxa.taxonomy
        return (sorted((t.id, t.parent_id, int(t.rank), t.name)
                       for t in list(tx.taxa.values()) +
                       list(tx.targets.values())),
                db.taxa.target_lineages_array().tolist())
    assert taxa(ours) == taxa(ref)


@pytest.mark.parametrize("i", sorted(FMT_FLAGS))
def test_formatting_goldens(dbfile, i):
    ours = _query(dbfile, [f"{DATA}/reads_single.fa"] + FMT_FLAGS[i])
    assert ours == _golden(f"fmt_{i}.txt"), f"flags: {FMT_FLAGS[i]}"


def test_classified_single_fa_golden(dbfile):
    """-allhits (the per-hit lists), -hits-per-ref and abundances."""
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-precision",
                           "-ground-truth", "-tophits", "-allhits",
                           "-hits-per-ref", "-abundances", "-abundance-per",
                           "species"])
    assert ours == _golden("classified_single_fa.txt")


def test_classified_long_fa_golden(dbfile, monkeypatch):
    """Long reads: window buckets of up to 64 windows, ranges past 48
    windows through the rank join; the fused and the non-fused result
    paths give the same lines."""
    from metacache_tpu_torch.ops import rows as R
    sweeps = []
    real = R.rows_to_result
    monkeypatch.setattr(R, "rows_to_result", lambda *a, **k: sweeps.append(
        (k.get("walk_elems", 0), k.get("dedup_walk", 0), a[0].shape[1]))
        or real(*a, **k))
    args = [f"{DATA}/reads_long.fa", "-precision", "-ground-truth",
            "-tophits"]
    assert _query(dbfile, args) == _golden("classified_long_fa.txt")
    assert (0, 0) in {s[:2] for s in sweeps}          # the rank join
    monkeypatch.setenv("MC_FUSED_CANDIDATES", "0")
    assert _query(dbfile, args) == _golden("classified_long_fa.txt")


def test_summary_scan_error_stops_the_reader_thread(dbfile, monkeypatch,
                                                    tmp_path):
    """An error in the summary path's loop raises after the reader's
    producer thread has stopped, so that it never reads the reader the
    caller then closes: on a file of many reader batches, the thread
    would otherwise stay blocked on its full queue."""
    from metacache_tpu_torch.classify.runner import QueryRunner

    def boom(self, *a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(QueryRunner, "_dispatch_scan", boom)
    with open(f"{DATA}/reads_single.fa") as f:
        text = f.read()
    reads = tmp_path / "many.fa"
    reads.write_text(text * (200_000 // text.count(">") + 1))
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="boom"):
        _query(dbfile, [str(reads), "-no-map"])
    assert threading.active_count() == before


PAIR_CASES = {
    "classified_pairfiles.txt": [f"{DATA}/reads_pair1.fa",
                                 f"{DATA}/reads_pair2.fa", "-pairfiles",
                                 "-precision", "-ground-truth", "-tophits"],
    "classified_pairseq.txt": [f"{DATA}/reads_pairseq.fa", "-pairseq",
                               "-precision", "-ground-truth", "-tophits"],
    "insertsize.txt": [f"{DATA}/reads_pair1.fa", f"{DATA}/reads_pair2.fa",
                       "-pairfiles", "-insertsize", "1000", "-tophits"],
}


@pytest.mark.parametrize("gold", sorted(PAIR_CASES))
def test_paired_goldens(dbfile, gold):
    """Paired-end reads (tests/test_golden_parity.py:82-86, :282-286):
    two files read in lockstep, or consecutive records of one; each
    pair classifies from both mates' windows."""
    assert _query(dbfile, PAIR_CASES[gold]) == _golden(gold)


@pytest.mark.parametrize("pairing", ["-pairfiles", "-pairseq"])
def test_paired_summary_statistics(dbfile, monkeypatch, pairing):
    """-no-map: the paired scan path (two windows a query), the same
    summary statistics as the per-read path."""
    import inspect
    from metacache_tpu_torch.classify.runner import QueryRunner
    scans = []
    dispatch = QueryRunner._dispatch_scan_pair
    depth = inspect.signature(dispatch)
    monkeypatch.setattr(QueryRunner, "_dispatch_scan_pair",
                        lambda self, *a, **k: scans.append(depth.bind(
                            self, *a, **k).arguments["scan_k"]) or
                        dispatch(self, *a, **k))
    files = PAIR_CASES["classified_pairfiles.txt"][:2] \
        if pairing == "-pairfiles" else [f"{DATA}/reads_pairseq.fa"]

    def stats(lines):
        i = next(j for j, l in enumerate(lines) if "queries:" in l)
        return lines[i:]
    per_read = _query(dbfile, files + [pairing])
    assert not scans
    assert stats(_query(dbfile, files + [pairing, "-no-map"])) == \
        stats(per_read)
    assert scans == [1]


def test_partitioned_merge_golden(tmp_path):
    """Two databases of the fixture's first 3 and remaining genomes, each
    queried, then the port's `merge` of the two results
    (tests/test_golden_parity.py:135-170)."""
    from metacache_tpu_torch.seqio.reader import read_sequences
    recs = list(read_sequences(f"{DATA}/genomes.fa"))
    qargs = ["-lowest", "species", "-queryids", "-tophits", "-no-summary"]
    res = []
    for tag, rs in (("A", recs[:3]), ("B", recs[3:])):
        fa, db = tmp_path / f"{tag}.fa", str(tmp_path / f"db{tag}")
        with open(fa, "w") as f:
            for r in rs:
                f.write(f">{r.header}\n{r.seq.decode()}\n")
        assert main(["build", db, str(fa), "-taxonomy",
                     f"{DATA}/taxonomy"]) == 0
        out = str(tmp_path / f"partition_res{tag}.txt")
        assert main(["query", db, f"{DATA}/reads_single.fa"] + qargs +
                    ["-out", out]) == 0
        with open(out) as f:
            assert _strip(f.read()) == _golden(f"partition_res{tag}.txt")
        res.append(out)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["merge", *res, "-taxonomy", f"{DATA}/taxonomy",
                     "-lowest", "species", "-abundances"]) == 0

    def keep(lines):
        return [l for l in lines if "resA" not in l and "resB" not in l
                and not l.startswith("Reading")]
    assert keep(_strip(buf.getvalue())) == keep(_golden("merged.txt"))


@pytest.mark.parametrize("staging", ["device", "host-rows", "unpacked"])
@pytest.mark.parametrize("split", ["parts", "max-part-size"])
def test_multipart_database_equals_single_part(dbfile, tmp_path, monkeypatch,
                                               split, staging):
    """A database of two parts (`-parts 2`, or two input files kept apart
    by `-max-part-size`) gives the single-part database's mapping lines
    (tests/test_db_modes.py:34-39, :168-197), per read and, through
    the row path, as a summary; each part staged by the device builder,
    as host rows (MC_DEVICE_LAYOUT=0), or with unpacked (tgt, win) slots
    (MC_PACK_SLOTS=0 MC_PACK_STORE=0)."""
    env = {"device": {}, "host-rows": {"MC_DEVICE_LAYOUT": "0"},
           "unpacked": {"MC_PACK_SLOTS": "0", "MC_PACK_STORE": "0"}}
    for k, v in env[staging].items():
        monkeypatch.setenv(k, v)
    db = str(tmp_path / "db")
    if split == "parts":
        args = [f"{DATA}/genomes.fa", "-parts", "2"]
    else:
        with open(f"{DATA}/genomes.fa") as f:
            recs = f.read().split(">")[1:]
        half = len(recs) // 2
        args = []
        for tag, rs in (("a", recs[:half]), ("b", recs[half:])):
            (tmp_path / f"{tag}.fa").write_text("".join(">" + r for r in rs))
            args.append(str(tmp_path / f"{tag}.fa"))
        args += ["-max-part-size", "0.00001"]
    assert main(["build", db] + args + ["-taxonomy", f"{DATA}/taxonomy"]) == 0
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    assert len(TorchDatabase.load(db).parts) == 2
    for flags in (["-tophits", "-no-summary", "-no-query-params"], [],
                  ["-no-map"]):
        assert _query(db, [f"{DATA}/reads_single.fa"] + flags) == \
            _query(dbfile, [f"{DATA}/reads_single.fa"] + flags), flags


def test_locations_golden(dbfile):
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-locations",
                           "-queryids"])
    assert ours == _golden("locations.txt")


def test_classified_single_fq_golden(dbfile):
    ours = _query(dbfile, [f"{DATA}/reads_single.fq", "-precision",
                           "-ground-truth", "-tophits"])
    assert ours == _golden("classified_single_fq.txt")


def test_custom_sketch_golden(dbfile):
    """Query-side -sketchlen 8 -winlen 96."""
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-sketchlen", "8",
                           "-winlen", "96"])
    assert ours == _golden("custom_sketch.txt")


def test_highest_genus_golden(dbfile):
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-highest", "genus",
                           "-taxids"])
    assert ours == _golden("highest_genus.txt")


def test_reference_db_import_golden():
    """The reference binary's own database files (tests/data/refdb)
    load in the port and classify as the reference does."""
    ours = _query(f"{DATA}/refdb/refdb",
                  [f"{DATA}/reads_single.fa", "-mapped-only", "-precision",
                   "-ground-truth", "-tophits"])
    assert ours == _golden("refdb_import.txt")


def test_info_golden(dbfile):
    """`info <db>`, byte for byte (no line is dropped)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["info", dbfile]) == 0
    with open(os.path.join(GOLD, "info_basic.txt")) as f:
        assert buf.getvalue().splitlines() == f.read().splitlines()


GOLDEN_CASES = [(f"fmt_{i}.txt", [f"{DATA}/reads_single.fa"] + FMT_FLAGS[i])
                for i in sorted(FMT_FLAGS)] + [
    ("classified_single_fq.txt", [f"{DATA}/reads_single.fq", "-precision",
                                  "-ground-truth", "-tophits"]),
    ("classified_single_fa.txt", [f"{DATA}/reads_single.fa", "-precision",
                                  "-ground-truth", "-tophits", "-allhits",
                                  "-hits-per-ref", "-abundances",
                                  "-abundance-per", "species"]),
    ("classified_long_fa.txt", [f"{DATA}/reads_long.fa", "-precision",
                                "-ground-truth", "-tophits"]),
    ("locations.txt", [f"{DATA}/reads_single.fa", "-locations",
                       "-queryids"])] + sorted(PAIR_CASES.items())


@pytest.mark.parametrize("gold,args", GOLDEN_CASES,
                         ids=[g for g, _ in GOLDEN_CASES])
def test_goldens_with_fused_candidates_off(dbfile, monkeypatch, gold, args):
    """MC_FUSED_CANDIDATES=0: every step through the non-fused result
    path (torch ops, no candidate kernel), the same goldens."""
    from metacache_tpu_torch.ops import candidates as C
    calls = []
    for name in ("candidates_sorted_plain", "candidates_unpacked_plain"):
        monkeypatch.setattr(C, name, lambda *a, _n=name, **k:
                            calls.append(_n))
    monkeypatch.setenv("MC_FUSED_CANDIDATES", "0")
    assert _query(dbfile, args) == _golden(gold)
    assert calls == []


@pytest.mark.parametrize("gold,args", GOLDEN_CASES,
                         ids=[g for g, _ in GOLDEN_CASES])
def test_goldens_with_unpacked_slots(dbfile, monkeypatch, gold, args):
    """MC_PACK_SLOTS=0 (and MC_PACK_STORE=0, so the builder stores lane
    pairs too): the same goldens through (tgt, win) lane rows and the
    two-key candidates (B5)."""
    monkeypatch.setenv("MC_PACK_SLOTS", "0")
    monkeypatch.setenv("MC_PACK_STORE", "0")
    assert _query(dbfile, args) == _golden(gold)


STAGINGS = {
    "host-rows": {"MC_DEVICE_LAYOUT": "0"},
    "classed": {"MC_DENSE_LIMIT": "1", "MC_CLASSED": "1"},
    "probe-kernels": {"MC_PROBE_PALLAS": "1", "MC_PACK_ROWS": "1"},
    "unpacked-from-pk": {"MC_PACK_SLOTS": "0"},
}


@pytest.mark.parametrize("staging", sorted(STAGINGS))
@pytest.mark.parametrize("gold,args", GOLDEN_CASES,
                         ids=[g for g, _ in GOLDEN_CASES])
def test_goldens_under_each_staging(dbfile, monkeypatch, staging, gold,
                                    args):
    """The goldens through host rows, the classed cells, pair-packed rows
    probed by B9's plain version, and pk storage decoded to (tgt, win)
    for B5."""
    for k, v in STAGINGS[staging].items():
        monkeypatch.setenv(k, v)
    assert _query(dbfile, args) == _golden(gold)


def test_stagings_take_their_layouts(dbfile, monkeypatch):
    """Each staging of test_goldens_under_each_staging stages what it
    names, and the probe kernels' stages launch their plain versions."""
    from metacache_tpu_torch.classify.options import QueryOptions
    from metacache_tpu_torch.classify.runner import QueryRunner
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    from metacache_tpu_torch.ops import probe_decode
    calls = []
    plain = probe_decode.bucket_decode_plain
    monkeypatch.setattr(probe_decode, "bucket_decode_plain",
                        lambda *a: calls.append(1) or plain(*a))
    layouts = {}
    for name, env in sorted(STAGINGS.items()):
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            r = QueryRunner(TorchDatabase.load(dbfile), QueryOptions())
            layouts[name] = (r.layout, r._pack_bits > 0,
                             tuple(r.tables.bucket_rows.shape[1:]))
            if name == "probe-kernels":
                _query(dbfile, [f"{DATA}/reads_single.fa"])
    bits = r.tables.slot_bits
    assert layouts == {
        "host-rows": (f"pk{bits}", True, (64,)),
        "classed": (f"('classed', 2, False, False, {bits})", True, (128,)),
        "probe-kernels": (f"pk{bits}p", True, (128,)),
        "unpacked-from-pk": (f"pk{bits}", False, (128,))}
    assert calls


@pytest.mark.parametrize("packing", [None, "0"])
def test_runner_stages_the_layout_of_its_slots(dbfile, monkeypatch,
                                               packing):
    from metacache_tpu_torch.classify.options import QueryOptions
    from metacache_tpu_torch.classify.runner import QueryRunner
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    if packing is None:
        monkeypatch.delenv("MC_PACK_SLOTS", raising=False)
    else:
        monkeypatch.setenv("MC_PACK_SLOTS", packing)
    runner = QueryRunner(TorchDatabase.load(dbfile), QueryOptions())
    if packing is None:
        assert runner._pack_bits > 0
        assert runner.layout == f"pk{runner._pack_bits}"
        assert runner.tables.fused_rows.shape[1] >= 2 + runner.tables.spf
    else:
        # the device builder keeps its own slot packing (MC_PACK_STORE),
        # as JAX's does; the probe decodes the slots to (tgt, win)
        assert runner._pack_bits == 0
        assert runner.layout == f"pk{runner.tables.slot_bits}"
        monkeypatch.setenv("MC_DEVICE_LAYOUT", "0")
        runner = QueryRunner(TorchDatabase.load(dbfile), QueryOptions())
        assert runner._pack_bits == 0 and runner.layout == "True"
        assert runner.tables.fused_rows.shape[1] >= 2 + 2 * runner.tables.spf


def test_staging_that_fits_no_layout_names_the_csr_layout(dbfile,
                                                          monkeypatch):
    """A budget no dense, two-tier or classed layout fits but the CSR
    bytes do: the device builder's MemoryError takes the CSR layout (tag
    False, JAX's), the host rows of no layout; one byte less, and the
    MemoryError names the CSR layout, with JAX's advice."""
    from metacache_tpu_torch.classify import runner as R
    from metacache_tpu_torch.classify.options import QueryOptions
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    from metacache_tpu_torch.ops.probe import make_bucket_index
    from metacache_tpu_torch.ops.table import csr_bytes
    p = TorchDatabase.load(dbfile).parts[0]
    need = csr_bytes(p, make_bucket_index(p.unique_features)[0].nbytes)
    monkeypatch.setattr(R, "hbm_budget_bytes", lambda device: need)
    r = R.QueryRunner(TorchDatabase.load(dbfile), QueryOptions())
    assert r.layout == "False" and r.tables.fused_rows is None
    assert r.staged_bytes == need
    monkeypatch.setattr(R, "hbm_budget_bytes", lambda device: need - 1)
    with pytest.raises(MemoryError, match="CSR layout.*-table-shards"):
        R.QueryRunner(TorchDatabase.load(dbfile), QueryOptions())


@pytest.mark.parametrize("targets,max_window,bits", [
    (0, 0, 0),
    (192, 177, 9),
    (944, 8928, 15),          # the 944 Mbp RefSeq-skew database: pk15
    (8192, 71427, 18),        # the most targets that still pack at 18 bits
    (8193, 71427, 0),
    (9217, 71428, 0),         # chip_smoke.py's many-target database
    (2, 2**30, 0),
])
def test_slot_pack_bits(monkeypatch, targets, max_window, bits):
    """The rule of metacache_tpu/classify/runner.py:632-646: window bits
    (2 * max window).bit_length() when ((targets - 1) << bits) | max
    window stays below I32_MAX; MC_PACK_SLOTS=0 turns packing off."""
    from metacache_tpu_torch.classify.runner import slot_pack_bits
    monkeypatch.delenv("MC_PACK_SLOTS", raising=False)
    assert slot_pack_bits(targets, max_window) == bits
    monkeypatch.setenv("MC_PACK_SLOTS", "0")
    assert slot_pack_bits(targets, max_window) == 0


@pytest.mark.parametrize("scan_k_env", ["1", None])
def test_summary_scan_path_statistics(dbfile, monkeypatch, scan_k_env):
    """-no-map runs the packed-infeed scan path; its summary statistics
    equal those of the per-read run in the golden, and the stack is no
    deeper than the file's reads need."""
    from metacache_tpu_torch import native
    from metacache_tpu_torch.classify.runner import QueryRunner
    if scan_k_env is None:
        monkeypatch.delenv("MC_SCAN_K", raising=False)
    else:
        monkeypatch.setenv("MC_SCAN_K", scan_k_env)
    stacks = []
    dispatch = QueryRunner._dispatch_scan

    def spy(self, codes, lens, scan_k, bsz):
        stacks.append((scan_k, bsz))
        return dispatch(self, codes, lens, scan_k, bsz)
    monkeypatch.setattr(QueryRunner, "_dispatch_scan", spy)
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-no-map"])

    def stats(lines):
        i = next(j for j, l in enumerate(lines) if "queries:" in l)
        return lines[i:]
    assert stats(ours) == stats(_golden("fmt_0.txt"))
    nreads = native.scan_file(f"{DATA}/reads_single.fa")[0]
    assert stacks
    for scan_k, bsz in stacks:
        assert scan_k * bsz < nreads + bsz


@pytest.mark.parametrize("gold,flags", [
    ("fmt_14.txt", ["-lowest", "species"]),
    ("fmt_15.txt", ["-lowest", "genus", "-taxids"]),
    ("fmt_18.txt", ["-maxcand", "4"])])
def test_summary_scan_path_takes_every_result_route(dbfile, monkeypatch,
                                                    gold, flags):
    """-no-map with taxon merging (the scan steps on the non-fused
    result path) and without (the fused kernels): the summary statistics
    equal the per-read golden's."""
    from metacache_tpu_torch.ops import rows as R
    fused = []
    real = R.rows_to_result
    monkeypatch.setattr(R, "rows_to_result", lambda *a, **k: fused.append(
        R.fuses(k["fused_candidates"], k["fast_top2"], k["max_candidates"],
                k.get("walk_elems", 0), k.get("dedup_walk", 0), False))
        or real(*a, **k))
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-no-map"] + flags)

    def stats(lines):
        i = next(j for j, l in enumerate(lines) if "queries:" in l)
        return lines[i:]
    assert stats(ours) == stats(_golden(gold))
    assert fused and set(fused) == {"-lowest" not in flags}


@pytest.mark.parametrize("flags,item", [
    (["-replicate", "2"], "A14"),
    (["-table-shards", "2"], "A14"),
])
def test_query_rejects_paths_not_ported(dbfile, flags, item):
    """The options this test once found refused (ROADMAP ``item``) are
    ported and refuse nothing here: the CLI on the one CPU device takes
    JAX's grid rule (more replicas or shards than devices: one device)
    and gives the golden lines (tests/test_torch_rows_mesh.py holds the
    grids of several devices)."""
    assert item == "A14"
    assert _query(dbfile, [f"{DATA}/reads_single.fa"] + flags) == \
        _golden("fmt_0.txt")


# ---------------------------------------------- k = 18: 64-bit features
@pytest.fixture(scope="module")
def dbfile_k18(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("tdb18") / "testdb18")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                     f"{DATA}/taxonomy", "-parts", "1", "-kmerlen",
                     "18"]) == 0
    return db


K18_CASES = {
    "k18_single.txt": ["reads_single.fa", "-mapped-only", "-precision",
                       "-ground-truth", "-tophits"],
    "k18_long.txt": ["reads_long.fa", "-precision", "-ground-truth",
                     "-tophits"],
    "k18_pairfiles.txt": ["reads_pair1.fa", "reads_pair2.fa", "-pairfiles",
                          "-precision", "-tophits"],
}


def _k18_args(gold):
    return [f"{DATA}/{a}" if a.startswith("reads_") else a
            for a in K18_CASES[gold]]


@pytest.mark.parametrize("gold", sorted(K18_CASES))
def test_k18_goldens(dbfile_k18, gold):
    """The reference binary's goldens of its 64-bit build
    (-DMC_KMER_TYPE=uint64_t; tests/test_golden_parity.py:344-364): the
    port's k = 18 database, its u64 rows with two meta lanes, the 64-bit
    sketch's plain version."""
    assert _query(dbfile_k18, _k18_args(gold)) == _golden(gold)


def test_k18_goldens_with_fused_candidates_off(dbfile_k18, monkeypatch):
    """The non-fused result path (MC_FUSED_CANDIDATES=0) on the u64 rows:
    the same goldens, and -no-map summaries (the scan on the runner's
    packed infeed) equal to the per-read ones."""
    monkeypatch.setenv("MC_FUSED_CANDIDATES", "0")
    for gold in sorted(K18_CASES):
        assert _query(dbfile_k18, _k18_args(gold)) == _golden(gold), gold

    def stats(lines):
        i = next(j for j, l in enumerate(lines) if "queries:" in l)
        return lines[i:]
    args = [f"{DATA}/reads_single.fa", "-lowest", "species"]
    assert stats(_query(dbfile_k18, args + ["-no-map"])) == \
        stats(_query(dbfile_k18, args))


def test_k18_info_statistics(dbfile_k18):
    """`info <db> statistics` of the k = 18 database (the reference
    allocator's "buckets" line dropped, as tests/test_golden_parity.py
    drops it)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["info", dbfile_k18, "statistics"]) == 0
    drop = ("buckets ",)
    assert [l for l in _strip(buf.getvalue()) if not l.startswith(drop)] == \
        [l for l in _golden("k18_info_stats.txt") if not l.startswith(drop)]


def test_k18_databases_load_across_packages(dbfile_k18, tmp_path):
    """The port's k = 18 database equals metacache_tpu's build of the
    same genomes (u64 features), and each package loads the other's."""
    import jax
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    ref_path = str(tmp_path / "ref18")
    # JAX's 64-bit mode on for this block only: its build and load then
    # find it on and leave the global switch alone
    with jax.enable_x64(True):
        build_database(BuildOptions(
            infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy",
            sketching=SketchingOptions(kmerlen=18))).save(ref_path)
        ref_in_jax = Database.load(dbfile_k18)
    for a, b in ((TorchDatabase.load(dbfile_k18), Database.load(ref_path)),
                 (TorchDatabase.load(ref_path), ref_in_jax)):
        assert a.sketching.kmerlen == b.sketching.kmerlen == 18
        assert a.parts[0].unique_features.dtype == np.uint64
        for name in ("unique_features", "offsets", "locations"):
            np.testing.assert_array_equal(getattr(a.parts[0], name),
                                          getattr(b.parts[0], name),
                                          err_msg=name)


def test_k18_staging_where_jax_takes_the_csr_probe(dbfile_k18, monkeypatch):
    """u64 features never stage as host rows: MC_DEVICE_LAYOUT=0, where
    JAX's runner takes its CSR probe (runner.py:530-540), stages the CSR
    layout (tag False), searched by the sign-flipped features, and the
    k18 golden holds through it."""
    from metacache_tpu_torch.classify.options import QueryOptions
    from metacache_tpu_torch.classify.runner import QueryRunner
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    monkeypatch.setenv("MC_DEVICE_LAYOUT", "0")
    r = QueryRunner(TorchDatabase.load(dbfile_k18), QueryOptions())
    assert r.layout == "False" and r.tables.wide
    assert r.tables.bucket_rows is None
    assert r.tables.features.dtype == torch.int64
    assert bool((r.tables.features[1:] > r.tables.features[:-1]).all())
    assert _query(dbfile_k18, _k18_args("k18_single.txt")) == \
        _golden("k18_single.txt")


# ------------------------------ -cov-percentile, -align, interactive mode
def test_covpct_golden(dbfile):
    """-cov-percentile 50 (tests/test_golden_parity.py:220-224): the
    mappings are saved, targets below the coverage percentile dropped,
    then every read classified again from its remaining candidates."""
    ours = _query(dbfile, [f"{DATA}/reads_single.fa", "-cov-percentile",
                           "50", "-precision", "-ground-truth", "-tophits"])
    assert ours == _golden("covpct.txt")


_ALIGN_BLOCK = ("#   score", "#   query", "#   target")


def test_align_golden(dbfile):
    """-align as tests/test_golden_parity.py:176-217 checks it: every line
    but the alignment blocks equals the golden (whose blocks the
    reference binary computes against the wrong record), and the blocks
    align each classified read against its true genome with a positive
    score; the whole output equals metacache_tpu's, line for line."""
    import re
    from metacache_tpu.cli.main import main as jax_main
    args = ["query", dbfile, f"{DATA}/reads_single.fa", "-align", "-tophits"]
    outs = []
    for cli in (main, jax_main):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli(args) == 0
        outs.append(buf.getvalue().replace(DATA, "DATA"))
    ours = _strip(outs[0])
    assert ours == _strip(outs[1])
    assert [l for l in ours if not l.startswith(_ALIGN_BLOCK)] == \
        [l for l in _golden("align.txt") if not l.startswith(_ALIGN_BLOCK)]
    mapped = [l for l in ours if not l.startswith("#") and "\t|\t" in l]
    scores = [l for l in ours if l.startswith("#   score")]
    assert len(scores) == len(mapped) > 0
    genomes = [h.split()[0][1:] for h in open(f"{DATA}/genomes.fa")
               if h.startswith(">")]
    for row, sl in zip(mapped, scores):
        m = re.match(r"#   score  (\d+)  aligned to (\S+) #(\d+) "
                     r"in range \[(\d+),(\d+)\]", sl)
        assert m, sl
        assert m.group(2) == "DATA/genomes.fa"
        assert genomes[int(m.group(3)) - 1] == row.split("_r")[0]
        assert int(m.group(1)) > 50


def test_align_without_the_source_file_skips_the_display(tmp_path):
    """The subject is re-read from the target's source file at query
    time; where that file is gone, the lines carry no alignment block
    and the query still classifies (a warning on stderr)."""
    import shutil
    fa = tmp_path / "genomes.fa"
    shutil.copy(f"{DATA}/genomes.fa", fa)
    db = str(tmp_path / "db")
    assert main(["build", db, str(fa), "-taxonomy", f"{DATA}/taxonomy"]) == 0
    fa.unlink()
    ours = _query(db, [f"{DATA}/reads_single.fa", "-align", "-tophits"])
    assert not [l for l in ours if l.startswith(_ALIGN_BLOCK)]
    assert [l for l in ours if "\t|\t" in l]


def _repl(db, lines):
    """The query mode without read files, fed ``lines`` on stdin."""
    import sys
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "stdin", io.StringIO(lines))
        with contextlib.redirect_stdout(buf):
            assert main(["query", db]) == 0
    return buf.getvalue()


def test_repl_golden(dbfile):
    """The interactive mode (tests/test_golden_parity.py:256-273): options
    and a read file on a stdin line."""
    out = _repl(dbfile, f"{DATA}/reads_single.fa -tophits -no-summary\n")

    def rows(lines):
        return [l for l in lines if "\t|\t" in l or
                l.startswith("# TABLE_LAYOUT")]
    assert rows(_strip(out)) == rows(_golden("repl.txt"))


def test_formatting_matrix_144_through_the_repl(dbfile):
    """The reference run_tests' 144-combination formatting matrix driven
    through the REPL, one stdin line a combination
    (tests/test_golden_parity.py:412-436)."""
    with open(os.path.join(DATA, "fmt_matrix.txt")) as f:
        stdin = f.read().replace("tests/data/", f"{DATA}/")
    ours = [l for l in _repl(dbfile, stdin).splitlines() if "NC_" in l]
    with open(os.path.join(GOLD, "fmt_matrix.txt")) as f:
        want = f.read().splitlines()
    assert len(ours) == len(want)
    for i, (a, b) in enumerate(zip(ours, want)):
        assert a == b, f"line {i} (combination ~{i // 200})"


def test_repl_keeps_running_after_a_bad_line(dbfile, capsys):
    """A line that fails (a missing file) reports the error and the
    session goes on; `:help` prints the options."""
    out = _repl(dbfile, f":help\n{DATA}/missing.fa\n"
                        f"{DATA}/reads_single.fa -tophits\n")
    assert [l for l in _strip(out) if "\t|\t" in l]
    err = capsys.readouterr().err
    assert "query mode options" in err and "error:" in err


# ---------------------------------- the non-fused batch within free memory
@pytest.mark.parametrize("flags", [["-lowest", "species"],
                                   ["-allhits", "-tophits"]])
def test_nonfused_batch_splits_into_launches_that_fit(dbfile, monkeypatch,
                                                      flags):
    """A per-read batch bound for the non-fused result path goes in
    launches of as many rows as the free device memory holds: with room
    for 8 rows a launch, the fixture's 200 reads take at least 2 launches
    and give the lines of one launch (per-hit lists included); with room
    for less than a row, MemoryError names the numbers."""
    from metacache_tpu_torch.classify import runner as R
    launches = []
    real = R.QueryRunner._launch_rows

    def spy(self, *a, **k):
        before = self.row_launches
        out = real(self, *a, **k)
        launches.append(self.row_launches - before)
        return out
    monkeypatch.setattr(R.QueryRunner, "_launch_rows", spy)
    args = [f"{DATA}/reads_single.fa"] + flags
    whole = _query(dbfile, args)
    assert launches == [1]
    slots = 16 * 2                             # the fixture's spf is 2
    # the fixture's short reads sweep by the rank join (a walk would
    # span the whole row)
    row_b = R.nonfused_row_bytes(slots, "rank-join", "-allhits" in flags)
    monkeypatch.setattr(R, "free_bytes", lambda device: 8 * row_b)
    launches.clear()
    assert _query(dbfile, args) == whole
    assert launches and launches[0] >= 2
    monkeypatch.setattr(R, "free_bytes", lambda device: 100)
    with pytest.raises(MemoryError, match="100 bytes are free"):
        _query(dbfile, args)


def test_nonfused_rank_join_sized_by_padded_width(dbfile, monkeypatch):
    """The non-fused launch is sized by its sweep and the row's padded
    width (ops/candidates.py::padded_width): the fixture's rows of 32
    slots sweep by the rank join, 128 padded slots of 256 bytes. Free
    memory for 12 such rows at the walk's 96 bytes an unpadded slot (the
    sizing before the rank join and the dedup sweep were measured) holds
    one row a launch now: every launch takes one row, and the lines
    equal one launch's."""
    from metacache_tpu_torch.classify import runner as R
    from metacache_tpu_torch.ops.rows import nonfused_sweep
    assert [nonfused_sweep(*a) for a in ((32, 0, 32), (32, 0, 33),
                                         (0, 6, 100), (0, 0, 100))] == \
        ["rank-join", "walk", "dedup", "rank-join"]
    assert R.nonfused_row_bytes(32, "rank-join", False) == 128 * 256
    assert R.nonfused_row_bytes(32, "rank-join", True) == 128 * 268
    assert R.nonfused_row_bytes(8048, "walk", False) == 8192 * 96
    assert R.nonfused_row_bytes(5000, "dedup", True) == 8192 * 172
    args = [f"{DATA}/reads_single.fa", "-lowest", "species"]
    whole = _query(dbfile, args)
    sized = []
    real = R.QueryRunner._nonfused_rows

    def spy(self, slots, flags, device=None):
        assert slots == 32 and nonfused_sweep(
            flags.get("walk_elems", 0), flags.get("dedup_walk", 0),
            slots) == "rank-join"
        sized.append(real(self, slots, flags, device))
        return sized[-1]
    monkeypatch.setattr(R.QueryRunner, "_nonfused_rows", spy)
    old = 12 * 32 * R.NONFUSED_BYTES_A_SLOT
    monkeypatch.setattr(R, "free_bytes", lambda device: old)
    assert _query(dbfile, args) == whole
    assert sized == [1]
    monkeypatch.setattr(R, "free_bytes", lambda device: 8 * 128 * 256)
    sized.clear()
    assert _query(dbfile, args) == whole
    assert sized == [8]


def test_cpu_needs_explicit_opt_in(monkeypatch):
    from metacache_tpu_torch.device import get_device
    monkeypatch.delenv("MC_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MC_TORCH_DEVICE=cpu"):
        get_device()


NOT_READ_YET: set = set()
PIPELINE_KNOBS = {"MC_PREFETCH", "MC_ESC_FUSED", "MC_ESC_B2", "MC_NATIVE_FMT"}


def _port_sources():
    import glob
    import metacache_tpu_torch
    root = os.path.dirname(os.path.abspath(metacache_tpu_torch.__file__))
    text = {}
    for p in glob.glob(os.path.join(root, "**", "*.py"), recursive=True):
        if os.path.relpath(p, root) != os.path.join("cli", "help.py"):
            with open(p) as f:
                text[p] = f.read()
    return "\n".join(text.values())


def test_help_lists_as_active_only_variables_the_port_reads():
    """Every MC_* variable that `help query` presents as active is read
    (as a quoted name) somewhere in metacache_tpu_torch outside
    cli/help.py; none is marked "not read by the port yet" any more: the
    knobs of the pipelined scan, the fused escalation and the native
    formatter are active and read."""
    import re
    from metacache_tpu_torch.cli.help import MODES
    env = MODES["query"][MODES["query"].index("ENVIRONMENT"):]
    assert "Not read by the port yet" not in env
    active_names = set(re.findall(r"^    (MC_[A-Z0-9_]+)=", env, re.M))
    assert not NOT_READ_YET & active_names
    assert PIPELINE_KNOBS <= active_names
    assert {"MC_SKETCH_MODE", "MC_SPLIT_CAND", "MC_PROBE_PALLAS",
            "MC_TORCH_DEVICE", "MC_HBM_GB"} <= active_names
    src = _port_sources()
    for name in active_names:
        assert re.search(rf"[\"']{name}[\"']", src), name
    assert "bucket,oidx" in env and "always run" in env


def test_hbm_gb_overrides_the_budget(monkeypatch):
    """MC_HBM_GB sets the total the layout budget is taken from, less the
    reserve of max(2 GiB, 20%), as metacache_tpu/utils/platform.py."""
    from metacache_tpu.utils.platform import hbm_budget_bytes as jax_budget
    from metacache_tpu_torch.device import hbm_budget_bytes
    monkeypatch.delenv("MC_HBM_GB", raising=False)
    assert hbm_budget_bytes() == (16 << 30) - (16 << 30) // 5
    for gb in ("40", "0.5", "80"):
        monkeypatch.setenv("MC_HBM_GB", gb)
        assert hbm_budget_bytes() == jax_budget()
    assert hbm_budget_bytes() == (80 << 30) - (16 << 30)
