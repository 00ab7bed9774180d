"""metacache_tpu_torch on long-window databases (winlen 255 and 511, the
reference's 255/511 presets sketched by kernel B2's plain version on the
CPU) and its build-side modes, against metacache_tpu in-process:

- `build -winlen 255|511` equals metacache_tpu's build_database;
- queries of the winlen-255 fixture database (per-read, -no-map summary,
  250 bp reads through both paths, long reads with -tophits) equal
  metacache_tpu's CLI output;
- `modify` of a half database equals the one-shot build and its query;
- `build+query` equals the reference binary's golden;
- `build -ref-format` writes the files metacache_tpu writes.
Tolerance 0 throughout (integer tables, text output)."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from metacache_tpu.cli.main import main as jax_main
from metacache_tpu.config import SketchingOptions
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.db.database import Database as JaxDatabase
from metacache_tpu.seqio.reader import read_sequences
from metacache_tpu_torch.cli.main import main
from metacache_tpu_torch.db.database import Database
from metacache_tpu_torch.ops import sketch as S

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(DATA, "golden")
ACGT = np.frombuffer(b"ACGT", np.uint8)
TAX = ["-taxonomy", f"{DATA}/taxonomy"]


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _strip(text):
    drop = ("# time:", "# speed:", "threads", "Reading database", DATA,
            "/tmp")
    return [l for l in text.splitlines() if not any(d in l for d in drop)]


def _run(cli, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli(args) == 0
    return _strip(buf.getvalue())


def _tables(db):
    p = db.parts[0]
    return p.unique_features, p.offsets, p.locations


def _assert_same_tables(ours, ref):
    assert ours.target_count == ref.target_count
    assert len(ours.parts) == len(ref.parts) == 1
    for name, a, b in zip(("features", "offsets", "locations"),
                          _tables(ours), _tables(ref)):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.fixture(scope="module")
def db255(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("w255") / "db")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, f"{DATA}/genomes.fa", "-winlen", "255"]
                    + TAX) == 0
    return db


@pytest.fixture(scope="module")
def reads250(tmp_path_factory):
    """600 reads of 250 bp from the fixture genomes, Poisson(2.5)
    substitutions (1%), numpy seed 17."""
    rng = np.random.default_rng(17)
    recs = list(read_sequences(f"{DATA}/genomes.fa"))
    lut = np.zeros(256, np.uint8)
    lut[np.frombuffer(b"ACGT", np.uint8)] = np.arange(4)
    path = tmp_path_factory.mktemp("r250") / "reads250.fa"
    with open(path, "wb") as f:
        for i in range(600):
            g = lut[np.frombuffer(recs[int(rng.integers(len(recs)))].seq,
                                  np.uint8)]
            p = int(rng.integers(0, len(g) - 250))
            r = g[p:p + 250].copy()
            nm = rng.poisson(2.5)
            r[rng.integers(0, 250, nm)] = rng.integers(0, 4, nm)
            f.write(b">q%d\n" % i + ACGT[r].tobytes() + b"\n")
    return str(path)


@pytest.mark.parametrize("winlen", ["255", "511"])
def test_long_window_build_matches_metacache_tpu(tmp_path, winlen):
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-winlen", winlen]
                + TAX) == 0
    ref = build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy",
        sketching=SketchingOptions(winlen=int(winlen))))
    ours = Database.load(db)
    assert ours.sketching.winlen == int(winlen)
    assert ours.sketching.winstride == int(winlen) - 15
    _assert_same_tables(ours, ref)


@pytest.fixture
def widths(monkeypatch):
    """The window widths that reach the long-window sketcher."""
    seen = []
    long = S._sketch_long

    def spy(codes, *a):
        seen.append(codes.shape[1])
        return long(codes, *a)
    monkeypatch.setattr(S, "_sketch_long", spy)
    return seen


QUERIES = {
    "single-per-read": ([f"{DATA}/reads_single.fa"], 255),
    "250bp-summary": (["READS250", "-no-map"], 256),
    "250bp-per-read": (["READS250"], 255),
    "long-tophits": ([f"{DATA}/reads_long.fa", "-tophits"], 255),
}


@pytest.mark.parametrize("case", sorted(QUERIES))
def test_long_window_query_matches_metacache_tpu(db255, reads250, widths,
                                                 case):
    """Per-read windows are 255 wide (B2 at W = 255); the summary scan
    stacks 250 bp reads as 64 packed bytes, unpacked to 256 (B2 at
    W = 256)."""
    args, width = QUERIES[case]
    args = [reads250 if a == "READS250" else a for a in args]
    want = _run(jax_main, ["query", db255] + args)
    assert _run(main, ["query", db255] + args) == want
    assert width in widths


def test_short_reads_on_a_long_window_database_crop_to_b1(db255, widths):
    """Reads of at most 128 bp on the summary path crop to at most 128
    characters and take B1's path, as in metacache_tpu (only the reads
    with ambiguous bases ride the per-read windows, 255 wide); the
    statistics equal metacache_tpu's."""
    args = [f"{DATA}/reads_single.fa", "-no-map"]
    assert _run(main, ["query", db255] + args) == \
        _run(jax_main, ["query", db255] + args)
    assert set(widths) == {255}


@pytest.mark.parametrize("mode,width", [("per-read", 255), ("summary", 256)])
def test_query_side_winlen_on_a_127_database(tmp_path, reads250, widths,
                                             mode, width):
    """A query-side -winlen 255 on a winlen-127 database (the sketching
    adaptation of metacache_tpu/classify/runner.py:743-754)."""
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa"] + TAX) == 0
    args = [reads250, "-winlen", "255"] + (["-no-map"] if mode == "summary"
                                           else [])
    assert _run(main, ["query", db] + args) == \
        _run(jax_main, ["query", db] + args)
    assert width in widths


def _write_fasta(path, recs):
    with open(path, "w") as f:
        for r in recs:
            f.write(f">{r.header}\n{r.seq.decode()}\n")


@pytest.mark.parametrize("winlen", ["127", "255"])
def test_modify_equals_one_shot_build(tmp_path, winlen):
    """The twin of tests/test_db_modes.py::test_modify_equivalence through
    the CLI: `modify` of a database of the first three genomes with the
    others equals the one-shot build, its tables and its query output."""
    recs = list(read_sequences(f"{DATA}/genomes.fa"))
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    _write_fasta(a, recs[:3])
    _write_fasta(b, recs[3:])
    half, full = str(tmp_path / "half"), str(tmp_path / "full")
    assert main(["build", half, a, "-winlen", winlen] + TAX) == 0
    assert main(["modify", half, b] + TAX) == 0
    assert main(["build", full, f"{DATA}/genomes.fa", "-winlen", winlen]
                + TAX) == 0
    mod = Database.load(half)
    assert mod.sketching.winlen == int(winlen)
    _assert_same_tables(mod, Database.load(full))
    reads = [f"{DATA}/reads_single.fa"]
    assert _run(main, ["query", half] + reads) == \
        _run(main, ["query", full] + reads)


def test_modify_reset_taxa(tmp_path):
    """`modify -reset-taxa` drops the targets' parents before the new
    taxonomy is applied, as metacache_tpu's modify does."""
    recs = list(read_sequences(f"{DATA}/genomes.fa"))
    a, b = str(tmp_path / "a.fa"), str(tmp_path / "b.fa")
    _write_fasta(a, recs[:3])
    _write_fasta(b, recs[3:])
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    for cli, db in ((main, ours), (jax_main, ref)):
        assert cli(["build", db, a] + TAX) == 0
        assert cli(["modify", db, b, "-reset-taxa"]) == 0
    got, want = Database.load(ours), JaxDatabase.load(ref)
    assert [t.parent_id for t in got.taxa.target_taxa] == \
        [t.parent_id for t in want.taxa.target_taxa]
    _assert_same_tables(got, want)


def _from_mappings(lines):
    """Query-result section only (build+query prepends build narration)."""
    for i, l in enumerate(lines):
        if l.startswith("# Reporting"):
            return lines[i:]
    return lines


def test_build_query_matches_golden(monkeypatch):
    """The twin of tests/test_golden_parity.py::test_build_query_parity;
    the query probes the tables the build made with the device builder,
    without a CSR in between."""
    from metacache_tpu_torch.classify.runner import QueryRunner
    staged = []
    init = QueryRunner.__init__

    def spy(self, db, *a, **kw):
        staged.append((len(db.device_parts), len(db.parts)))
        init(self, db, *a, **kw)
    monkeypatch.setattr(QueryRunner, "__init__", spy)
    ours = _run(main, ["build+query", "-targets", f"{DATA}/genomes.fa"]
                + TAX + ["-query", f"{DATA}/reads_single.fa", "-tophits"])
    with open(os.path.join(GOLD, "buildquery.txt")) as f:
        assert _from_mappings(ours) == _from_mappings(_strip(f.read()))
    assert staged == [(1, 0)]


def test_build_query_at_winlen_255_equals_build_then_query(db255, reads250):
    ours = _run(main, ["build+query", f"{DATA}/genomes.fa", "-winlen", "255"]
                + TAX + ["-query", reads250])
    assert _from_mappings(ours) == \
        _from_mappings(_run(main, ["query", db255, reads250]))


def test_build_query_without_reads_names_the_interactive_mode():
    with pytest.raises(NotImplementedError, match="A7"):
        main(["build+query", f"{DATA}/genomes.fa"] + TAX)


@pytest.mark.parametrize("winlen", ["127", "255"])
def test_ref_format_files_equal_metacache_tpu(tmp_path, winlen):
    """The twin of tests/test_mcformat_writer.py: `build -ref-format`
    writes .meta and .cache0 byte-identical to metacache_tpu's writer on
    the same build, and both packages load them back with equal tables."""
    from metacache_tpu.db.mcformat import save_reference_db
    from metacache_tpu_torch.db.mcformat import is_reference_db
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert main(["build", ours, f"{DATA}/genomes.fa", "-winlen", winlen,
                 "-ref-format"] + TAX) == 0
    assert is_reference_db(ours)
    save_reference_db(build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy",
        sketching=SketchingOptions(winlen=int(winlen)))), ref)
    for ext in (".meta", ".cache0"):
        with open(ours + ext, "rb") as f, open(ref + ext, "rb") as g:
            assert f.read() == g.read(), ext
    back = Database.load(ours)
    assert back.sketching.winlen == int(winlen)
    _assert_same_tables(back, JaxDatabase.load(ref))
