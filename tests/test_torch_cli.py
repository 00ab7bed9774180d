"""metacache_tpu_torch's `build` and `query` CLI, in-process on the CPU:
the build (through the device table builder) equals metacache_tpu's and
each package loads the other's database, and the query output equals the
reference binary's goldens that lie on the port's slice (single-end,
-lowest sequence, up to 4 candidates, no per-hit lists), with packed
slots and, under MC_PACK_SLOTS=0, with unpacked (tgt, win) slots through
kernel B5's plain version; under each staging: the tables filled from
the CSR by the device builder (the default), host rows
(MC_DEVICE_LAYOUT=0), the size-classed cells (MC_DENSE_LIMIT=1
MC_CLASSED=1), B8's and B9's plain versions (MC_PROBE_PALLAS=1), and
`build+query`'s tables kept from its build."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.db.database import Database
from metacache_tpu_torch.cli.main import main

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(DATA, "golden")

# tests/test_golden_parity.py:96-116, minus the -lowest species/genus rows
FMT_FLAGS = {
    0: [], 1: ["-lineage"], 2: ["-taxids"], 3: ["-taxids-only"],
    4: ["-taxids-only", "-omit-ranks"], 5: ["-omit-ranks"],
    6: ["-taxids", "-omit-ranks"], 7: ["-separate-cols"],
    8: ["-taxids", "-separate-cols"],
    9: ["-taxids-only", "-separate-cols", "-omit-ranks"],
    10: ["-queryids"], 11: ["-queryids", "-lineage"],
    12: ["-mapped-only"], 13: ["-separator", ":::"],
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
                                  "-ground-truth", "-tophits"])]


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
    """A budget no dense, two-tier or classed layout fits: the device
    builder's MemoryError raises NotImplementedError naming the CSR
    layout (A10), with no quiet switch to host rows."""
    from metacache_tpu_torch.classify import runner as R
    from metacache_tpu_torch.classify.options import QueryOptions
    from metacache_tpu_torch.db.database import Database as TorchDatabase
    monkeypatch.setattr(R, "hbm_budget_bytes", lambda device: 1 << 16)
    with pytest.raises(NotImplementedError, match="A10"):
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


@pytest.mark.parametrize("flags,item", [
    (["-lowest", "species"], "A5"),
    (["-allhits"], "A5"),
    (["-maxcand", "5"], "A5"),
    (["-replicate", "2"], "A14"),
])
def test_query_rejects_paths_not_ported(dbfile, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        _query(dbfile, [f"{DATA}/reads_single.fa"] + flags)


def test_cpu_needs_explicit_opt_in(monkeypatch):
    from metacache_tpu_torch.device import get_device
    monkeypatch.delenv("MC_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="MC_TORCH_DEVICE=cpu"):
        get_device()


NOT_READ_YET = {"MC_PREFETCH", "MC_ESC_FUSED", "MC_ESC_B2", "MC_NATIVE_FMT",
                "MC_BUILD_DEBUG", "MC_SHARD_LAYOUT"}


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
    cli/help.py; the ones marked "not read by the port yet" are not."""
    import re
    from metacache_tpu_torch.cli.help import MODES
    env = MODES["query"][MODES["query"].index("ENVIRONMENT"):]
    active, idle = env.split("Not read by the port yet")
    active_names = set(re.findall(r"^    (MC_[A-Z0-9_]+)=", active, re.M))
    idle_names = set(re.findall(r"^    (MC_[A-Z0-9_]+)=", idle, re.M))
    assert idle_names == NOT_READ_YET
    assert {"MC_SKETCH_MODE", "MC_SPLIT_CAND", "MC_PROBE_PALLAS",
            "MC_TORCH_DEVICE", "MC_HBM_GB"} <= active_names
    src = _port_sources()
    for name in active_names:
        assert re.search(rf"[\"']{name}[\"']", src), name
    for name in idle_names:
        assert not re.search(rf"[\"']{name}[\"']", src), name
    assert "bucket,oidx" in active and "always run" in active


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
