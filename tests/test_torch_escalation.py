"""metacache_tpu_torch on two-tier and size-classed tables: the escalation
steps (head-only phase 1, B6; full-depth redo on phase 1's sketches and
bucket probes, B7) against the port's own full-depth scan and against
metacache_tpu's twins, and the query CLI on a database whose dense rows
are refused (MC_DENSE_LIMIT=1) against metacache_tpu's runner and the
reference goldens, with escalation on and off, packed and unpacked
slots, through the classed cells the device builder then stages, its
two-tier rows (MC_CLASSED=0) and host two-tier rows (MC_DEVICE_LAYOUT=0).
Plain kernel versions on the CPU; tolerance 0 (integer outputs)."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.cli.main import main as jax_main
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops.probe import make_bucket_index
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu.ops.table import FeatureTable, pack_locations
from metacache_tpu_torch.classify.runner import QueryRunner
from metacache_tpu_torch.cli.main import main
from metacache_tpu_torch.db.state import tables_from_numpy
from metacache_tpu_torch.ops import rows as trows

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _lineages(n):
    lin = np.zeros((n, 21), np.int32)
    lin[:, 0] = -np.arange(n) - 1
    lin[:, 4] = np.arange(n) // 8 + 100
    lin[:, 20] = 1
    return lin


@pytest.fixture(scope="module")
def step_case():
    """The table of tests/test_rows_fast.py::test_redo_scan_matches_full
    _scan, built from the reads' own sketches: half the reads' features
    have 8-deep buckets (head 4), half shallow ones."""
    rng = np.random.default_rng(5)
    K, B, WL, NTGT = 2, 64, 128, 40
    codes = rng.integers(0, 4, (K, B, 1, WL), dtype=np.uint8)
    lens = np.full((K, B, 1), 100, np.int32)
    mwir = np.full((K, B), 2, np.int32)
    feats_all = np.asarray(jax_sketch(
        jnp.asarray(codes.reshape(K * B, WL)),
        jnp.asarray(lens.reshape(K * B)), k=16,
        sketchlen=16)).reshape(K * B, 16)
    deep_f = np.unique(feats_all[0::2].reshape(-1))
    shal_f = np.setdiff1d(np.unique(feats_all[1::2].reshape(-1)), deep_f)
    deep_f = deep_f[deep_f != 0xFFFFFFFF]
    shal_f = shal_f[shal_f != 0xFFFFFFFF]
    fs, ts, ws = [], [], []
    for i, fv in enumerate(deep_f):
        for j in range(8):
            fs.append(fv)
            ts.append((i + j) % NTGT)
            ws.append(j % 30)
    for i, fv in enumerate(shal_f):
        fs.append(fv)
        ts.append(i % NTGT)
        ws.append(i % 30)
    f = np.asarray(fs, np.uint32)
    t = np.asarray(ts, np.int32)
    w = np.asarray(ws, np.int32)
    order = np.lexsort((w, t, f))
    ft = FeatureTable.build(f[order].copy(),
                            pack_locations(t[order], w[order]),
                            max_locations_per_feature=16)
    spf = max(min(ft.max_bucket_size, 16), 1)
    hsl, wbits = 4, 8
    head, ovf = ft.fused_rows_two_tier(spf, hsl, slot_bits=wbits)
    brows, bits = make_bucket_index(ft.unique_features)
    return dict(codes=codes, lens=lens, mwir=mwir, ft=ft, spf=spf, hsl=hsl,
                wbits=wbits, head=head, ovf=ovf, brows=brows, bits=bits,
                lin=_lineages(NTGT), K=K, B=B)


def test_scan_head_and_redo_match_full_scan_and_jax(step_case):
    d = step_case
    K, B = d["K"], d["B"]
    ft, lin = d["ft"], d["lin"]
    tables = tables_from_numpy(
        ft.unique_features, ft.offsets, d["head"], d["brows"], d["bits"],
        lin, lin[:, 0].copy(), d["spf"], d["wbits"], torch.device("cpu"),
        ovf_rows=d["ovf"], head_slots=d["hsl"])
    codes, lens, mwir = (torch.from_numpy(d[k]) for k in
                         ("codes", "lens", "mwir"))
    args = (1, 0.5, 19, 0)
    kw = dict(k=16, sketchlen=16, max_candidates=2, walk_elems=32,
              fast_top2=True, pack_bits=d["wbits"])
    full = trows.query_step_rows_scan(codes, lens, mwir, tables, *args,
                                      windows_per_query=1, **kw).numpy()
    cls1, over, fk, ik = trows.query_step_rows_scan_head(
        codes, lens, mwir, tables, *args, **kw)
    mask = (((over.numpy().reshape(-1)[:, None] >> np.arange(32)) & 1)
            .astype(bool).reshape(K * B))
    idxs = np.nonzero(mask)[0]
    assert 0 < len(idxs) < K * B           # both phases exercised
    np.testing.assert_array_equal(cls1.numpy().reshape(-1)[~mask],
                                  full.reshape(-1)[~mask])
    sel = torch.from_numpy(idxs)
    F = fk.shape[-1]
    kw.pop("k")
    kw.pop("sketchlen")
    cls2 = trows.query_step_rows_redo_scan(
        fk.reshape(-1, F)[sel][None], ik.reshape(-1, F)[sel][None],
        mwir.reshape(-1)[sel][None], tables, *args, **kw).numpy()
    np.testing.assert_array_equal(cls2.reshape(-1), full.reshape(-1)[mask])

    # the JAX twins on the same table
    dense = ("two_tier", d["hsl"], False, False, d["wbits"])
    jargs = (jnp.asarray(ft.unique_features),
             jnp.asarray(ft.offsets.astype(np.int32)),
             jnp.asarray(d["head"]), jnp.asarray(d["ovf"]),
             jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin), jnp.int32(1),
             jnp.float32(0.5), jnp.int32(19), jnp.int32(0),
             jnp.asarray(d["brows"]))
    jkw = dict(sketchlen=16, slots_per_feature=d["spf"], max_candidates=2,
               prefix_bits=d["bits"], dense=dense, pack_bits=d["wbits"],
               walk_elems=32, fast_top2=True, fused_candidates=False)
    jc, jo, jf, ji = jrows.query_step_rows_scan_head(
        jnp.asarray(d["codes"]), jnp.asarray(d["lens"]),
        jnp.asarray(d["mwir"]), *jargs, k=16, prefetch=True,
        return_feats=True, **jkw)
    np.testing.assert_array_equal(cls1.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(fk.numpy(),
                                  np.asarray(jf).view(np.int32))
    np.testing.assert_array_equal(ik.numpy(), np.asarray(ji))
    jr = jrows.query_step_rows_redo_scan(
        jf.reshape(-1, F)[idxs][None], ji.reshape(-1, F)[idxs][None],
        jnp.asarray(d["mwir"].reshape(-1)[idxs][None]), *jargs[:-1], **jkw)
    np.testing.assert_array_equal(cls2, np.asarray(jr))


# ------------------------------------------------------------ the CLI
def _strip(text):
    drop = ("# time:", "# speed:", "threads", "Reading database", DATA,
            "/tmp")
    return [l for l in text.splitlines() if not any(d in l for d in drop)]


def _run(cli, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli(args) == 0
    return _strip(buf.getvalue())


@pytest.fixture(scope="module")
def deep_db(tmp_path_factory):
    """The deep-bucket database of tests/test_rows_fast.py::
    test_escalation_summary_parity: 2 x 70 strains of 20 kbp plus 6
    unique genomes, buckets ~70 deep (head 61), 1500 reads of 60-119 bp."""
    tmp = tmp_path_factory.mktemp("deep")
    rng = np.random.default_rng(3)
    genomes = []
    for _ in range(2):
        base = rng.integers(0, 4, 20000, dtype=np.uint8)
        for _s in range(70):
            g = base.copy()
            pos = rng.integers(0, 20000, 40)
            g[pos] = rng.integers(0, 4, 40)
            genomes.append(g)
    for _ in range(6):
        genomes.append(rng.integers(0, 4, 20000, dtype=np.uint8))
    gfa = tmp / "g.fa"
    with open(gfa, "wb") as fh:
        for i, g in enumerate(genomes):
            fh.write(b">g%d\n" % i + ACGT[g].tobytes() + b"\n")
    rfa = tmp / "r.fa"
    with open(rfa, "wb") as fh:
        for i in range(1500):
            gs = int(rng.integers(0, len(genomes)))
            p = int(rng.integers(0, 20000 - 120))
            ln = int(rng.integers(60, 120))
            fh.write(b">r%d\n" % i + ACGT[genomes[gs][p:p + ln]].tobytes()
                     + b"\n")
    db = str(tmp / "db")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, str(gfa)]) == 0
    summary = ["-no-map", "-batch-size", "512"]
    want = {m: _run(jax_main, ["query", db, str(rfa)] + a)
            for m, a in (("summary", summary), ("per-read", []))}
    return db, str(rfa), want


@pytest.mark.parametrize("mode", ["summary", "per-read"])
@pytest.mark.parametrize("escalate", ["1", "0"])
@pytest.mark.parametrize("packing", ["1", "0"])
def test_cli_two_tier_matches_jax_runner(deep_db, monkeypatch, mode,
                                         escalate, packing):
    db, reads, want = deep_db
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    monkeypatch.setenv("MC_ESCALATE", escalate)
    monkeypatch.setenv("MC_PACK_SLOTS", packing)
    launches = {}
    init = QueryRunner.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        launches["runner"] = self
    monkeypatch.setattr(QueryRunner, "__init__", spy)
    args = ["-no-map", "-batch-size", "512"] if mode == "summary" else []
    assert _run(main, ["query", db, reads] + args) == want[mode]
    r = launches["runner"]
    # the device builder, as JAX's, breaks the two-tier tie of heads 13
    # to 61 (all 64-lane rows) at 13, below the ladder's top class, so it
    # stages the classed cells: class C holds 61 slots; it keeps its pk
    # slots whatever MC_PACK_SLOTS says (the probe decodes them)
    assert r.tables.classed and r.tables.head_slots == 61
    assert r.tables.spf == 70
    escalated = mode == "summary" and escalate == "1" and packing == "1"
    assert r._escalation_ok() == (escalate == "1" and packing == "1")
    assert (r.esc_reads > 0) == escalated
    if escalated:
        assert r.esc_reads < 1500


@pytest.mark.parametrize("mode", ["summary", "per-read"])
@pytest.mark.parametrize("packing", ["1", "0"])
@pytest.mark.parametrize("staging", ["device", "host"])
def test_cli_two_tier_rows_match_jax_runner(deep_db, monkeypatch, mode,
                                            packing, staging):
    """The same queries through two-tier rows: the device builder's with
    the classed cells refused (MC_CLASSED=0), or host rows
    (MC_DEVICE_LAYOUT=0); escalated (B6, then B7) when slots pack."""
    db, reads, want = deep_db
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    monkeypatch.setenv("MC_PACK_SLOTS", packing)
    monkeypatch.setenv("MC_CLASSED", "0")
    if staging == "host":
        monkeypatch.setenv("MC_DEVICE_LAYOUT", "0")
    runners = []
    init = QueryRunner.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        runners.append(self)
    monkeypatch.setattr(QueryRunner, "__init__", spy)
    args = ["-no-map", "-batch-size", "512"] if mode == "summary" else []
    assert _run(main, ["query", db, reads] + args) == want[mode]
    r = runners[0]
    # head ladders: 13 packed slots (the first of the tied 64-lane heads),
    # or 30 (tgt, win) lane pairs in a 64-lane host row
    lanes = staging == "host" and packing == "0"
    assert r.layout == str(("two_tier", 30 if lanes else 13, False, False,
                            0 if lanes else r.tables.slot_bits))
    assert (r.esc_reads > 0) == (mode == "summary" and packing == "1")


@pytest.mark.parametrize("escalate", [True, False])
def test_fixture_golden_through_two_tier(tmp_path, monkeypatch, escalate):
    """The fixture query, per-read lines and the -no-map summary, through
    the two-tier layout (head 1 of 2 slots) against the reference
    golden; with escalation forced on (its slot threshold lowered, the
    fixture's buckets being 2 deep), the summary runs phase 1 (B6)."""
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    monkeypatch.setenv("MC_CLASSED", "0")    # else the classed cells
    if escalate:
        monkeypatch.setattr(QueryRunner, "FUSED_MIN_SLOTS", 0)
    runners, heads = [], []
    init = QueryRunner.__init__
    head = QueryRunner._dispatch_scan_head

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        runners.append(self)

    def spy_head(self, *a):
        heads.append(a[2:])
        return head(self, *a)
    monkeypatch.setattr(QueryRunner, "__init__", spy)
    monkeypatch.setattr(QueryRunner, "_dispatch_scan_head", spy_head)
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        gold = _strip(f.read())
    assert _run(main, ["query", db, f"{DATA}/reads_single.fa"]) == gold
    ours = _run(main, ["query", db, f"{DATA}/reads_single.fa", "-no-map"])
    i = next(j for j, l in enumerate(gold) if "queries:" in l)
    assert ours[-len(gold[i:]):] == gold[i:]
    assert [r.tables.head_slots for r in runners] == [1, 1]
    assert bool(heads) == escalate


@pytest.mark.parametrize("case,item", [("classed", None), ("csr", "A10"),
                                       ("two_tier", None)])
def test_device_layout_choice(monkeypatch, case, item):
    """The port's layout rule for host rows (MC_DEVICE_LAYOUT=0) on a
    table with 100-deep buckets: when dense rows are ruled out, two-tier
    at head 45, the first of the heads whose rows cost the least (45 and
    61: 64-lane heads and overflow rows), as JAX's tie rule keeps it;
    MC_CLASSED=1 changes nothing (host rows have no classed cells); a
    budget no two-tier head fits takes the CSR layout, ROADMAP ``item``
    A10 (head 0, its bytes ``csr_bytes`` with the bucket index's), and
    one below those bytes raises MemoryError with JAX's advice."""
    from metacache_tpu_torch.ops.table import FeatureTable as TFT
    from metacache_tpu_torch.ops.table import csr_bytes, device_layout
    rng = np.random.default_rng(9)
    f = np.repeat(rng.choice(2**31, 500, replace=False).astype(np.uint32),
                  rng.integers(1, 101, 500))
    ft = TFT.build(f, pack_locations(
        rng.integers(0, 50, len(f)).astype(np.uint32),
        rng.integers(0, 400, len(f)).astype(np.uint32)))
    spf = ft.max_bucket_size
    monkeypatch.delenv("MC_CLASSED", raising=False)
    if case == "classed":
        monkeypatch.setenv("MC_CLASSED", "1")
    if item is None:
        head, dense_b, _staged = device_layout(ft, spf, 10, 1 << 30,
                                               allow_dense=False)
        # dense rows: 2 meta lanes + spf slots, padded to 8 lanes
        assert head == 45 and dense_b == ft.num_features * 104 * 4 + 512
        assert device_layout(ft, spf, 10, 1 << 30)[0] == spf
        return
    need = csr_bytes(ft, 1000)
    assert need == ft.num_features * 12 + 8 + len(f) * 8 + 1000
    assert device_layout(ft, spf, 10, need, allow_dense=False,
                         index_bytes=1000)[::2] == (0, need)
    with pytest.raises(MemoryError, match="even in CSR layout"):
        device_layout(ft, spf, 10, need - 1, allow_dense=False,
                      index_bytes=1000)
