"""metacache_tpu_torch on paired-end reads and multi-part databases
against metacache_tpu, with inputs made from a numpy seed: the
multi-part step (every part probed, the slot rows concatenated) on 2 and
3 parts of random dense and two-tier tables, the paired scan step (two
windows a query) and the paired escalation (head-only phase 1, B6; the
redo of the flagged pairs, B7) on a two-tier table, the coded paired
dispatch on mates that are empty, shorter than k or longer than winlen,
and the CLI's paired query on a database whose dense rows are refused
(MC_DENSE_LIMIT=1), summary (escalated) and per-read. Plain kernel
versions on the CPU; tolerance 0 (integer outputs)."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.classify.runner import ClassificationResults as JResults
from metacache_tpu.classify.runner import QueryOptions as JOptions
from metacache_tpu.classify.runner import QueryRunner as JRunner
from metacache_tpu.cli.main import main as jax_main
from metacache_tpu.db.database import Database as JDatabase
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops.probe import make_bucket_index
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu_torch import native
from metacache_tpu_torch.classify.options import (ClassificationResults,
                                                  QueryOptions)
from metacache_tpu_torch.classify.runner import QueryRunner
from metacache_tpu_torch.cli.main import main
from metacache_tpu_torch.db.database import Database
from metacache_tpu_torch.db.state import tables_from_numpy
from metacache_tpu_torch.ops import rows as trows
from test_torch_cuda import (MULTIPART_ARGS as ARGS, feature_locations,
                             feature_table, lineages, multipart_case,
                             multipart_step, part_layouts)

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ACGT = np.frombuffer(b"ACGT", np.uint8)
NTGT = 24


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _jargs(lin):
    return (jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
            jnp.int32(ARGS[0]), jnp.float32(ARGS[1]), jnp.int32(ARGS[2]),
            jnp.int32(ARGS[3]))


def _sketch(codes, lens):
    """JAX's sketch of (N, W) codes -> (N, 16) u32."""
    return np.asarray(jax_sketch(jnp.asarray(codes), jnp.asarray(lens),
                                 k=16, sketchlen=16))


# ------------------------------------------------------------ multi-part
@pytest.mark.parametrize("nparts", [2, 3])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("max_candidates", [2, 8])
def test_multipart_step_matches_jax(nparts, packed, max_candidates):
    """All nine QueryResult fields bit-equal: two candidates through the
    fused kernels (B4 sorting its own row of unequal runs, or B5), eight
    through the non-fused path with its per-hit lists."""
    d = multipart_case()
    pack_bits = d["wbits"] if packed else 0
    parts = part_layouts(d, nparts, pack_bits)
    B = d["codes"].shape[0]
    mwir = np.full(B, 2, np.int32)
    fused = max_candidates <= 4
    hs = [h for _t, h in parts]
    want = jrows.query_step_rows_multipart(
        jnp.asarray(d["codes"]), jnp.asarray(d["lens"]), jnp.asarray(mwir),
        tuple(jnp.asarray(h["ft"].unique_features) for h in hs),
        tuple(jnp.asarray(h["ft"].offsets.astype(np.int32)) for h in hs),
        tuple(jnp.asarray(h["rows"]) for h in hs),
        tuple(jnp.asarray(np.zeros(1, np.int32) if h["ovf"] is None
                          else h["ovf"]) for h in hs),
        *_jargs(d["lin"]), tuple(jnp.asarray(h["brows"]) for h in hs),
        k=16, sketchlen=16, windows_per_query=1,
        max_candidates=max_candidates, walk_elems=32, fast_top2=fused,
        emit_hits=not fused, pack_bits=pack_bits,
        slots_per_feature=tuple(h["ft"].max_bucket_size for h in hs),
        prefix_bits=tuple(h["bits"] for h in hs),
        prefix_steps=(0,) * nparts, num_parts=nparts,
        dense=tuple(h["tag"] for h in hs), fused_candidates=fused)
    tt = [t for t, _h in parts]
    calls = []
    real = trows.rows_to_result
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trows, "rows_to_result", lambda *a, **k: calls.append(
            (a[0].shape[1], k)) or real(*a, **k))
        got = multipart_step(d, tt, pack_bits, max_candidates,
                             torch.device("cpu"))
    for nm in want._fields:
        np.testing.assert_array_equal(getattr(got, nm).numpy(),
                                      np.asarray(getattr(want, nm)),
                                      err_msg=nm)
    # one row of every part's slots, no alternating runs
    (width, k), = calls
    assert width == 16 * sum(t.spf for t in tt)
    assert k.get("presorted_runs", 0) == 0
    assert (got.cls_tax.numpy() != 0).sum() > B // 2


# -------------------------------------------------- paired scan steps
@pytest.fixture(scope="module")
def pair_case():
    """K = 2 stacks of 32 pairs of 100 bp mates, some mates empty or
    shorter than k, and a two-tier table (head 4) from their sketches:
    half the pairs' features have buckets deeper than the head."""
    rng = np.random.default_rng(21)
    K, B = 2, 32
    codes = np.full((K, B, 2, 128), 4, np.uint8)
    codes[..., :100] = rng.integers(0, 4, (K, B, 2, 100))
    lens = np.full((K, B, 2), 100, np.int32)
    lens[0, 3, 1] = 0                 # an empty mate 2
    lens[1, 7, 0] = 0                 # an empty mate 1
    lens[0, 9, 1] = 10                # a mate shorter than k
    codes[lens == 0] = 4
    mwir = (2 + lens.sum(axis=2) // 112).astype(np.int32)
    feats = _sketch(codes.reshape(-1, 128), lens.reshape(-1)).reshape(
        K * B, 32)
    f, t, w = feature_locations(rng, feats, np.arange(K * B) % 2 == 0, NTGT)
    ft = feature_table(f, t, w)
    spf = ft.max_bucket_size
    wbits = (2 * int(w.max())).bit_length()
    head, ovf = ft.fused_rows_two_tier(spf, 4, slot_bits=wbits)
    brows, bits = make_bucket_index(ft.unique_features)
    lin = lineages(NTGT)
    tables = tables_from_numpy(
        ft.unique_features, ft.offsets, head, brows, bits, lin,
        lin[:, 0].copy(), spf, wbits, torch.device("cpu"), ovf_rows=ovf,
        head_slots=4)
    jargs = (jnp.asarray(ft.unique_features),
             jnp.asarray(ft.offsets.astype(np.int32)), jnp.asarray(head),
             jnp.asarray(ovf), *_jargs(lin), jnp.asarray(brows))
    jkw = dict(sketchlen=16, slots_per_feature=spf, max_candidates=2,
               prefix_bits=bits, dense=("two_tier", 4, False, False, wbits),
               pack_bits=wbits, dedup_walk=3, fast_top2=True,
               fused_candidates=False)
    return dict(codes=codes, lens=lens, mwir=mwir, tables=tables,
                jargs=jargs, jkw=jkw, wbits=wbits, K=K, B=B)


def test_paired_scan_step_matches_jax(pair_case):
    """Two windows a query at full depth (B7): the dedup sweep, since
    m * s * 2 = 96 passes the walk's 64."""
    d = pair_case
    got = trows.query_step_rows_scan(
        *(torch.from_numpy(d[k]) for k in ("codes", "lens", "mwir")),
        d["tables"], *ARGS, k=16, sketchlen=16, windows_per_query=2,
        max_candidates=2, dedup_walk=3, fast_top2=True,
        pack_bits=d["wbits"])
    want = jrows.query_step_rows_scan(
        *(jnp.asarray(d[k]) for k in ("codes", "lens", "mwir")),
        *d["jargs"], k=16, windows_per_query=2, **d["jkw"])
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != 0).sum() > d["K"] * d["B"] // 2


def test_paired_escalation_matches_jax(pair_case):
    """Phase 1 on pairs (head rows, B6: classified taxa, overflow bits,
    sketches of 2s features and their bucket rows) and the redo of the
    flagged pairs (B7) equal JAX's, and their merge equals the
    full-depth scan."""
    d = pair_case
    K, B = d["K"], d["B"]
    inputs = [torch.from_numpy(d[k]) for k in ("codes", "lens", "mwir")]
    kw = dict(max_candidates=2, dedup_walk=3, fast_top2=True,
              pack_bits=d["wbits"])
    cls1, over, fk, ik = trows.query_step_rows_scan_head(
        *inputs, d["tables"], *ARGS, k=16, sketchlen=16, **kw)
    jc, jo, jf, ji = jrows.query_step_rows_scan_head(
        *(jnp.asarray(d[k]) for k in ("codes", "lens", "mwir")),
        *d["jargs"], k=16, prefetch=True, return_feats=True, **d["jkw"])
    np.testing.assert_array_equal(cls1.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(over.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(fk.numpy(), np.asarray(jf).view(np.int32))
    # a feature past the last row (an empty mate's sentinels) keeps that
    # row number in JAX, whose gather clamps it; the port clamps it first
    nf = d["tables"].num_features
    np.testing.assert_array_equal(ik.numpy(), np.minimum(np.asarray(ji),
                                                         nf - 1))
    assert fk.shape == (K, B, 32)
    mask = (((over.numpy().reshape(-1)[:, None] >> np.arange(32)) & 1)
            .astype(bool).reshape(K * B))
    idxs = np.nonzero(mask)[0]
    assert 0 < len(idxs) < K * B
    sel = torch.from_numpy(idxs)
    cls2 = trows.query_step_rows_redo_scan(
        fk.reshape(-1, 32)[sel][None], ik.reshape(-1, 32)[sel][None],
        inputs[2].reshape(-1)[sel][None], d["tables"], *ARGS, **kw)
    jr = jrows.query_step_rows_redo_scan(
        jf.reshape(-1, 32)[idxs][None], ji.reshape(-1, 32)[idxs][None],
        jnp.asarray(d["mwir"].reshape(-1)[idxs][None]), *d["jargs"][:-1],
        **d["jkw"])
    np.testing.assert_array_equal(cls2.numpy(), np.asarray(jr))
    full = trows.query_step_rows_scan(
        *inputs, d["tables"], *ARGS, k=16, sketchlen=16,
        windows_per_query=2, **kw).numpy().reshape(-1)
    merged = cls1.numpy().reshape(-1).copy()
    merged[idxs] = cls2.reshape(-1)
    np.testing.assert_array_equal(merged, full)


# -------------------------------------------------- coded pair dispatch
@pytest.fixture(scope="module")
def dbfile(tmp_path_factory):
    db = str(tmp_path_factory.mktemp("pdb") / "db")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                     f"{DATA}/taxonomy"]) == 0
    return db


def _read(path, n):
    r = native.NativeFastxReader(path, max_len=8192)
    try:
        return r.read_batch_raw(n)
    finally:
        r.close()


@pytest.mark.parametrize("case", ["empty-mate", "short-mate", "long-mate"])
def test_dispatch_coded_pair_matches_jax(dbfile, case):
    """24 pairs of the fixture, every third one's mate changed: emptied,
    cut below k (10 bp), or replaced by a long read (> winlen, so the
    pair takes a window bucket of its own); the mapping lines and the
    statistics equal JAX's runner's on the same batch."""
    c1, l1, h1 = _read(f"{DATA}/reads_pair1.fa", 24)
    c2, l2, _h = _read(f"{DATA}/reads_pair2.fa", 24)
    c1, c2 = c1.copy(), c2.copy()
    l1, l2 = l1.copy(), l2.copy()
    sel = np.arange(0, 24, 3)
    if case == "empty-mate":
        l2[sel[::2]], l1[sel[1::2]] = 0, 0
    elif case == "short-mate":
        l2[sel] = 10
    else:
        lc, ll, _h = _read(f"{DATA}/reads_long.fa", len(sel))
        c1[sel] = lc[:, :c1.shape[1]]
        l1[sel] = np.minimum(ll, c1.shape[1])
        assert (l1[sel] > 127).all()
    for c, ln in ((c1, l1), (c2, l2)):
        c[np.arange(c.shape[1])[None, :] >= ln[:, None]] = 4
    out = {}
    for name, runner, res in (
            ("port", QueryRunner(Database.load(dbfile), QueryOptions()),
             ClassificationResults(io.StringIO())),
            ("jax", JRunner(JDatabase.load(dbfile), JOptions()),
             JResults(io.StringIO()))):
        runner._collect_batch(*runner._dispatch_coded_pair(c1, l1, c2, l2,
                                                           h1), res)
        out[name] = (res.per_read_out.getvalue(),
                     res.statistics.assigned_.tolist(), res.query_count)
    assert out["port"] == out["jax"]
    assert out["port"][2] == 24 and out["port"][0].count("\n") == 24


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
def deep_pairs(tmp_path_factory):
    """2 x 70 strains of 20 kbp plus 6 unique genomes (buckets ~70 deep,
    past the head of 61), 600 pairs of 60-119 bp mates from 150-400 bp
    fragments, mate 2 reverse-complemented, in two files and interleaved
    in one; JAX's runner's lines for them."""
    tmp = tmp_path_factory.mktemp("deep_pairs")
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
    files = [tmp / "r1.fa", tmp / "r2.fa", tmp / "rs.fa"]
    with open(files[0], "wb") as a, open(files[1], "wb") as b, \
            open(files[2], "wb") as s:
        for i in range(600):
            g = genomes[int(rng.integers(0, len(genomes)))]
            frag = int(rng.integers(150, 400))
            p = int(rng.integers(0, 20000 - frag))
            n1, n2 = (int(x) for x in rng.integers(60, 120, 2))
            m1 = b">p%d/1\n" % i + ACGT[g[p:p + n1]].tobytes() + b"\n"
            m2 = b">p%d/2\n" % i + ACGT[3 - g[p + frag - n2:p + frag]
                                        [::-1]].tobytes() + b"\n"
            a.write(m1)
            b.write(m2)
            s.write(m1 + m2)
    db = str(tmp / "db")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, str(gfa)]) == 0
    reads = [str(f) for f in files]
    want = {(m, p): _run(jax_main, ["query", db] + _pairing(reads, p) + a)
            for m, p, a in (("summary", "files", ["-no-map"]),
                            ("per-read", "files", []),
                            ("per-read", "seq", []))}
    return db, reads, want


def _pairing(reads, pairing):
    return reads[:2] + ["-pairfiles"] if pairing == "files" else \
        [reads[2], "-pairseq"]


@pytest.mark.parametrize("mode,pairing,cells", [
    ("summary", "files", "classed"), ("summary", "files", "two-tier"),
    ("per-read", "files", "classed"), ("per-read", "seq", "classed")])
def test_cli_pairs_two_tier_match_jax_runner(deep_pairs, monkeypatch, mode,
                                             pairing, cells):
    """-pairfiles (and the same pairs interleaved, -pairseq) on a
    database whose dense rows are refused: the classed cells the device
    builder then stages, or its two-tier rows (MC_CLASSED=0, phase 1
    through B6's plain version). The summary escalates pairs (phase 1 on
    two windows a query, then the redo), the per-read path classifies
    them at full depth; the same lines and statistics as JAX's runner
    on the same files."""
    db, reads, want = deep_pairs
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    monkeypatch.setenv("MC_CLASSED", "1" if cells == "classed" else "0")
    runners = []
    init = QueryRunner.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        runners.append(self)
    monkeypatch.setattr(QueryRunner, "__init__", spy)
    args = ["-no-map"] if mode == "summary" else []
    got = _run(main, ["query", db] + _pairing(reads, pairing) + args)
    assert got == want[mode, pairing]
    r, = runners
    assert r.tables.classed == (cells == "classed")
    assert r.tables.head_slots > 0 and r._escalation_ok(wq=2)
    assert (r.esc_reads > 0) == (mode == "summary")
    if mode == "summary":
        assert r.esc_reads < 600
