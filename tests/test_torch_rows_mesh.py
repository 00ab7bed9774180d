"""metacache_tpu_torch's table shards and replicas over a grid of devices
(parallel/rows_mesh.py, the runner's -table-shards and -replicate)
against metacache_tpu's twins on its 8-device virtual CPU mesh
(tests/test_rows_mesh.py) and against the port's own single-device
step: eight ``cpu`` entries stand for the eight devices. Inputs from
numpy with a seed; tolerance 0 (integer outputs)."""
import contextlib
import io
import itertools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metacache_tpu.classify.runner import QueryOptions as JQueryOptions
from metacache_tpu.classify.runner import QueryRunner as JQueryRunner
from metacache_tpu.classify.runner import _ShardedRows
from metacache_tpu.db.build import BuildOptions as JBuildOptions
from metacache_tpu.db.build import build_database as jax_build
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu.ops.table import FeatureTable as JFeatureTable
from metacache_tpu.ops.table import pack_locations as jpack
from metacache_tpu.parallel import mesh as JM
from metacache_tpu.parallel import rows_mesh as JRM
from metacache_tpu_torch.classify import runner as R
from metacache_tpu_torch.classify.options import ClassificationResults
from metacache_tpu_torch.cli.main import Args, parse_query_options, run_query
from metacache_tpu_torch.db.build import BuildOptions, build_database
from metacache_tpu_torch.ops import rows as trows
from metacache_tpu_torch.ops.table import FeatureTable, pack_locations
from metacache_tpu_torch.parallel import rows_mesh as RM
from metacache_tpu_torch.parallel.mesh import make_mesh
from metacache_tpu_torch.seqio.reader import PairingMode, read_queries
from metacache_tpu_torch.ops import windows as W

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLD = os.path.join(DATA, "golden")
CPU8 = [torch.device("cpu")] * 8
FIELDS = ("cand_tgt", "cand_tax", "cand_hits", "cand_beg", "cand_end",
          "cls_tax")

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices")


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _lineages(n):
    lin = np.zeros((n, 21), np.int32)
    lin[:, 0] = -np.arange(n) - 1
    lin[:, 4] = np.arange(n) // 2 + 100
    lin[:, 20] = 1
    return lin


@pytest.fixture(scope="module")
def fixture_db():
    """The fixture database built by both packages, the JAX runner's
    taxonomy arrays, and 64 reads of one window (tests/test_rows_mesh.py
    :26-38)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        tdb = build_database(BuildOptions(
            infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy"))
    jdb = jax_build(JBuildOptions(
        infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy"))
    jr = JQueryRunner(jdb, JQueryOptions())
    qs = list(itertools.islice(
        read_queries([f"{DATA}/reads_single.fa"], PairingMode.NONE), 64))
    sk = tdb.sketching
    wins = np.stack([W.sequence_windows(W.encode_ascii(q.seq1), sk)[0][0]
                     for q in qs])[:, None, :]
    return tdb, jdb, jr, wins


def _taxa(jr):
    return (np.asarray(jr._lineages_dev).copy(),
            np.asarray(jr._merge_tax_dev).copy())


def _jax_step(st, mesh, codes, lens, mwir, mt, lg, hmin, hfrac, **kw):
    return JRM.sharded_query_step_rows(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        jnp.asarray(st.features), jnp.asarray(st.offsets),
        jnp.asarray(st.loc_tgt2d), jnp.asarray(st.loc_win2d),
        jnp.asarray(st.prefix), jnp.asarray(mt), jnp.asarray(lg),
        jnp.int32(hmin), jnp.float32(hfrac), jnp.int32(19), jnp.int32(0),
        mesh=mesh, k=16, sketchlen=16,
        slots_per_feature=st.slots_per_feature, windows_per_query=1,
        max_candidates=2, prefix_bits=st.prefix_bits,
        prefix_steps=st.prefix_steps, pack_bits=st.slot_bits,
        head_slots=st.head_slots, **kw)


def _step(st, codes, lens, mwir, hmin, hfrac, sketchlen=16, **flags):
    blocks = RM.sharded_query_step_rows(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(mwir), st, hmin, hfrac, 19, 0, k=16,
        sketchlen=sketchlen, max_candidates=2, **flags)
    return RM.merge_blocks(blocks, torch.device("cpu"))


# JAX's step: no walk, no fast top-k, no fusing, per-hit lists
JAX_FLAGS = dict(fused_candidates=False, emit_hits=True)
FUSED_FLAGS = dict(walk_elems=32, fast_top2=True, fused_candidates=True)


def _assert_rows(got, want, fields=FIELDS):
    for name in fields:
        np.testing.assert_array_equal(
            np.asarray(getattr(got, name)), np.asarray(getattr(want, name)),
            err_msg=name)


def _real_hits(res, rows):
    q = np.asarray(res.hit_qid)
    keep = q != rows
    return (q[keep], np.asarray(res.hit_tgt)[keep],
            np.asarray(res.hit_win)[keep])


# ---------------------------------------------------------- shard tables
@pytest.mark.parametrize("layout", ["dense", "two_tier", "auto"])
@pytest.mark.parametrize("nt", [2, 4])
def test_shard_row_table_equals_jax(fixture_db, layout, nt, deep_table):
    """Features, offsets, bucket bits, slot bits and head width of every
    shard, and each feature's slot set (rows_mesh.py:55-153), on the
    fixture and on the deep-bucket table."""
    tdb, jdb, _jr, _w = fixture_db
    for tpart, jpart, maxloc in ((tdb.parts[0], jdb.parts[0],
                                  tdb.max_locations_per_feature),
                                 (deep_table[0], deep_table[1], 254)):
        st = RM.shard_row_table(tpart, nt, maxloc, layout=layout,
                                grid=make_mesh(2, nt, CPU8))
        js = JRM.shard_row_table(jpart, nt, maxloc, layout=layout)
        assert (st.prefix_bits, st.slot_bits, st.head_slots,
                st.slots_per_feature) == (js.prefix_bits, js.slot_bits,
                                          js.head_slots, js.slots_per_feature)
        for p in range(nt):
            n = len(st.features[p])
            np.testing.assert_array_equal(st.features[p], js.features[p, :n])
            assert (js.features[p, n:] == 0xFFFFFFFF).all()
            np.testing.assert_array_equal(st.offsets[p], js.offsets[p, :n + 1])
            assert st.tables[0, p] is st.tables[1, p]   # one copy a device
            got, want = _slot_sets(st.tables[0, p], n), _jax_slot_sets(
                js, p, n)
            assert got == want


def _slot_sets(t, n):
    rows = t.fused_rows.numpy()
    if t.head_slots:
        h = t.head_slots
        ovf = t.ovf_rows.numpy()
        out = []
        for i in range(n):
            c = rows[i, 1]
            s = list(rows[i, 3:3 + min(c, h)])
            if c > h:
                s += list(ovf[rows[i, 2], :c - h])
            out.append(s)
        return out
    c = t.spf
    return [list(zip(rows[i, 2:2 + rows[i, 1]],
                     rows[i, 2 + c:2 + c + rows[i, 1]])) for i in range(n)]


def _jax_slot_sets(js, p, n):
    rows = js.loc_tgt2d[p]
    if js.slot_bits:
        h = js.head_slots
        ovf = js.loc_win2d[p]
        out = []
        for i in range(n):
            c = rows[i, 1]
            s = list(rows[i, 3:3 + min(c, h)])
            if c > h:
                s += list(ovf[rows[i, 2], :c - h])
            out.append(s)
        return out
    c = js.slots_per_feature
    return [list(zip(rows[i, 2:2 + rows[i, 1]],
                     rows[i, 2 + c:2 + c + rows[i, 1]])) for i in range(n)]


def test_shard_row_table_refuses_u64(tmp_path):
    """k > 16: JAX's shard_row_table fails (a u64 feature viewed as int32
    has two lanes); the port refuses with a message naming that."""
    feats = np.asarray([1, 5, 2**40], np.uint64)
    ft = FeatureTable.build(feats, pack_locations(np.zeros(3, np.uint32),
                                                  np.arange(3)))
    with pytest.raises(ValueError, match="k <= 16"):
        RM.shard_row_table(ft, 2, 254, grid=make_mesh(1, 2, CPU8))
    jft = JFeatureTable.build(feats, jpack(np.zeros(3, np.uint32),
                                           np.arange(3)))
    with pytest.raises(ValueError):
        JRM.shard_row_table(jft, 2, 254)


# ------------------------------------------------------- the sharded step
@pytest.mark.parametrize("nd,nt", [(2, 4), (4, 2), (1, 8)])
def test_sharded_rows_equals_jax_and_single(fixture_db, nd, nt):
    """All nine QueryResult fields against JAX's sharded step (rebased by
    JAX's _ShardedRows), and against the port's single-device step: the
    per-row fields, and the per-hit lists but their padding."""
    tdb, jdb, jr, wins = fixture_db
    B = len(wins)
    valid = np.full((B, 1), 100, np.int32)
    mwir = np.full(B, 2, np.int32)
    lg, mt = _taxa(jr)
    st = RM.shard_row_table(tdb.parts[0], nt, tdb.max_locations_per_feature,
                            grid=make_mesh(nd, nt, CPU8), lineages=lg,
                            merge_tax=mt)
    got = _step(st, wins, valid, mwir, 5, 1.0, **JAX_FLAGS)
    js = JRM.shard_row_table(jdb.parts[0], nt, jdb.max_locations_per_feature)
    jres = _jax_step(js, JM.make_mesh(nd, nt), wins, valid, mwir, mt, lg, 5,
                     1.0)
    want = _ShardedRows(jres, B, nd, nt)
    _assert_rows(got, want, FIELDS + ("hit_qid", "hit_tgt", "hit_win"))

    single = R.QueryRunner(tdb, R.QueryOptions(), device=torch.device("cpu"))
    one = trows.query_step_rows(
        torch.from_numpy(wins), torch.from_numpy(valid),
        torch.from_numpy(mwir), _with_taxa(single.tables, lg, mt), 5, 1.0,
        19, 0, k=16, sketchlen=16, windows_per_query=1, max_candidates=2,
        pack_bits=single._pack_bits, **JAX_FLAGS)
    _assert_rows(got, one)
    for a, b in zip(_real_hits(got, B), _real_hits(one, B)):
        np.testing.assert_array_equal(a, b)


def _with_taxa(t, lg, mt):
    t.lineages = torch.from_numpy(lg)
    t.merge_tax = torch.from_numpy(mt)
    return t


@pytest.fixture(scope="module")
def deep_table():
    """tests/test_rows_mesh.py:63-103: a third of the 64 reads' features
    with 100-deep buckets (> 61), the others 5 deep; both packages'
    tables, and the reads."""
    rng = np.random.default_rng(13)
    B, WL, NTGT = 64, 128, 48
    codes = rng.integers(0, 4, (B, 1, WL), dtype=np.uint8)
    lens = np.full((B, 1), 100, np.int32)
    feats_all = np.asarray(jax_sketch(
        jnp.asarray(codes.reshape(B, WL)), jnp.asarray(lens.reshape(B)),
        k=16, sketchlen=16)).reshape(B, 16)
    uf = np.unique(feats_all.reshape(-1))
    uf = uf[uf != 0xFFFFFFFF]
    fs, ts, ws = [], [], []
    for i, fv in enumerate(uf):
        depth = 100 if i % 3 == 0 else 5
        for j in range(depth):
            fs.append(fv)
            ts.append((i + j) % NTGT)
            ws.append(j % 40)
    f, t, w = (np.asarray(x, dt) for x, dt in
               ((fs, np.uint32), (ts, np.int32), (ws, np.int32)))
    order = np.lexsort((w, t, f))
    tft = FeatureTable.build(f[order].copy(), pack_locations(t[order],
                                                             w[order]),
                             max_locations_per_feature=254)
    jft = JFeatureTable.build(f[order].copy(), jpack(t[order], w[order]),
                              max_locations_per_feature=254)
    return tft, jft, codes, lens


@pytest.mark.parametrize("nd,nt", [(1, 4), (2, 2)])
def test_sharded_two_tier_deep_buckets(deep_table, nd, nt):
    """Two-tier slot-packed shards (B7 on the probe, one pk exchange)
    against JAX's sharded step in all nine fields, and on the fused
    route (B4 on rows of P blocks of alternating 256-lane runs) against
    the port's single-device step on the dense rows."""
    tft, jft, codes, lens = deep_table
    B = len(codes)
    mwir = np.full(B, 2, np.int32)
    lg = _lineages(48)
    mt = lg[:, 0].copy()
    st = RM.shard_row_table(tft, nt, 254, grid=make_mesh(nd, nt, CPU8),
                            lineages=lg, merge_tax=mt)
    assert st.slot_bits > 0 and st.head_slots == 61
    js = JRM.shard_row_table(jft, nt, 254)
    want = _ShardedRows(_jax_step(js, JM.make_mesh(nd, nt), codes, lens,
                                  mwir, mt, lg, 1, 0.5), B, nd, nt)
    got = _step(st, codes, lens, mwir, 1, 0.5, **JAX_FLAGS)
    _assert_rows(got, want, FIELDS + ("hit_qid", "hit_tgt", "hit_win"))
    fused = _step(st, codes, lens, mwir, 1, 0.5, **FUSED_FLAGS)
    _assert_rows(fused, want)
    one = _single(tft, codes, lens, mwir, lg, mt, 1, 0.5, **FUSED_FLAGS)
    _assert_rows(fused, one)


def _single(ft, codes, lens, mwir, lg, mt, hmin, hfrac, sketchlen=16,
            **flags):
    """The port's single-device step on ``ft``'s dense (tgt, win) rows."""
    from metacache_tpu_torch.db.state import tables_from_numpy
    from metacache_tpu_torch.ops.probe import make_bucket_index
    spf = min(ft.max_bucket_size, 254)
    brows, bits = make_bucket_index(ft.unique_features)
    t = tables_from_numpy(ft.unique_features, ft.offsets, ft.fused_rows(spf),
                          brows, bits, lg, mt, spf, 0, torch.device("cpu"))
    return trows.query_step_rows(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(mwir), t, hmin, hfrac, 19, 0, k=16,
        sketchlen=sketchlen, windows_per_query=codes.shape[1],
        max_candidates=2, **flags)


@pytest.mark.parametrize("sketchlen,nt", [(15, 2), (16, 3), (13, 4)])
def test_sharded_fused_route_odd_shapes(deep_table, sketchlen, nt):
    """An odd sketch length (F odd: the shard blocks' runs do not
    alternate across block boundaries) and a shard count whose rows do
    not fill a power of two: the fused kernels get presorted 0 and the
    rows equal the single-device step's."""
    tft, _jft, codes, lens = deep_table
    B = 48 if nt == 3 else len(codes)
    codes, lens = codes[:B], lens[:B]
    mwir = np.full(B, 2, np.int32)
    lg = _lineages(48)
    mt = lg[:, 0].copy()
    st = RM.shard_row_table(tft, nt, 254, grid=make_mesh(2, nt, CPU8),
                            lineages=lg, merge_tax=mt)
    flags = dict(FUSED_FLAGS, walk_elems=2 * sketchlen)
    assert RM.presorted_runs(256, sketchlen, nt) == 0
    got = _step(st, codes, lens, mwir, 1, 0.5, sketchlen=sketchlen, **flags)
    one = _single(tft, codes, lens, mwir, lg, mt, 1, 0.5,
                  sketchlen=sketchlen, **flags)
    _assert_rows(got, one)


def test_presorted_runs():
    assert RM.presorted_runs(256, 16, 4) == 256
    assert RM.presorted_runs(64, 16, 1) == 64
    assert RM.presorted_runs(256, 1, 1) == 256
    assert RM.presorted_runs(256, 1, 2) == 0      # runs do not alternate
    assert RM.presorted_runs(256, 15, 2) == 0
    assert RM.presorted_runs(256, 16, 3) == 0     # no power of two
    assert RM.presorted_runs(0, 16, 4) == 0


@pytest.mark.parametrize("nd,nt", [(1, 4), (2, 2)])
@pytest.mark.parametrize("fused", [False, True])
def test_sharded_escalation_head_plus_redo(nd, nt, fused):
    """tests/test_rows_mesh.py:163-249: the head-only step (B6) is exact
    for reads whose buckets all fit the head, the flags are OR-ed
    through the exchange (equal to JAX's), and the flagged reads redone
    through the full step give the full step's answer for every read."""
    rng = np.random.default_rng(21)
    B, WL, NTGT = 64, 128, 48
    codes = rng.integers(0, 4, (B, 1, WL), dtype=np.uint8)
    lens = np.full((B, 1), 100, np.int32)
    mwir = np.full(B, 2, np.int32)
    feats_all = np.asarray(jax_sketch(
        jnp.asarray(codes.reshape(B, WL)), jnp.asarray(lens.reshape(B)),
        k=16, sketchlen=16)).reshape(B, 16)
    uf = np.unique(feats_all.reshape(-1))
    uf = uf[uf != 0xFFFFFFFF]
    fs, ts, ws = [], [], []
    for i, fv in enumerate(uf):
        depth = 100 if i % 37 == 0 else 5
        for j in range(depth):
            fs.append(fv)
            ts.append((i + j) % NTGT)
            ws.append(j % 40)
    f, t, w = (np.asarray(x, dt) for x, dt in
               ((fs, np.uint32), (ts, np.int32), (ws, np.int32)))
    order = np.lexsort((w, t, f))
    tft = FeatureTable.build(f[order].copy(), pack_locations(t[order],
                                                             w[order]),
                             max_locations_per_feature=254)
    jft = JFeatureTable.build(f[order].copy(), jpack(t[order], w[order]),
                              max_locations_per_feature=254)
    lg = _lineages(NTGT)
    mt = lg[:, 0].copy()
    st = RM.shard_row_table(tft, nt, 254, layout="two_tier",
                            grid=make_mesh(nd, nt, CPU8), lineages=lg,
                            merge_tax=mt)
    flags = FUSED_FLAGS if fused else dict(fused_candidates=False)
    args = (torch.from_numpy(codes), torch.from_numpy(lens),
            torch.from_numpy(mwir), st, 1, 0.5, 19, 0)
    blocks, over = RM.sharded_query_step_rows_head(
        *args, k=16, sketchlen=16, max_candidates=2, **flags)
    head = RM.merge_blocks(blocks, torch.device("cpu"))
    ov = torch.cat(over).numpy()
    full = RM.merge_blocks(RM.sharded_query_step_rows(
        *args, k=16, sketchlen=16, max_candidates=2, **flags),
        torch.device("cpu"))
    assert ov.any() and not ov.all()
    js = JRM.shard_row_table(jft, nt, 254, layout="two_tier")
    kw = dict(mesh=JM.make_mesh(nd, nt), k=16, sketchlen=16,
              slots_per_feature=js.slots_per_feature, windows_per_query=1,
              max_candidates=2, prefix_bits=js.prefix_bits,
              prefix_steps=js.prefix_steps, pack_bits=js.slot_bits,
              head_slots=js.head_slots)
    _jres, jover = JRM.sharded_query_step_rows_head(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        jnp.asarray(js.features), jnp.asarray(js.offsets),
        jnp.asarray(js.loc_tgt2d), jnp.asarray(js.loc_win2d),
        jnp.asarray(js.prefix), jnp.asarray(mt), jnp.asarray(lg),
        jnp.int32(1), jnp.float32(0.5), jnp.int32(19), jnp.int32(0), **kw)
    np.testing.assert_array_equal(ov, np.asarray(jover))
    cls_head, cls_full = head.cls_tax.numpy(), full.cls_tax.numpy()
    np.testing.assert_array_equal(cls_head[~ov], cls_full[~ov])
    idx = np.nonzero(ov)[0]
    sel = np.resize(idx, -(-len(idx) // (nd * nt)) * nd * nt)
    redo = RM.merge_blocks(RM.sharded_query_step_rows(
        torch.from_numpy(codes[sel]), torch.from_numpy(lens[sel]),
        torch.from_numpy(mwir[sel]), st, 1, 0.5, 19, 0, k=16, sketchlen=16,
        max_candidates=2, **flags), torch.device("cpu"))
    merged = cls_head.copy()
    merged[idx] = redo.cls_tax.numpy()[:len(idx)]
    np.testing.assert_array_equal(merged, cls_full)


# ------------------------------------------------------------- the runner
def _summary(db, extra, devices=CPU8, env=(), mp=None):
    for k, v in env:
        mp.setenv(k, v)
    opt, _, _ = parse_query_options(Args(["-no-map"] + extra))
    runner = R.QueryRunner(db, opt, devices=devices)
    res = ClassificationResults(io.StringIO())
    R.map_queries_to_targets([f"{DATA}/reads_single.fa"], db, opt, res,
                             runner)
    for k, _v in env:
        mp.delenv(k)
    return res.statistics.assigned_.copy(), res.query_count, runner


def test_runner_sharded_escalation_summary(fixture_db, monkeypatch):
    """tests/test_rows_mesh.py:252-296: -table-shards 4 with forced
    two-tier shards escalates (the head step launches) and its summary
    equals the unsharded summary and JAX's under the same flags."""
    tdb, jdb, _jr, _w = fixture_db
    calls = []
    real = R.sharded_query_step_rows_head
    monkeypatch.setattr(R, "sharded_query_step_rows_head",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    plain, n0, _ = _summary(tdb, [], mp=monkeypatch)
    sharded, n1, r = _summary(tdb, ["-table-shards", "4"],
                              env=[("MC_SHARD_LAYOUT", "two_tier")],
                              mp=monkeypatch)
    assert r.layout.startswith("shards4:('two_tier'") and calls
    np.testing.assert_array_equal(sharded, plain)
    assert n1 == n0 == 200

    from metacache_tpu.classify.runner import ClassificationResults as JCR
    from metacache_tpu.classify.runner import map_queries_to_targets as jmap
    from metacache_tpu.cli.main import Args as JArgs
    from metacache_tpu.cli.main import parse_query_options as jparse
    monkeypatch.setenv("MC_SHARD_LAYOUT", "two_tier")
    jopt, _, _ = jparse(JArgs(["-no-map", "-table-shards", "4"]))
    jres = JCR(io.StringIO())
    jmap([f"{DATA}/reads_single.fa"], jdb, jopt, jres)
    np.testing.assert_array_equal(sharded, jres.statistics.assigned_)


def test_runner_sharded_escalation_redoes_flagged_reads(tmp_path,
                                                       monkeypatch):
    """The runner's escalated sharded summary with reads that do escalate:
    the fixture's genomes, with NC_900001.1 once more under another
    accession of the same taxon and buckets capped at 2 locations, give
    that genome's features two locations past a one-slot head; the
    flagged reads are redone
    (_ShardedRowsEsc) and the summary equals the unsharded one, on
    grids of one and two data groups."""
    with open(f"{DATA}/genomes.fa") as f:
        recs = f.read().split(">")[1:]
    dup = next(r for r in recs if r.startswith("NC_900001.1 "))
    fa = tmp_path / "genomes_dup.fa"
    fa.write_text("".join(">" + r for r in recs) + ">" +
                  dup.replace("NC_900001.1", "NC_900099.1", 1))
    db = build_database(BuildOptions(infiles=[str(fa)],
                                     taxonomy_dir=f"{DATA}/taxonomy",
                                     max_locations_per_feature=2))
    plain, n0, _ = _summary(db, [], mp=monkeypatch)
    for extra in (["-table-shards", "4"],
                  ["-table-shards", "2", "-replicate", "2"]):
        got, n1, r = _summary(db, extra, env=[("MC_SHARD_LAYOUT",
                                               "two_tier")], mp=monkeypatch)
        st = r._shards
        assert (st.slots_per_feature, st.head_slots) == (2, 1)
        assert r.esc_reads > 0
        np.testing.assert_array_equal(got, plain)
        assert n1 == n0


def _per_read(db, extra, devices, reads="reads_single.fa"):
    opt, _, _ = parse_query_options(Args(list(extra)))
    runner = R.QueryRunner(db, opt, devices=devices)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_query(db, [f"{DATA}/{reads}"], opt, runner=runner) == 0
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    return [l for l in buf.getvalue().splitlines()
            if not any(d in l for d in drop)], runner


@pytest.mark.parametrize("extra,grid", [
    (["-replicate", "2"], (2, 1)), (["-replicate", "0"], (8, 1)),
    (["-replicate", "3"], (2, 1)), (["-table-shards", "3"], (1, 3)),
    (["-table-shards", "2", "-replicate", "4"], (4, 2)),
    (["-table-shards", "8", "-replicate", "2"], (2, 1))])
def test_runner_grids_per_read_lines_equal(fixture_db, extra, grid):
    """JAX's grid rules (runner.py:397-436) and per-read lines equal to
    the unsharded run's: -replicate 0 takes all 8 devices, 3 rounds down
    to 2, shards x replicas past the devices fall back to replicas."""
    tdb = fixture_db[0]
    plain, _ = _per_read(tdb, ["-tophits"], CPU8)
    got, runner = _per_read(tdb, ["-tophits"] + extra, CPU8)
    assert (runner._nrep, runner._ntab) == grid
    assert got == plain and len(plain) > 200


def test_multipart_table_shards_takes_replicas(tmp_path):
    """A database of two parts takes no table shards (JAX's fallback:
    replicas when -replicate asks for them, else one device)."""
    from metacache_tpu_torch.cli.main import main
    from metacache_tpu_torch.db.database import Database
    db = str(tmp_path / "db2")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy", "-parts", "2"]) == 0
    tdb = Database.load(db)
    assert len(tdb.parts) == 2
    plain, _ = _per_read(tdb, [], [torch.device("cpu")])
    for extra, grid in ((["-table-shards", "4"], (1, 1)),
                        (["-table-shards", "4", "-replicate", "2"], (2, 1))):
        got, runner = _per_read(tdb, extra, CPU8)
        assert (runner._nrep, runner._ntab) == grid and got == plain


def test_device_parts_refuse_a_grid(monkeypatch):
    """build+query keeps its tables where its build made them: a grid
    raises JAX's RuntimeError (runner.py:489-493); -table-shards alone
    takes one device there (the built database has no loaded part)."""
    db = build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy",
        device_tables=True))
    assert db.device_parts and not db.parts
    opt, _, _ = parse_query_options(Args(["-replicate", "2"]))
    with pytest.raises(RuntimeError, match="device-resident build"):
        R.QueryRunner(db, opt, devices=CPU8)
    opt, _, _ = parse_query_options(Args(["-table-shards", "2"]))
    runner = R.QueryRunner(db, opt, devices=CPU8)
    assert runner._row_quantum == 1


def test_u64_database_refuses_table_shards(tmp_path):
    """k = 18 under -table-shards 2 (the only refusal: JAX fails there
    too); -replicate 2 classifies, lines equal to one device's."""
    from metacache_tpu_torch.cli.main import main
    from metacache_tpu_torch.db.database import Database
    db = str(tmp_path / "db18")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy", "-kmerlen", "18"]) == 0
    tdb = Database.load(db)
    opt, _, _ = parse_query_options(Args(["-table-shards", "2"]))
    with pytest.raises(ValueError, match="k <= 16"):
        R.QueryRunner(tdb, opt, devices=CPU8)
    plain, _ = _per_read(tdb, [], [torch.device("cpu")])
    got, runner = _per_read(tdb, ["-replicate", "2"], CPU8)
    assert runner._nrep == 2 and got == plain


@pytest.mark.parametrize("extra", [["-table-shards", "2"],
                                   ["-replicate", "2"]])
@pytest.mark.parametrize("golden,reads,args", [
    ("classified_single_fa.txt", "reads_single.fa",
     ["-precision", "-ground-truth", "-tophits", "-allhits",
      "-hits-per-ref", "-abundances", "-abundance-per", "species"]),
    ("classified_long_fa.txt", "reads_long.fa",
     ["-precision", "-ground-truth", "-tophits"])])
def test_goldens_over_a_grid(tmp_path, extra, golden, reads, args):
    """The reference's goldens through map_queries_to_targets over eight
    cpu devices: the per-hit lists (-allhits) and long reads too."""
    from metacache_tpu_torch.cli.main import main
    from metacache_tpu_torch.db.database import Database
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    tdb = Database.load(db)
    opt, _, _ = parse_query_options(Args(args + extra))
    runner = R.QueryRunner(tdb, opt, devices=CPU8)
    assert runner._row_quantum == 2
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert run_query(tdb, [f"{DATA}/{reads}"], opt, runner=runner) == 0
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    ours = [l for l in buf.getvalue().splitlines()
            if not any(d in l for d in drop)]
    with open(os.path.join(GOLD, golden)) as f:
        want = [l for l in f.read().splitlines()
                if not any(d in l for d in drop)]
    assert ours == want


@pytest.mark.parametrize("extra", [["-table-shards", "2"],
                                   ["-replicate", "2"]])
def test_nonfused_batch_splits_over_a_grid(fixture_db, monkeypatch, extra):
    """A non-fused batch (-allhits) over a grid goes in launches that the
    busiest device's free memory holds, each a multiple of the grid's
    positions, and gives the lines of one launch, per-hit lists
    included."""
    tdb = fixture_db[0]
    args = ["-allhits"] + extra
    whole, runner = _per_read(tdb, args, CPU8)
    assert runner.row_launches == runner._nrep     # a launch a replica
    slots = 16 * 2 * 2            # the fixture's spf is 2; two shards
    monkeypatch.setattr(R, "free_bytes", lambda device: 8 * slots * (
        R.NONFUSED_BYTES_A_SLOT + R.HIT_LIST_BYTES_A_SLOT))
    split, runner = _per_read(tdb, args, CPU8)
    assert split == whole and runner.row_launches >= 8


def test_replicas_keep_split_hit_lists_on_the_host(fixture_db, monkeypatch):
    """-replicate 2 on a -allhits batch whose rows take several launches
    a replica: those launches sent their per-hit lists to the host, and
    the replicas' merged result keeps them there; only the per-row
    fields move to the runner's device (a ``meta`` device stands for a
    card here; tests/test_torch_cuda.py holds the twin on the card)."""
    tdb, _jdb, _jr, wins = fixture_db
    opt, _, _ = parse_query_options(Args(["-allhits", "-replicate", "2"]))
    runner = R.QueryRunner(tdb, opt, devices=CPU8)
    # 8 rows a launch: the fixture's spf is 2, one part; mwir 2 gives a
    # walk over the whole row, so the rank join sweeps
    row_b = R.nonfused_row_bytes(16 * 2, "rank-join", True)
    monkeypatch.setattr(R, "free_bytes", lambda device: 8 * row_b)
    runner.device = torch.device("meta")
    n = len(wins)
    res = runner._launch_rows(wins, np.full((n, 1), wins.shape[2], np.int32),
                              np.full(n, 2, np.int32), 1,
                              opt.classify.max_candidates)
    assert runner.row_launches == 8
    assert all(x.device.type == "meta" for x in res[:6])
    assert res.cls_tax.shape == (n,)
    assert all(x.device.type == "cpu" for x in res[6:])
