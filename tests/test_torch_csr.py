"""metacache_tpu_torch's CSR layout (the probe of databases that no row
layout fits, and JAX's CSR fallback of u64 tables) against metacache_tpu,
with inputs made from a numpy seed, bit for bit (tolerance 0: integer
outputs):

- the CSR probe (``probe_rows`` on a CSR part, csr_decode's plain
  version) against JAX's ``probe_rows(..., dense=False)``: u32 features
  through the bucket-row index (and B9's plain version), u64 features
  through the search, an empty part; packed and (tgt, win) slots,
  alternating runs on and off, buckets deeper than the slots a feature,
  missing and sentinel features;
- the row steps on CSR parts: the per-read step (fused and non-fused
  with per-hit lists), the summary scan, and the multi-part step with
  one CSR part beside a dense one;
- the staging choice of the port's runner against JAX's runner, case by
  case: the builder's MemoryError, MC_DEVICE_LAYOUT=0, u64 features
  under MC_DEVICE_LAYOUT=0, a low-32 collision the index widening cannot
  part, an empty u64 part, and a budget below the CSR bytes;
- the reference goldens through the CLI with the budget patched to the
  CSR bytes of the golden database: single reads per read and as a
  summary, long reads, paired reads, taxon merging and per-hit lists on
  the non-fused path, k = 18, and a database of two parts with one part
  in CSR.

JAX's 64-bit types are on only inside ``with jax.enable_x64(True):``."""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metacache_tpu.classify import runner as jrunner
from metacache_tpu.classify.runner import QueryOptions as JQueryOptions
from metacache_tpu.db.database import Database as JDatabase
from metacache_tpu.ops import probe as jprobe
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu.ops import table_device as jtd
from metacache_tpu_torch.classify import runner as R
from metacache_tpu_torch.classify.options import QueryOptions
from metacache_tpu_torch.cli.main import main
from metacache_tpu_torch.db.database import Database
from metacache_tpu_torch.db.state import tables_csr, tables_from_numpy
from metacache_tpu_torch.ops import probe as tprobe
from metacache_tpu_torch.ops import probe_decode as D
from metacache_tpu_torch.ops import rows as trows
from metacache_tpu_torch.ops.table import (FeatureTable, csr_bytes,
                                           pack_locations, unpack_locations)

torch.set_num_threads(2)
HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(DATA, "golden")
CPU = torch.device("cpu")
I32_MAX = 2**31 - 1
NTGT = 48
ARGS = (1, 0.5, 19, 0)    # hits_min, hits_diff, highest rank, merge rank


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _lineages(n=NTGT):
    lin = np.zeros((n, 21), np.int32)
    lin[:, 0] = -np.arange(n) - 1
    lin[:, 4] = np.arange(n) // 8 + 100
    lin[:, 20] = 1
    return lin


def _build(feats, rng, deep_every=5, deep=150):
    """A table of the distinct non-sentinel ``feats`` (uint32 or uint64):
    every ``deep_every``-th feature ``deep`` locations deep, the others
    1-6, targets below NTGT, windows below 1000."""
    fs, ts, ws = [], [], []
    for i, f in enumerate(feats):
        depth = deep if i % deep_every == 0 else int(rng.integers(1, 7))
        fs += [f] * depth
        ts += rng.integers(0, NTGT, depth).tolist()
        ws += rng.integers(0, 1000, depth).tolist()
    f = np.asarray(fs, feats.dtype)
    t = np.asarray(ts, np.uint32)
    w = np.asarray(ws, np.uint32)
    return FeatureTable.build(f, pack_locations(t, w))


def _index(ft):
    return None if ft.unique_features.dtype == np.uint64 else \
        tprobe.make_bucket_index(ft.unique_features)


def _tables(ft, c):
    lin = _lineages()
    return tables_csr(ft.unique_features, ft.offsets,
                      *unpack_locations(ft.locations), lin, lin[:, 0].copy(),
                      c, CPU, index=_index(ft))


def _jax_csr(ft):
    """JAX's four CSR arrays and its prefix (runner.py:530-540, :585-594)."""
    ltgt, lwin = unpack_locations(ft.locations)
    arrs = (jnp.asarray(ft.unique_features),
            jnp.asarray(ft.offsets.astype(np.int32)),
            jnp.asarray(ltgt.astype(np.int32)),
            jnp.asarray(lwin.astype(np.int32)))
    if ft.unique_features.dtype == np.uint64:
        return arrs, None, 0
    brows, bits = jprobe.make_bucket_index(ft.unique_features)
    return arrs, jnp.asarray(brows), bits


def _probe_case(kind, seed=5):
    """(port tables, JAX arrays, prefix, bits, features (8, 16) as the
    unsigned values, c = 100 below the deepest buckets' 150)."""
    rng = np.random.default_rng(seed)
    wide = kind == "u64"
    if wide:
        pool = np.unique(rng.integers(0, 2**63, 300).astype(np.uint64) * 2
                         + 1)
        sent = np.uint64(2**64 - 1)
    else:
        pool = np.unique(rng.integers(0, 2**32 - 1, 300).astype(np.uint32))
        sent = np.uint32(2**32 - 1)
    ft = _build(pool, rng)
    c = 100
    assert ft.max_bucket_size > c
    q = rng.choice(pool, (8, 16))
    q[0, :4] = pool[::5][:4]                   # deep buckets
    q[1, 3] = q[1, 3] ^ pool.dtype.type(0x10)  # a miss (odd pool)
    q[2, 5] = sent
    q[3, :] = sent
    q[4, 7] = pool.max() + pool.dtype.type(2)  # past the last feature
    return ft, c, q


def _jax_probe(ft, c, q, alt, pb):
    with jax.enable_x64(ft.unique_features.dtype == np.uint64):
        arrs, prefix, bits = _jax_csr(ft)
        out = jrows.probe_rows(jnp.asarray(q), *arrs, c, prefix, bits, 0,
                               dense=False, alt_runs=alt, pack_bits=pb)
        return [np.asarray(x) for x in out]


def _port_feats(q):
    return torch.from_numpy(q.view(np.int64 if q.dtype == np.uint64
                                   else np.int32))


@pytest.mark.parametrize("alt", [0, 256])
@pytest.mark.parametrize("pb", [0, 15])
@pytest.mark.parametrize("kind", ["u32", "u32-b9", "u64"])
def test_csr_probe_rows_matches_jax(monkeypatch, kind, pb, alt):
    """The CSR probe through csr_decode's plain version equals JAX's
    dense=False probe: u32 features found through the bucket-row index
    (B9's plain version, under MC_PROBE_PALLAS=bucket too, the index
    staged as its pair-packed view), u64 features through the search."""
    plain = {"csr": 0, "b9": 0}
    real_csr, real_b9 = D.csr_decode_plain, D.bucket_decode_plain
    monkeypatch.setattr(D, "csr_decode_plain", lambda *a: plain.update(
        csr=plain["csr"] + 1) or real_csr(*a))
    monkeypatch.setattr(D, "bucket_decode_plain", lambda *a: plain.update(
        b9=plain["b9"] + 1) or real_b9(*a))
    if kind == "u32-b9":
        monkeypatch.setenv("MC_PROBE_PALLAS", "bucket")
    else:
        monkeypatch.delenv("MC_PROBE_PALLAS", raising=False)
    ft, c, q = _probe_case(kind.split("-")[0])
    tables = _tables(ft, c)
    assert tables.csr and tables.dense is False
    assert (tables.bucket_rows is None) == (kind == "u64")
    want = _jax_probe(ft, c, q, alt, pb)
    got = trows.probe_rows(_port_feats(q), tables, alt_runs=alt,
                           pack_bits=pb)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), w)
    rl = alt or c
    assert got[0].shape == (8, 16 * rl)
    lanes = got[0].numpy().reshape(8, 16, rl)
    assert (lanes[0, 0] != I32_MAX).sum() == c         # 150 deep, c kept
    assert (lanes[3] == I32_MAX).all()                 # sentinels
    assert plain == {"csr": 1, "b9": int(kind != "u64")}


@pytest.mark.parametrize("pb", [0, 15])
def test_csr_probe_of_an_empty_u64_part(pb):
    """An empty u64 part (JAX stages it as CSR, runner.py:530-540) finds
    no feature: every slot is padding. JAX's probe of it fails, its
    gather of the empty location arrays out of range (ROADMAP queue C,
    faults of the JAX package)."""
    ft = FeatureTable.build(np.zeros(0, np.uint64), np.zeros(0, np.uint64))
    q = np.array([[1, 2, 2**64 - 1]], np.uint64)
    tables = _tables(ft, 3)
    got = trows.probe_rows(_port_feats(q), tables, alt_runs=0, pack_bits=pb)
    for g in got[:1 if pb else 2]:
        assert g.shape == (1, 9) and (g.numpy() == I32_MAX).all()
    with pytest.raises(TypeError, match="out of range"):
        _jax_probe(ft, 3, q, 0, pb)


def test_csr_decode_checks_its_inputs():
    """The wrapper refuses what its kernel cannot take: slots past the
    output lanes, int32 offsets, a found mask of another length."""
    idx = torch.zeros(4, dtype=torch.int32)
    found = torch.ones(4, dtype=torch.bool)
    offs = torch.tensor([0, 2], dtype=torch.int64)
    loc = torch.arange(2, dtype=torch.int32)
    assert len(D.csr_decode(idx, found, offs, loc, loc, 2, 2, 1, 0)) == 2
    for bad in (dict(c=3, rl=2), dict(offsets=offs.to(torch.int32)),
                dict(found=found[:3])):
        kw = dict(idx=idx, found=found, offsets=offs, loc_tgt=loc,
                  loc_win=loc, c=2, rl=2, f=1, pack_bits=0)
        kw.update(bad)
        with pytest.raises(ValueError):
            D.csr_decode(**kw)


# ------------------------------------------------------ row steps
@pytest.fixture(scope="module", params=[16, 18], ids=["k16", "k18"])
def step_case(request):
    return _step_case(request.param)


@pytest.fixture(scope="module")
def step_case16():
    return _step_case(16)


def _step_case(k):
    """K = 2 stacks of 32 reads of 100 bp at k = 16 (u32) or 18 (u64),
    s = 16, and a table of their features: each distinct feature at its
    read's target plus 0-5 random locations, every fifth one 150 deep
    (past the 100 slots a feature the steps take, so that a deep bucket
    may lose its read's own location); the port's CSR tables and JAX's
    CSR arrays."""
    rng = np.random.default_rng(40 + k)
    K, B, W = 2, 32, 128
    codes = np.full((K, B, 1, W), 4, np.uint8)
    codes[..., :100] = rng.integers(0, 4, (K, B, 1, 100))
    lens = np.full((K, B, 1), 100, np.int32)
    lens[0, 3, 0] = 12
    mwir = np.full((K, B), 2, np.int32)
    with jax.enable_x64(k > 16):
        feats = np.asarray(jax_sketch(jnp.asarray(codes.reshape(-1, W)),
                                      jnp.asarray(lens.reshape(-1)), k=k,
                                      sketchlen=16))
    sent = feats.dtype.type(np.iinfo(feats.dtype).max)
    feats = feats.reshape(K * B, 16)
    fs, ts, ws, seen = [], [], [], set()
    for r in range(K * B):
        for f in np.unique(feats[r]):
            if f == sent or int(f) in seen:
                continue
            extra = 149 if len(seen) % 5 == 0 else int(rng.integers(0, 6))
            seen.add(int(f))
            fs += [f] * (1 + extra)
            ts += [r % NTGT] + rng.integers(0, NTGT, extra).tolist()
            ws += [r % 5 + 3] + rng.integers(0, 1000, extra).tolist()
    ft = FeatureTable.build(np.asarray(fs, feats.dtype), pack_locations(
        np.asarray(ts, np.uint32), np.asarray(ws, np.uint32)))
    c = 100
    with jax.enable_x64(k > 16):
        jx = _jax_csr(ft)
    return dict(codes=codes, lens=lens, mwir=mwir, ft=ft, c=c, k=k, K=K,
                B=B, tables=_tables(ft, c), jax=jx)


def _jax_tables(d):
    arrs, prefix, bits = d["jax"]
    lin = _lineages()
    return (*arrs, jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
            jnp.int32(ARGS[0]), jnp.float32(ARGS[1]), jnp.int32(ARGS[2]),
            jnp.int32(ARGS[3]), prefix), dict(
                slots_per_feature=d["c"], prefix_bits=bits, dense=False)


@pytest.mark.parametrize("route", ["fused", "fused-unpacked",
                                   "nonfused-allhits"])
def test_csr_query_step_rows_matches_jax(step_case, route):
    """query_step_rows on a CSR part, all nine QueryResult fields: the
    fused candidates (packed slots, B4's plain version; (tgt, win)
    slots, B5's), and the non-fused path with per-hit lists and 8
    candidates."""
    d = step_case
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              fused_candidates=True, emit_hits=False, pack_bits=15)
    if route == "fused-unpacked":
        kw.update(pack_bits=0)
    elif route == "nonfused-allhits":
        kw.update(max_candidates=8, fast_top2=False, fused_candidates=False,
                  emit_hits=True)
    codes, lens, mwir = d["codes"][0], d["lens"][0], d["mwir"][0]
    got = trows.query_step_rows(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(mwir), d["tables"], *ARGS, k=d["k"], sketchlen=16,
        windows_per_query=1, **kw)
    jtab, jkw = _jax_tables(d)
    with jax.enable_x64(d["k"] > 16):
        want = jrows.query_step_rows(
            jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
            *jtab, k=d["k"], sketchlen=16, windows_per_query=1,
            **jkw, **kw)
        want = {f: np.asarray(getattr(want, f)) for f in want._fields}
    for f, w in want.items():
        np.testing.assert_array_equal(getattr(got, f).numpy(), w,
                                      err_msg=f)
    assert (got.cls_tax.numpy() != 0).sum() > d["B"] // 2


def test_csr_scan_step_matches_jax(step_case):
    """The summary scan over K stacks on a CSR part: alternating 128-lane
    runs (c = 100, 16 features a read) into B4's plain version."""
    d = step_case
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              pack_bits=15)
    got = trows.query_step_rows_scan(
        torch.from_numpy(d["codes"]), torch.from_numpy(d["lens"]),
        torch.from_numpy(d["mwir"]), d["tables"], *ARGS, k=d["k"],
        sketchlen=16, windows_per_query=1, **kw)
    jtab, jkw = _jax_tables(d)
    with jax.enable_x64(d["k"] > 16):
        want = np.asarray(jrows.query_step_rows_scan(
            jnp.asarray(d["codes"]), jnp.asarray(d["lens"]),
            jnp.asarray(d["mwir"]), *jtab, k=d["k"], sketchlen=16,
            windows_per_query=1, fused_candidates=True, **jkw, **kw))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > d["K"] * d["B"] // 2


def test_csr_part_beside_a_dense_part_matches_jax(step_case16):
    """query_step_rows_multipart over two parts of the k = 16 table split
    by feature: the first staged as dense (tgt, win) rows, the second as
    CSR; packed slots, the fused candidates."""
    d = step_case16
    ft = d["ft"]
    half = ft.num_features // 2
    cut = int(ft.offsets[half])
    parts = [FeatureTable(ft.unique_features[:half],
                          ft.offsets[:half + 1].copy(), ft.locations[:cut]),
             FeatureTable(ft.unique_features[half:],
                          ft.offsets[half:] - cut, ft.locations[cut:])]
    c0 = min(parts[0].max_bucket_size, d["c"])
    lin = _lineages()
    brows, bits = tprobe.make_bucket_index(parts[0].unique_features)
    dense = tables_from_numpy(
        parts[0].unique_features, parts[0].offsets, parts[0].fused_rows(c0),
        brows, bits, lin, lin[:, 0].copy(), c0, 0, CPU)
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              fused_candidates=True, emit_hits=False, pack_bits=15)
    codes, lens, mwir = d["codes"][0], d["lens"][0], d["mwir"][0]
    got = trows.query_step_rows_multipart(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(mwir), [dense, _tables(parts[1], d["c"])], *ARGS,
        k=16, sketchlen=16, windows_per_query=1, **kw)
    a1, p1, b1 = _jax_csr(parts[1])
    jb0, _b = jprobe.make_bucket_index(parts[0].unique_features)
    want = jrows.query_step_rows_multipart(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
        (jnp.asarray(parts[0].unique_features), a1[0]),
        (jnp.asarray(parts[0].offsets.astype(np.int32)), a1[1]),
        (jnp.asarray(parts[0].fused_rows(c0)), a1[2]),
        (jnp.zeros((1,), jnp.int32), a1[3]),
        jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin), jnp.int32(ARGS[0]),
        jnp.float32(ARGS[1]), jnp.int32(ARGS[2]), jnp.int32(ARGS[3]),
        (jnp.asarray(jb0), p1), k=16, sketchlen=16,
        slots_per_feature=(c0, d["c"]), windows_per_query=1,
        prefix_bits=(bits, b1), prefix_steps=(0, 0), num_parts=2,
        dense=(True, False), **kw)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


def test_csr_part_is_never_probed_ahead(step_case):
    """Escalation needs head rows, and the prefetch a row layout
    (rows.py:785-786): a CSR part takes neither."""
    d = step_case
    feats = torch.zeros((2, 16), dtype=d["tables"].features.dtype)
    with pytest.raises(AssertionError):
        trows.probe_rows(feats, d["tables"], idx_pre=torch.zeros(
            32, dtype=torch.int32))
    with pytest.raises(AssertionError):
        trows.probe_rows_head(feats, d["tables"], 128, 15)


# ------------------------------------------------------ staging
@pytest.fixture(scope="module")
def dbfiles(tmp_path_factory):
    """The fixture's database at k = 16, at k = 18, and at k = 16 in two
    parts (`build -parts 2`)."""
    root = tmp_path_factory.mktemp("csrdb")
    dbs = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        for name, extra in (("k16", ["-parts", "1"]),
                            ("k18", ["-parts", "1", "-kmerlen", "18"]),
                            ("parts2", ["-parts", "2"])):
            dbs[name] = str(root / name)
            assert main(["build", dbs[name], f"{DATA}/genomes.fa",
                         "-taxonomy", f"{DATA}/taxonomy"] + extra) == 0
    return dbs


def _csr_budget(db):
    """The CSR bytes of the database's parts, each with its bucket
    index (the port's budget rule)."""
    total = 0
    for p in Database.load(db).parts:
        idx = _index(p)
        total += csr_bytes(p, 0 if idx is None else idx[0].nbytes)
    return total


def _port_layout(db, budget=None):
    with contextlib.ExitStack() as st:
        if budget is not None:
            mp = st.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(R, "hbm_budget_bytes", lambda device: budget)
        return R.QueryRunner(Database.load(db), QueryOptions()).layout


def _jax_layout(db, budget=None):
    """JAX's runner's layout tags on the same database (and budget)."""
    from metacache_tpu.utils import platform
    with contextlib.ExitStack() as st:
        if budget is not None:
            mp = st.enter_context(pytest.MonkeyPatch.context())
            mp.setattr(platform, "hbm_budget_bytes", lambda: budget)
        jdb = JDatabase.load(db)
        with jax.enable_x64(jdb.parts[0].unique_features.dtype == np.uint64):
            return ", ".join(str(t) for t in jrunner.QueryRunner(
                jdb, JQueryOptions())._dense)


@pytest.mark.parametrize("case", ["builder-memoryerror", "device-layout-0",
                                  "k18-device-layout-0", "k18-builder"])
def test_staging_takes_csr_where_jax_does(dbfiles, monkeypatch, case):
    """The builder's MemoryError (no row layout within the CSR bytes of
    the database), then CSR; MC_DEVICE_LAYOUT=0 at that budget, the host
    rule, then CSR; u64 features under MC_DEVICE_LAYOUT=0, CSR at any
    budget; u64 features whose rows the budget does not hold, CSR. JAX's
    runner takes the same layout (its tag False)."""
    db = dbfiles["k18" if case.startswith("k18") else "k16"]
    budget = _csr_budget(db)
    if case.endswith("device-layout-0"):
        monkeypatch.setenv("MC_DEVICE_LAYOUT", "0")
    if case == "k18-device-layout-0":
        budget = None
    assert _port_layout(db, budget) == _jax_layout(db, budget) == "False"


def test_staging_of_a_budget_below_csr_raises_jax_advice(dbfiles):
    """A budget below the port's CSR bytes raises MemoryError with JAX's
    advice (table.py:395-400); below JAX's own CSR bytes (int32 offsets,
    no bucket index) JAX's runner raises it too."""
    db = dbfiles["k16"]
    with pytest.raises(MemoryError, match="even in CSR layout.*-table-shards"):
        _port_layout(db, _csr_budget(db) - 1)
    for layout in (_port_layout, _jax_layout):
        with pytest.raises(MemoryError, match="-table-shards"):
            layout(db, 1 << 16)


def _runner(db):
    return R.QueryRunner(Database.load(db), QueryOptions())


@pytest.mark.parametrize("case", ["collision", "empty"])
def test_u64_part_staging_takes_csr_where_jax_does(dbfiles, case):
    """A u64 part whose bucket index keeps a low-32 collision at 26 bits,
    where the builder raises MemoryError in both packages, and an empty
    u64 part: the port stages CSR, as JAX's runner does
    (runner.py:505-540)."""
    if case == "collision":
        f = np.asarray([0x1234567800000001, 0x1234567900000001], np.uint64)
        ft = FeatureTable.build(f, pack_locations(
            np.asarray([1, 2], np.uint32), np.asarray([3, 4], np.uint32)))
        assert tprobe.collision_free_bits64(f) > 26
        ltgt, lwin = unpack_locations(ft.locations)
        with pytest.raises(MemoryError, match="collision"):
            with jax.enable_x64(True):
                jtd.device_layout_from_csr(f, ft.offsets, ltgt, lwin,
                                           cap=254)
    else:
        ft = FeatureTable.build(np.zeros(0, np.uint64),
                                np.zeros(0, np.uint64))
    r = _runner(dbfiles["k18"])
    tables, _dense_b, staged_b = r._stage_part(
        ft, r.lineages, r.merge_tax, r.budget_bytes)
    assert tables.csr and tables.wide and tables.dense is False
    assert staged_b == csr_bytes(ft) == tables.nbytes() - \
        tables.lineages.nbytes - tables.merge_tax.nbytes
    if case == "collision":
        q = torch.from_numpy(f.view(np.int64)[None])
        pk, _ = trows.probe_rows(q, tables, pack_bits=15)
        assert pk.tolist() == [[(1 << 15) | 3, (2 << 15) | 4]]


def test_staged_csr_bytes_are_the_tables(dbfiles, monkeypatch):
    """The staged bytes the budget counts are the CSR part's buffers: the
    features, offsets, targets, windows and the bucket index; the
    staging's seconds split into the host's (unpack_locations among
    them) and the copy to the device."""
    db = dbfiles["k16"]
    monkeypatch.setattr(R, "hbm_budget_bytes",
                        lambda device: _csr_budget(db))
    r = _runner(db)
    t = r.tables
    assert t.csr and t.bucket_rows.shape[1] == 128
    assert r.staged_bytes == t.nbytes() - t.lineages.nbytes - \
        t.merge_tax.nbytes
    assert t.offsets.dtype == torch.int64 and t.loc_tgt.dtype == torch.int32
    [s] = r.stage_seconds
    assert s["layout"] == "False" and 0 < s["unpack_s"] < s["host_s"] and \
        s["card_s"] > 0
    c = t.cpu_copy()
    assert c.csr and c.nbytes() == t.nbytes() and c.device.type == "cpu"


# ------------------------------------------------------ goldens
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


def _stats(lines):
    i = next(j for j, l in enumerate(lines) if "queries:" in l)
    return lines[i:]


CSR_GOLDENS = {
    "fmt_0.txt": [f"{DATA}/reads_single.fa"],
    "fmt_14.txt": [f"{DATA}/reads_single.fa", "-lowest", "species"],
    "classified_single_fa.txt": [
        f"{DATA}/reads_single.fa", "-precision", "-ground-truth",
        "-tophits", "-allhits", "-hits-per-ref", "-abundances",
        "-abundance-per", "species"],
    "classified_long_fa.txt": [f"{DATA}/reads_long.fa", "-precision",
                               "-ground-truth", "-tophits"],
    "classified_pairfiles.txt": [f"{DATA}/reads_pair1.fa",
                                 f"{DATA}/reads_pair2.fa", "-pairfiles",
                                 "-precision", "-ground-truth", "-tophits"],
    "k18_single.txt": [f"{DATA}/reads_single.fa", "-mapped-only",
                       "-precision", "-ground-truth", "-tophits"],
    "k18_pairfiles.txt": [f"{DATA}/reads_pair1.fa", f"{DATA}/reads_pair2.fa",
                          "-pairfiles", "-precision", "-tophits"],
}


@pytest.fixture
def csr_only(monkeypatch):
    """Patch the port's budget to a database's CSR bytes and count the
    CSR decodes (csr_decode's plain version) and the runners' layouts."""
    seen = {"decodes": 0, "layouts": []}
    real, init = D.csr_decode_plain, R.QueryRunner.__init__

    def spy_init(self, *a, **k):
        init(self, *a, **k)
        seen["layouts"].append(self.layout)
    monkeypatch.setattr(D, "csr_decode_plain", lambda *a: seen.update(
        decodes=seen["decodes"] + 1) or real(*a))
    monkeypatch.setattr(R.QueryRunner, "__init__", spy_init)

    def at(db):
        monkeypatch.setattr(R, "hbm_budget_bytes",
                            lambda device: _csr_budget(db))
        return db
    return seen, at


@pytest.mark.parametrize("gold", sorted(CSR_GOLDENS))
def test_goldens_under_csr(dbfiles, csr_only, gold):
    """The reference goldens with every part in CSR: per read, long
    reads (the rank join and the fused kernels), pairs, taxon merging
    and per-hit lists on the non-fused path, k = 18 (the u64 search)."""
    seen, at = csr_only
    db = at(dbfiles["k18" if gold.startswith("k18") else "k16"])
    assert _query(db, CSR_GOLDENS[gold]) == _golden(gold)
    assert seen["layouts"] == ["False"] and seen["decodes"] > 0


@pytest.mark.parametrize("gold", ["fmt_0.txt", "k18_single.txt"])
def test_summary_under_csr(dbfiles, csr_only, gold):
    """-no-map (the summary scan on the runner's packed infeed) with the
    part in CSR: the per-read golden's summary statistics."""
    seen, at = csr_only
    db = at(dbfiles["k18" if gold.startswith("k18") else "k16"])
    assert _stats(_query(db, CSR_GOLDENS[gold] + ["-no-map"])) == \
        _stats(_golden(gold))
    assert seen["layouts"] == ["False"] and seen["decodes"] > 0


@pytest.mark.parametrize("pairing", ["-pairfiles", "-pairseq"])
def test_paired_summary_under_csr(dbfiles, csr_only, monkeypatch, pairing):
    """-no-map on pairs (the paired scan, two windows a query) with the
    part in CSR: the per-read path's summary statistics."""
    seen, at = csr_only
    db = at(dbfiles["k16"])
    scans = []
    dispatch = R.QueryRunner._dispatch_scan_pair
    monkeypatch.setattr(R.QueryRunner, "_dispatch_scan_pair",
                        lambda self, *a, **k: scans.append(1) or
                        dispatch(self, *a, **k))
    files = [f"{DATA}/reads_pair1.fa", f"{DATA}/reads_pair2.fa"] \
        if pairing == "-pairfiles" else [f"{DATA}/reads_pairseq.fa"]
    per_read = _query(db, files + [pairing])
    assert _stats(_query(db, files + [pairing, "-no-map"])) == \
        _stats(per_read)
    assert scans and seen["layouts"] == ["False", "False"]


def test_k18_golden_under_device_layout_0(dbfiles, csr_only, monkeypatch):
    """u64 features under MC_DEVICE_LAYOUT=0 stage CSR at the full
    budget, as JAX's runner does, and give the k18 golden."""
    seen, _at = csr_only
    monkeypatch.setenv("MC_DEVICE_LAYOUT", "0")
    assert _query(dbfiles["k18"], CSR_GOLDENS["k18_single.txt"]) == \
        _golden("k18_single.txt")
    assert seen["layouts"] == ["False"]


@pytest.mark.parametrize("flags", [[], ["-no-map"],
                                   ["-lowest", "species"]])
def test_multipart_golden_with_one_part_in_csr(dbfiles, csr_only,
                                               monkeypatch, flags):
    """`build -parts 2` with the budget of the first part's dense rows
    and the second part's CSR bytes: the first part stages dense, the
    second, left the rest, CSR; the lines equal the single-part golden's
    (fmt_0, its summary, fmt_14)."""
    seen, _at = csr_only
    db = dbfiles["parts2"]
    parts = Database.load(db).parts
    r = _runner(db)
    budget = r._stage_part(parts[0], r.lineages, r.merge_tax,
                           r.budget_bytes)[2] + \
        csr_bytes(parts[1], _index(parts[1])[0].nbytes)
    monkeypatch.setattr(R, "hbm_budget_bytes", lambda device: budget)
    seen["layouts"].clear()
    gold = "fmt_14.txt" if "-lowest" in flags else "fmt_0.txt"
    ours = _query(db, [f"{DATA}/reads_single.fa"] + flags)
    if "-no-map" in flags:
        assert _stats(ours) == _stats(_golden(gold))
    else:
        assert ours == _golden(gold)
    [layout] = seen["layouts"]
    assert layout.endswith(", False") and not layout.startswith("False")


def test_build_debug_prints_the_phases(dbfiles, monkeypatch, capsys):
    """MC_BUILD_DEBUG=1: the device builder's per-phase progress
    (table_device.py:881-925) and each staged part's layout, bytes and
    seconds."""
    monkeypatch.setenv("MC_BUILD_DEBUG", "1")
    db = dbfiles["k16"]
    monkeypatch.setattr(R, "hbm_budget_bytes", lambda device: _csr_budget(db))
    _runner(db)
    out = capsys.readouterr().out
    assert "layout: head" not in out     # the builder found no head
    assert "] staged part 1: layout False," in out
    monkeypatch.undo()
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("MC_BUILD_DEBUG", "1")
    main(["build", str(os.path.dirname(db)) + "/dbg", f"{DATA}/genomes.fa",
          "-taxonomy", f"{DATA}/taxonomy"])
    out = capsys.readouterr().out
    for phase in ("phase1 stats", "phase1 done", "phase2 place",
                  "phase2 done", "sorted group 0", "meta done",
                  "layout: head 2 of 2 slots (dense)"):
        assert f"] {phase}" in out, phase
