"""metacache_tpu_torch's pipelined scan (MC_PREFETCH), fused escalation
dispatch (MC_ESC_FUSED, MC_ESC_B2), its pinned infeed's host ring and the
switch of the native line formatter (MC_NATIVE_FMT) against
metacache_tpu on the CPU, where the side stream is no stream and the
steps run in issue order: the prefetched scan and head scan against
JAX's prefetch carry and the port's plain order, on dense packed and
(tgt, win) rows, two-tier rows, classed cells and u64 dense and two-tier
rows; the fused dispatch against JAX's in all five outputs; the runner
under every knob combination against JAX's runner under the same
environment; and the per-read lines without the native formatter
against the reference goldens. Tolerance 0 (integer outputs)."""
import contextlib
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metacache_tpu.cli.main import main as jax_main
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops import table_device as jtd
from metacache_tpu.ops.probe import make_bucket_index
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu.ops.table import FeatureTable, pack_locations
from metacache_tpu_torch.classify import output as out_mod
from metacache_tpu_torch.classify.runner import QueryRunner
from metacache_tpu_torch.cli.main import main
from metacache_tpu_torch.db.state import tables_from_device, \
    tables_from_numpy
from metacache_tpu_torch.device import Infeed
from metacache_tpu_torch.ops import rows as trows
from metacache_tpu_torch.ops import table_device as ttd
from metacache_tpu_torch.ops.table import unpack_locations
from test_torch_cuda import pack_2bit
from test_torch_rows import _jax_tables, _layout, _reads, _tables
from test_torch_rows import strain_db  # noqa: F401 (a fixture)
from test_torch_u64 import ARGS as U64_ARGS
from test_torch_u64 import wide_case  # noqa: F401 (a fixture)

torch.set_num_threads(2)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
ACGT = np.frombuffer(b"ACGT", np.uint8)
CPU = torch.device("cpu")
ARGS = (1, 0.5, 19, 0)          # hits_min, hits_diff, highest, merge rank


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def _lineages(n):
    lin = np.zeros((n, 21), np.int32)
    lin[:, 0] = -np.arange(n) - 1
    lin[:, 4] = np.arange(n) // 8 + 100
    lin[:, 20] = 1
    return lin


# ----------------------------------------------------- dense rows
@pytest.mark.parametrize("slots", ["packed", "lanes"])
def test_prefetch_scan_dense_matches_jax(strain_db, slots):
    """query_step_rows_scan(prefetch=True) on dense rows, packed slots
    (B4) or (tgt, win) lanes (B5), the runner's 2-bit packed infeed: equal
    to JAX's prefetch carry and to the port's plain order."""
    d = strain_db
    bits = d["wbits"] if slots == "packed" else 0
    K, B = 3, 16
    reads = _reads(d, K * B, 100, seed=9)
    c4 = np.zeros((K * B, 128), np.uint8)
    c4[:, :100] = reads
    packed = pack_2bit(c4).reshape(K, B, 1, 32)
    lens = np.full((K, B, 1), 100, np.uint8)
    lens[1, 5, 0] = 40
    lens[2, 0, 0] = 0               # an empty read
    mwir = np.full((K, B), 2, np.uint8)
    tf, to, lt, lw, mt, lg = _jax_tables(d, bits)
    want = np.asarray(jrows.query_step_rows_scan(
        jnp.asarray(packed), jnp.asarray(lens), jnp.asarray(mwir), tf, to,
        lt, lw, mt, lg, jnp.int32(5), jnp.float32(1.0), jnp.int32(19),
        jnp.int32(0), jnp.asarray(d["brows"]), k=16, sketchlen=16,
        slots_per_feature=d["spf"], windows_per_query=1, max_candidates=2,
        prefix_bits=d["bits"], dense=_layout(bits), walk_elems=32,
        fast_top2=True, fused_candidates=True, pack_bits=bits,
        infeed_packed=True, prefetch=True))
    t = _tables(d, bits)
    kw = dict(k=16, sketchlen=16, windows_per_query=1, max_candidates=2,
              walk_elems=32, fast_top2=True, pack_bits=bits,
              infeed_packed=True)
    args = [torch.from_numpy(x) for x in (packed, lens, mwir)]
    got = trows.query_step_rows_scan(*args, t, 5, 1.0, 19, 0,
                                     prefetch=True, **kw)
    plain = trows.query_step_rows_scan(*args, t, 5, 1.0, 19, 0, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert (want != 0).sum() > K * B // 2


# ------------------------------------------------------ u64 rows
@pytest.mark.parametrize("layout", ["dense", "two_tier"])
def test_prefetch_scan_u64_matches_jax(wide_case, layout):
    """The prefetched scan on u64 dense and two-tier rows (k = 18, the
    64-bit bucket index in stage 1) against JAX's and the plain order."""
    d = wide_case
    tables, jtab, jkw = d["layouts"][layout]
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              pack_bits=jkw["pack_bits"])
    args = [torch.from_numpy(d[x]) for x in ("codes", "lens", "mwir")]
    got = trows.query_step_rows_scan(*args, tables, *U64_ARGS, k=18,
                                     sketchlen=16, windows_per_query=1,
                                     prefetch=True, **kw)
    plain = trows.query_step_rows_scan(*args, tables, *U64_ARGS, k=18,
                                       sketchlen=16, windows_per_query=1,
                                       **kw)
    with jax.enable_x64(True):
        want = np.asarray(jrows.query_step_rows_scan(
            jnp.asarray(d["codes"]), jnp.asarray(d["lens"]),
            jnp.asarray(d["mwir"]), *jtab, k=18, sketchlen=16,
            windows_per_query=1, fused_candidates=True, prefetch=True,
            **{**jkw, **kw}))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())


# ---------------------------------- two-tier rows and classed cells
@pytest.fixture(scope="module")
def read_case():
    """K = 2 stacks of 64 reads of 100 bp (one empty) and a table built
    from their own sketches (tests/test_rows_fast.py::test_redo_scan_
    matches_full_scan): the even reads' features 70 locations deep,
    deeper than a two-tier head of 4 and than the classed cells' 61, the
    odd reads' shallow; staged as two-tier host rows (head 4) and, by
    both packages' device builders, as classed cells (MC_CLASSED=1)."""
    rng = np.random.default_rng(5)
    K, B, WL, NTGT = 2, 64, 128, 40
    codes = rng.integers(0, 4, (K, B, 1, WL), dtype=np.uint8)
    lens = np.full((K, B, 1), 100, np.int32)
    lens[1, 7, 0] = 0
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
        for j in range(70):
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
                            max_locations_per_feature=254)
    spf, hsl, wbits = ft.max_bucket_size, 4, 6
    assert spf == 70
    lin = _lineages(NTGT)
    head, ovf = ft.fused_rows_two_tier(spf, hsl, slot_bits=wbits)
    brows, bits = make_bucket_index(ft.unique_features)
    layouts = {"two_tier": (
        tables_from_numpy(ft.unique_features, ft.offsets, head, brows, bits,
                          lin, lin[:, 0].copy(), spf, wbits, CPU,
                          ovf_rows=ovf, head_slots=hsl),
        tuple(jnp.asarray(x) for x in (
            ft.unique_features, ft.offsets.astype(np.int32), head, ovf,
            brows)),
        dict(slots_per_feature=spf, prefix_bits=bits,
             dense=("two_tier", hsl, False, False, wbits), pack_bits=wbits))}
    csr = (ft.unique_features, ft.offsets, *unpack_locations(ft.locations))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_CLASSED", "1")
        kw = dict(cap=254, budget_bytes=4 << 20, allow_dense=False)
        jc = jtd.device_layout_from_csr(*csr, **kw)
        tc = ttd.device_layout_from_csr(*csr, device=CPU, **kw)
    assert jc.classed and tc.classed and jc.head_slots == 61
    layouts["classed"] = (
        tables_from_device(tc, lin, lin[:, 0].copy()),
        (jc.uniq, jc.offsets, jc.head, jc.ovf, jc.brows),
        dict(slots_per_feature=jc.spf, prefix_bits=jc.bbits,
             dense=("classed", jc.head_slots, jc.packed, jc.ovf_packed,
                    jc.slot_bits), pack_bits=jc.slot_bits))
    return dict(codes=codes, lens=lens, mwir=mwir, layouts=layouts, lin=lin,
                K=K, B=B)


def _jargs(d, layout):
    """JAX's table arguments of a read_case layout (prefix index last)
    and its keyword arguments."""
    _t, (uniq, offsets, rows, ovf, brows), jkw = d["layouts"][layout]
    lin = d["lin"]
    return (uniq, offsets, rows, ovf, jnp.asarray(lin[:, 0].copy()),
            jnp.asarray(lin), jnp.int32(ARGS[0]), jnp.float32(ARGS[1]),
            jnp.int32(ARGS[2]), jnp.int32(ARGS[3]), brows), jkw


def _host(d):
    return [torch.from_numpy(d[x]) for x in ("codes", "lens", "mwir")]


def _jhost(d):
    return [jnp.asarray(d[x]) for x in ("codes", "lens", "mwir")]


def _jax_out(w, name, tables):
    """A JAX output as the port gives it: u32 features as int32 bit
    patterns; two-tier feature rows clamped into the table, as the port
    clamps a missing feature's row before B6 and B7 read it and JAX
    clamps inside its gathers (the sentinel features of an empty read)."""
    w = np.asarray(w)
    if w.dtype == np.uint32:
        return w.view(np.int32)
    if name == "idx" and not tables.classed:
        return np.minimum(w, tables.num_features - 1)
    return w


def _mask(over):
    bits = np.asarray(over).reshape(-1)
    return (((bits[:, None] >> np.arange(32)) & 1).astype(bool)
            .reshape(-1))


@pytest.mark.parametrize("layout", ["two_tier", "classed"])
def test_prefetch_scan_two_tier_and_classed_matches_jax(read_case, layout):
    """The prefetched full-depth scan (B7 on two-tier rows, the classed
    cells' torch decode, both on stage 1's bucket probes) against JAX's
    prefetch carry and the plain order."""
    d = read_case
    tables = d["layouts"][layout][0]
    jargs, jkw = _jargs(d, layout)
    kw = dict(k=16, sketchlen=16, windows_per_query=1, max_candidates=2,
              walk_elems=32, fast_top2=True, pack_bits=jkw["pack_bits"])
    got = trows.query_step_rows_scan(*_host(d), tables, *ARGS,
                                     prefetch=True, **kw)
    plain = trows.query_step_rows_scan(*_host(d), tables, *ARGS, **kw)
    want = np.asarray(jrows.query_step_rows_scan(
        *_jhost(d), *jargs, fused_candidates=True, prefetch=True,
        **{**jkw, **kw}))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert (want != 0).sum() > d["K"] * d["B"] // 4


def _head(d, layout, prefetch):
    tables = d["layouts"][layout][0]
    pack = d["layouts"][layout][2]["pack_bits"]
    return trows.query_step_rows_scan_head(
        *_host(d), tables, *ARGS, k=16, sketchlen=16, max_candidates=2,
        walk_elems=32, pack_bits=pack, prefetch=prefetch)


@pytest.mark.parametrize("layout", ["two_tier", "classed"])
def test_prefetch_head_scan_matches_jax(read_case, layout):
    """Escalation phase 1 with the prefetch carry (B6 on two-tier heads,
    the classed head cells): cls, over bits, feats and idx equal JAX's
    (prefetch=True, return_feats=True) and the plain order's. JAX's
    phase 1 runs its non-fused candidates here: its fused kernel takes
    presorted runs only where they fill the padded row, and F x pow2(4)
    = 64 lanes pad to 128."""
    d = read_case
    jargs, jkw = _jargs(d, layout)
    got = _head(d, layout, True)
    plain = _head(d, layout, False)
    want = jrows.query_step_rows_scan_head(
        *_jhost(d), *jargs, k=16, sketchlen=16, max_candidates=2,
        walk_elems=32, fused_candidates=False, prefetch=True,
        return_feats=True, **jkw)
    tables = d["layouts"][layout][0]
    for name, g, p, w in zip(("cls", "over", "feats", "idx"), got, plain,
                             want):
        np.testing.assert_array_equal(g.numpy(), p.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), _jax_out(w, name, tables),
                                      err_msg=name)
    mask = _mask(got[1])
    assert 0 < mask.sum() < d["K"] * d["B"]       # both phases exercised


@pytest.mark.parametrize("layout", ["two_tier", "classed"])
@pytest.mark.parametrize("b2", [32, 64])
def test_fused_dispatch_matches_jax(read_case, layout, b2):
    """query_step_rows_scan_head_fused: phase 1 of the stacks and the
    full-depth redo of a slice of b2 flagged reads a batch (padded with
    sentinel features) in one dispatch, all five outputs equal JAX's twin
    (tests/test_rows_fast.py::test_fused_escalation_scan_matches_
    separate) and the port's phase 1 and redo run apart."""
    d = read_case
    K = d["K"]
    tables = d["layouts"][layout][0]
    jargs, jkw = _jargs(d, layout)
    cls1, over, fk, ik = _head(d, layout, True)
    idxs = np.nonzero(_mask(over))[0][:K * b2]
    F = 16
    pad = K * b2 - len(idxs)
    rf = torch.cat([fk.reshape(-1, F)[idxs],
                    torch.full((pad, F), -1, dtype=torch.int32)])
    ri = torch.cat([ik.reshape(-1, F)[idxs],
                    torch.zeros((pad, F), dtype=torch.int32)])
    rm = torch.full((K, b2), 2, dtype=torch.int32)
    rf, ri = rf.reshape(K, b2, F), ri.reshape(K, b2, F)
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              pack_bits=jkw["pack_bits"])
    got = trows.query_step_rows_scan_head_fused(
        *_host(d), rf, ri, rm, tables, *ARGS, k=16, sketchlen=16, **kw)
    apart = (cls1, over, fk, ik, trows.query_step_rows_redo_scan(
        rf, ri, rm, tables, *ARGS, **kw))
    want = jrows.query_step_rows_scan_head_fused(
        *_jhost(d), jnp.asarray(rf.numpy().view(np.uint32)),
        jnp.asarray(ri.numpy()), jnp.asarray(rm.numpy()), *jargs, k=16,
        sketchlen=16, fused_candidates=False, **{**jkw, **kw})
    for name, g, a, w in zip(("cls1", "over", "feats", "idx", "cls2"), got,
                             apart, want):
        np.testing.assert_array_equal(g.numpy(), a.numpy(), err_msg=name)
        np.testing.assert_array_equal(g.numpy(), _jax_out(w, name, tables),
                                      err_msg=name)
    assert (got[4].numpy() != 0).sum() > 0


# ------------------------------------------------ the pinned ring
def test_infeed_ring_keeps_stacks_apart():
    """Infeed on the CPU: stacks of different contents (and widths) put
    one after another through a ring of 4 buffers: each put's arrays come
    back whole, aligned and in the dtype given, and the last 4 puts' are
    intact after the ring has come round; a staged stack written in place
    comes back as written."""
    feed = Infeed(CPU, 4)
    got, want = [], []
    rng = np.random.default_rng(1)
    for i in range(6):
        rows = rng.integers(0, 256, (64 + 32 * i, 3 + i), dtype=np.uint8)
        lens = rng.integers(0, 128, 64 + 32 * i).astype(np.int32)
        sel = np.arange(5 + i, dtype=np.int64)
        out = feed.put(rows[:, :2 + i], lens, sel)
        assert [x.dtype for x in out] == [torch.uint8, torch.int32,
                                          torch.int64]
        assert all(x.storage_offset() * x.element_size() % Infeed.ALIGN
                   == 0 for x in out)
        got.append(out)
        want.append((rows[:, :2 + i], lens, sel))
    for out, arrays in list(zip(got, want))[-4:]:
        for x, a in zip(out, arrays):
            np.testing.assert_array_equal(x.numpy(), a)
    w, m = feed.stage(((8, 5), np.uint8), ((8,), np.int32))
    w[...] = 7
    m[:] = np.arange(8)
    tw, tm = feed.send()
    assert (tw == 7).all() and torch.equal(tm, torch.arange(8,
                                                           dtype=torch.int32))


# ------------------------------------------------ the runner
@pytest.fixture(scope="module")
def deep_tax_db(tmp_path_factory):
    """The deep-bucket genomes of tests/test_torch_escalation.py::deep_db
    (2 x 70 strains of 20 kbp and 6 unique genomes, buckets ~70 deep)
    with a taxonomy (a species a strain group, one a unique genome),
    10,240 reads of 60-119 bp (five stacks of 2 x 1024 under
    MC_SCAN_K=2, so that phase 1 dispatches after flagged reads were
    collected) and 2,048 pairs of mates of 60-119 bp from fragments of
    150-300 bp. -> (database, reads, pair files, a cache of JAX's
    summaries by environment)."""
    tmp = tmp_path_factory.mktemp("deeptax")
    rng = np.random.default_rng(3)
    genomes, species = [], []
    for sp in range(2):
        base = rng.integers(0, 4, 20000, dtype=np.uint8)
        for _s in range(70):
            g = base.copy()
            pos = rng.integers(0, 20000, 40)
            g[pos] = rng.integers(0, 4, 40)
            genomes.append(g)
            species.append(sp)
    for u in range(6):
        genomes.append(rng.integers(0, 4, 20000, dtype=np.uint8))
        species.append(2 + u)
    with open(tmp / "g.fa", "wb") as fh:
        for i, g in enumerate(genomes):
            fh.write(b">GEN%05d.1 taxid|%d|\n" % (i, 1000 + species[i]) +
                     ACGT[g].tobytes() + b"\n")
    tax = tmp / "taxonomy"
    tax.mkdir()
    (tax / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tgenus\t|\n" + "".join(
            f"{1000 + s}\t|\t2\t|\tspecies\t|\n" for s in range(8)))
    (tax / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "2\t|\tGenus\t|\t\t|\tscientific name\t|\n" + "".join(
            f"{1000 + s}\t|\tspecies {s}\t|\t\t|\tscientific name\t|\n"
            for s in range(8)))
    (tax / "merged.dmp").write_text("")

    def draw(n):
        gs = rng.integers(0, len(genomes), n)
        ln = rng.integers(60, 120, n)
        pos = rng.integers(0, 20000 - 320, n)
        return gs, ln, pos
    with open(tmp / "r.fa", "wb") as fh:
        for i, (g, ln, p) in enumerate(zip(*draw(10240))):
            fh.write(b">r%d\n" % i + ACGT[genomes[g][p:p + ln]].tobytes() +
                     b"\n")
    with open(tmp / "p_1.fa", "wb") as f1, open(tmp / "p_2.fa", "wb") as f2:
        gs, l1, pos = draw(2048)
        l2 = rng.integers(60, 120, 2048)
        frag = rng.integers(150, 300, 2048)
        for i in range(2048):
            g = genomes[gs[i]]
            m1 = g[pos[i]:pos[i] + l1[i]]
            e = pos[i] + frag[i]
            m2 = 3 - g[e - l2[i]:e][::-1]
            f1.write(b">p%d/1\n" % i + ACGT[m1].tobytes() + b"\n")
            f2.write(b">p%d/2\n" % i + ACGT[m2].tobytes() + b"\n")
    db = str(tmp / "db")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_TORCH_DEVICE", "cpu")
        assert main(["build", db, str(tmp / "g.fa"), "-taxonomy",
                     str(tax)]) == 0
    return db, str(tmp / "r.fa"), [str(tmp / "p_1.fa"),
                                   str(tmp / "p_2.fa")], {}


def _strip(text):
    drop = ("# time:", "# speed:", "threads", "Reading database", DATA,
            "/tmp")
    return [l for l in text.splitlines() if not any(d in l for d in drop)]


def _run(cli, args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli(args) == 0
    return _strip(buf.getvalue())


def _summary(deep, monkeypatch, env, pairs=False):
    """The port's and JAX's summary queries of the deep database's reads
    (or pairs) under MC_DENSE_LIMIT=1 (classed cells), MC_SCAN_K=2 and
    ``env``; JAX's taken once an environment. -> (the port's lines,
    JAX's, the port's runner)."""
    db, reads, pair_files, cache = deep
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    monkeypatch.setenv("MC_SCAN_K", "2")
    for k in ("MC_PREFETCH", "MC_ESC_FUSED", "MC_ESC_B2", "MC_CLASSED"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = ["query", db] + (pair_files + ["-pairfiles"] if pairs
                            else [reads]) + ["-no-map", "-batch-size", "512"]
    key = (pairs, tuple(sorted(env.items())))
    if key not in cache:
        cache[key] = _run(jax_main, args)
    runners = []
    init = QueryRunner.__init__

    def spy(self, *a, **kw):
        init(self, *a, **kw)
        runners.append(self)
    monkeypatch.setattr(QueryRunner, "__init__", spy)
    return _run(main, args), cache[key], runners[0]


@pytest.mark.parametrize("b2", [None, "64"])
@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_runner_knobs_match_jax_runner(deep_tax_db, monkeypatch, prefetch,
                                       fused, b2):
    """The summary of 10,240 reads through the classed cells under
    MC_PREFETCH x MC_ESC_FUSED x MC_ESC_B2 equals JAX's runner's under
    the same environment, with the same escalated reads each time; the
    redo takes the route the knobs name: phase 1's sketches (and, with
    the fused dispatch, slices of MC_ESC_B2 reads inside a later phase
    1) where the scan prefetches, else the reads' rows through the
    full-depth scan."""
    env = {"MC_PREFETCH": prefetch, "MC_ESC_FUSED": fused}
    if b2:
        env["MC_ESC_B2"] = b2
    got, want, r = _summary(deep_tax_db, monkeypatch, env)
    assert got == want
    assert r.tables.classed and r._escalation_ok()
    routes = {x[0] for x in r.redo_dispatches}
    width = int(b2 or 512)                  # batch_reads // 2
    if prefetch == "0":
        assert routes == {"rows"}
    elif fused == "1":
        assert routes == {"fused", "feats"}
        assert {x[2] for x in r.redo_dispatches if x[0] == "fused"} == \
            {width}
    else:
        assert routes == {"feats"}
    assert sum(x[3] for x in r.redo_dispatches) == r.esc_reads
    cache = deep_tax_db[3]
    esc = cache.setdefault("esc_reads", r.esc_reads)
    assert r.esc_reads == esc and 0 < esc < 10240
    unclassified = next(l for l in got if "unclassified:" in l)
    assert float(unclassified.split()[2].rstrip("%")) < 50, unclassified


def test_runner_two_tier_rows_fused_matches_jax_runner(deep_tax_db,
                                                       monkeypatch):
    """The same summary through two-tier rows (MC_CLASSED=0, heads of 13
    packed slots): the fused dispatch, B6 and then B7 on the side
    stream's order, equals JAX's runner."""
    got, want, r = _summary(deep_tax_db, monkeypatch, {"MC_CLASSED": "0"})
    assert got == want
    assert r.tables.head_slots == 13 and not r.tables.classed
    assert "fused" in {x[0] for x in r.redo_dispatches}


@pytest.mark.parametrize("prefetch", ["1", "0"])
def test_pairs_escalate_only_with_prefetch(deep_tax_db, monkeypatch,
                                           prefetch):
    """Paired reads escalate (phase 1's sketches redone at full depth)
    only where the scan prefetches, as in JAX (runner.py:1172-1177):
    under MC_PREFETCH=0 no pair escalates; the histogram equals JAX's
    runner under the same environment either way."""
    got, want, r = _summary(deep_tax_db, monkeypatch,
                            {"MC_PREFETCH": prefetch}, pairs=True)
    assert got == want
    assert (r.esc_reads > 0) == (prefetch == "1")
    assert {x[0] for x in r.redo_dispatches} <= {"feats"}
    if prefetch == "0":
        assert not r.redo_dispatches


# ------------------------------------------- the native formatter
@pytest.mark.parametrize("golden,flags", [("fmt_0.txt", []),
                                          ("fmt_14.txt",
                                           ["-lowest", "species"])])
def test_native_fmt_off_matches_golden(tmp_path, monkeypatch, golden,
                                       flags):
    """MC_NATIVE_FMT=0 takes the per-read Python writer instead of the
    native batch formatter: the lines are byte-identical to the default
    run's and to the reference golden."""
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    calls = []
    real = out_mod.MappingLineWriter.lines_batch

    def spy(self, *a, **kw):
        calls.append(1)
        return real(self, *a, **kw)
    monkeypatch.setattr(out_mod.MappingLineWriter, "lines_batch", spy)
    args = ["query", db, f"{DATA}/reads_single.fa"] + flags
    default = _run(main, args)
    assert calls
    calls.clear()
    monkeypatch.setenv("MC_NATIVE_FMT", "0")
    python = _run(main, args)
    assert not calls
    with open(os.path.join(DATA, "golden", golden)) as f:
        gold = _strip(f.read())
    assert python == default == gold
