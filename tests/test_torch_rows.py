"""metacache_tpu_torch's row-layout query step against metacache_tpu's
on a small strain database whose buckets are 96 deep, so that the probe
emits alternating 128-lane runs and the slot sort skips phases;
tolerance 0 (integer outputs; the LCA threshold is float32 on both
sides)."""
import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from metacache_tpu.config import SketchingOptions
from metacache_tpu.db.build import BuildOptions, build_database
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops import windows as win_ops
from metacache_tpu.ops.probe import make_bucket_index
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu_torch.db.state import tables_from_numpy
from metacache_tpu_torch.ops import rows as trows
from test_torch_cuda import pack_2bit

torch.set_num_threads(2)
GLEN = 20000
NSTRAIN = 96
ACGT = np.frombuffer(b"ACGT", np.uint8)


@pytest.fixture(scope="module")
def strain_db(tmp_path_factory):
    rng = np.random.default_rng(17)
    genomes = []
    for _b in range(2):
        base = rng.integers(0, 4, GLEN, dtype=np.uint8)
        for s in range(NSTRAIN):
            g = base.copy()
            if s:
                pos = rng.integers(0, GLEN, GLEN * 3 // 1000)
                g[pos] = rng.integers(0, 4, len(pos), dtype=np.uint8)
            genomes.append(g)
    fa = tmp_path_factory.mktemp("strains") / "g.fa"
    with open(fa, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">s%d\n" % i + ACGT[g].tobytes() + b"\n")
    db = build_database(BuildOptions(infiles=[str(fa)]))
    ft = db.parts[0]
    spf = min(ft.max_bucket_size, 254)
    assert 64 < spf <= 128
    maxwin = int((ft.locations & np.uint64(0xFFFFFFFF)).max())
    wbits = (2 * maxwin).bit_length()
    ntgt = len(genomes)
    lin = np.zeros((ntgt, 21), np.int32)
    lin[:, 0] = -np.arange(ntgt) - 1
    lin[:, 4] = np.arange(ntgt) // NSTRAIN + 100
    lin[:, 20] = 1
    brows, bits = make_bucket_index(ft.unique_features)
    return dict(ft=ft, spf=spf, wbits=wbits, lin=lin, brows=brows,
                bits=bits, genomes=genomes)


def _tables(d, slot_bits):
    ft = d["ft"]
    return tables_from_numpy(
        ft.unique_features, ft.offsets,
        ft.fused_rows(d["spf"], slot_bits=slot_bits), d["brows"], d["bits"],
        d["lin"], d["lin"][:, 0].copy(), d["spf"], slot_bits,
        torch.device("cpu"))


def _reads(d, n, length, seed):
    rng = np.random.default_rng(seed)
    out = np.empty((n, length), np.uint8)
    for i in range(n):
        g = d["genomes"][int(rng.integers(0, len(d["genomes"])))]
        p = int(rng.integers(0, GLEN - length))
        out[i] = g[p:p + length]
        m = rng.integers(0, length, 2)
        out[i, m] = rng.integers(0, 4, 2)
    return out


@pytest.mark.parametrize("layout", ["dense", "pk"])
@pytest.mark.parametrize("pack", [False, True])
@pytest.mark.parametrize("alt", [0, 128])
def test_probe_rows_matches_jax(strain_db, layout, pack, alt):
    d = strain_db
    slot_bits = d["wbits"] if layout == "pk" else 0
    pack_bits = d["wbits"] if pack else 0
    reads = _reads(d, 8, 100, seed=3)
    codes = np.full((8, 127), 4, np.uint8)
    codes[:, :100] = reads
    feats = np.array(jax_sketch(jnp.asarray(codes),
                                  jnp.full(8, 100, jnp.int32), k=16,
                                  sketchlen=16))
    feats[0, 3] = 12345             # a feature not in the database
    ft = d["ft"]
    fused = ft.fused_rows(d["spf"], slot_bits=slot_bits)
    want = jrows.probe_rows(
        jnp.asarray(feats), jnp.asarray(ft.unique_features),
        jnp.asarray(ft.offsets.astype(np.int32)), jnp.asarray(fused),
        jnp.zeros((1,), jnp.int32), d["spf"], jnp.asarray(d["brows"]),
        d["bits"], 0, f"pk{slot_bits}" if slot_bits else True,
        alt_runs=alt, pack_bits=pack_bits)
    got = trows.probe_rows(torch.from_numpy(feats.view(np.int32)),
                           _tables(d, slot_bits), alt_runs=alt,
                           pack_bits=pack_bits)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_tables(d, slot_bits):
    ft = d["ft"]
    return (jnp.asarray(ft.unique_features),
            jnp.asarray(ft.offsets.astype(np.int32)),
            jnp.asarray(ft.fused_rows(d["spf"], slot_bits=slot_bits)),
            jnp.zeros((1,), jnp.int32), jnp.asarray(d["lin"][:, 0].copy()),
            jnp.asarray(d["lin"]))


def _layout(bits):
    """metacache_tpu's dense layout tag: packed slots or (tgt, win)."""
    return f"pk{bits}" if bits else True


def test_scan_matches_jax(strain_db):
    """K = 2 stacked batches, 2-bit packed infeed, fused candidates,
    fast_top2, walk sweep."""
    _scan_case(strain_db, strain_db["wbits"])


def test_scan_unpacked_matches_jax(strain_db):
    """The same scan with unpacked (tgt, win) slots (pack_bits = 0):
    (tgt, win) lane rows, the two-key candidates (B5)."""
    _scan_case(strain_db, 0)


@pytest.mark.parametrize("setting", [None, "sort", "extract"])
def test_scan_sketch_mode_matches_jax(strain_db, monkeypatch, setting):
    """MC_SKETCH_MODE unset, "sort" and "extract": the port's scan step
    (packed infeed, B1's route) equals JAX's with its Pallas sketcher,
    interpreted, under the same setting."""
    if setting is None:
        monkeypatch.delenv("MC_SKETCH_MODE", raising=False)
    else:
        monkeypatch.setenv("MC_SKETCH_MODE", setting)
    _scan_case(strain_db, strain_db["wbits"], pallas_sketch=True)


def _scan_case(d, bits, pallas_sketch=False):
    K, B = 2, 16
    reads = _reads(d, K * B, 100, seed=8)
    reads[3, 20] = 1                # every read stays ACGT-only
    c4 = np.zeros((K * B, 128), np.uint8)
    c4[:, :100] = reads
    packed = pack_2bit(c4).reshape(K, B, 1, 32)
    lens = np.full((K, B, 1), 100, np.uint8)
    lens[1, 5, 0] = 40              # a short read
    mwir = np.full((K, B), 2, np.uint8)
    hits_min, frac, highest = 5, 1.0, 19
    tf, to, lt, lw, mt, lg = _jax_tables(d, bits)
    ctx = pltpu.force_tpu_interpret_mode() if pallas_sketch \
        else contextlib.nullcontext()
    with ctx:
        want = jrows.query_step_rows_scan(
            jnp.asarray(packed), jnp.asarray(lens), jnp.asarray(mwir),
            tf, to, lt, lw, mt, lg, jnp.int32(hits_min), jnp.float32(frac),
            jnp.int32(highest), jnp.int32(0), jnp.asarray(d["brows"]),
            k=16, sketchlen=16, slots_per_feature=d["spf"],
            windows_per_query=1, max_candidates=2, prefix_bits=d["bits"],
            dense=_layout(bits), walk_elems=32, fast_top2=True,
            fused_candidates=True, pack_bits=bits, infeed_packed=True,
            use_pallas_sketch=pallas_sketch)
    got = trows.query_step_rows_scan(
        torch.from_numpy(packed), torch.from_numpy(lens),
        torch.from_numpy(mwir), _tables(d, bits), hits_min, frac,
        highest, 0, k=16, sketchlen=16, windows_per_query=1,
        max_candidates=2, walk_elems=32, fast_top2=True,
        pack_bits=bits, infeed_packed=True)
    want = np.asarray(want)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > K * B // 2      # most reads classify


def test_step_two_windows_dedup_matches_jax(strain_db):
    """200 bp reads: two windows per read, the dedup sweep, and every
    candidate field of the QueryResult."""
    _step_case(strain_db, strain_db["wbits"])


def test_step_two_windows_dedup_unpacked_matches_jax(strain_db):
    """The per-read step with unpacked (tgt, win) slots (B5)."""
    _step_case(strain_db, 0)


def _step_case(d, bits):
    B = 16
    sk = SketchingOptions().resolved()
    reads = _reads(d, B, 200, seed=21)
    wmat = np.full((B, 2, 127), 4, np.uint8)
    vmat = np.zeros((B, 2), np.int32)
    for i in range(B):
        w, v = win_ops.sequence_windows(reads[i], sk)
        wmat[i, :len(w)] = w
        vmat[i, :len(v)] = v
    mwir = np.full(B, 2 + 200 // sk.winstride, np.int32)
    tf, to, lt, lw, mt, lg = _jax_tables(d, bits)
    want = jrows.query_step_rows(
        jnp.asarray(wmat), jnp.asarray(vmat), jnp.asarray(mwir),
        tf, to, lt, lw, mt, lg, jnp.int32(5), jnp.float32(1.0),
        jnp.int32(19), jnp.int32(0), jnp.asarray(d["brows"]),
        k=16, sketchlen=16, slots_per_feature=d["spf"],
        windows_per_query=2, max_candidates=2, prefix_bits=d["bits"],
        dense=_layout(bits), dedup_walk=3, fast_top2=True,
        fused_candidates=True, emit_hits=False, pack_bits=bits)
    got = trows.query_step_rows(
        torch.from_numpy(wmat), torch.from_numpy(vmat),
        torch.from_numpy(mwir), _tables(d, bits), 5, 1.0, 19, 0,
        k=16, sketchlen=16, windows_per_query=2, max_candidates=2,
        dedup_walk=3, fast_top2=True, pack_bits=bits)
    for nm in ("cand_tgt", "cand_tax", "cand_hits", "cand_beg",
               "cand_end", "cls_tax"):
        np.testing.assert_array_equal(getattr(got, nm).numpy(),
                                      np.asarray(getattr(want, nm)),
                                      err_msg=nm)


def test_result_rejects_paths_not_ported(strain_db):
    d = strain_db
    pk = torch.full((2, 128), 2**31 - 1, dtype=torch.int32)
    mw = torch.full((2,), 2, dtype=torch.int32)
    t = _tables(d, d["wbits"])
    args = (pk, pk, mw, t.merge_tax, t.lineages, 5, 1.0, 19, 0)
    with pytest.raises(NotImplementedError, match="A5"):
        trows.rows_to_result(*args, max_candidates=2, walk_elems=8,
                             fast_top2=True, emit_hits=True, pack_bits=0)
    with pytest.raises(NotImplementedError, match="rank-join"):
        trows.rows_to_result(*args, max_candidates=2, fast_top2=True,
                             pack_bits=d["wbits"])
    with pytest.raises(NotImplementedError, match="A5"):
        trows.rows_to_result(*args, max_candidates=2, walk_elems=8,
                             fast_top2=False, pack_bits=d["wbits"])


@pytest.mark.parametrize("nbytes,route", [(32, "packed"), (28, "packed"),
                                          (8, "packed"), (64, "unpacked")])
def test_sketch_stage_routes_packed_rows(monkeypatch, nbytes, route):
    """The scan steps hand packed rows of up to 32 bytes (the runner
    crops a stack's rows to its longest read: 28 bytes for 100 bp) to
    B1's packed entry, which reads them itself, and unpack wider ones
    for B2; both give the sketch of the unpacked codes."""
    from metacache_tpu_torch.ops import sketch as S
    calls = []
    for name in ("sketch_windows_packed", "sketch_windows"):
        fn = getattr(trows, name)
        monkeypatch.setattr(trows, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    rng = np.random.default_rng(nbytes)
    codes = rng.integers(0, 4, (2, 8, 4 * nbytes)).astype(np.uint8)
    packed = pack_2bit(codes.reshape(16, -1)).reshape(2, 8, nbytes)
    valid = rng.integers(0, 4 * nbytes + 1, (2, 8)).astype(np.uint8
                                                          if nbytes < 64
                                                          else np.int32)
    got = trows._sketch_stage(torch.from_numpy(packed),
                              torch.from_numpy(valid), 16, 16, True)
    assert calls == ["sketch_windows_packed" if route == "packed"
                     else "sketch_windows"]
    want = S.sketch_windows(torch.from_numpy(codes.reshape(16, -1)),
                            torch.from_numpy(valid.reshape(16)), 16, 16)
    np.testing.assert_array_equal(got.numpy(), want.reshape(2, 128).numpy())
