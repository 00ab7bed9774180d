"""metacache_tpu_torch's size-classed layout against metacache_tpu's, on
the CSR table of tests/test_classed.py (skewed bucket depths 1..100,
cap 254): the port's builder stages the same cells and bucket index as
JAX's (MC_CLASSED=1), and the classed bucket probe, the full-depth probe
(head cell + overflow row) and the head-only probe of escalation phase 1
equal JAX's on the same probes, and equal the two-tier layout's full
probe. Torch ops on the CPU; tolerance 0 (integer outputs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.ops import probe as jprobe
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops import table_device as jtd
from metacache_tpu_torch.db.state import tables_from_device
from metacache_tpu_torch.ops import probe as tprobe
from metacache_tpu_torch.ops import rows as trows
from metacache_tpu_torch.ops import table_device as ttd

torch.set_num_threads(2)
CPU = torch.device("cpu")


# copied from tests/test_classed.py:25-40
def _csr(rng, nf=800, ntgt=60, maxwin=200):
    """CSR stream with a skewed depth mix (1..100, cap later)."""
    feats = np.unique(rng.integers(0, 2**32, nf, dtype=np.uint64)
                      .astype(np.uint32))
    depth = rng.choice([1, 2, 3, 8, 14, 20, 40, 70, 100],
                       size=len(feats),
                       p=[.3, .2, .15, .1, .08, .07, .05, .03, .02])
    offs = np.concatenate([[0], np.cumsum(depth)]).astype(np.int64)
    n = int(offs[-1])
    ltgt = rng.integers(0, ntgt, n).astype(np.int32)
    lwin = rng.integers(0, maxwin, n).astype(np.int32)
    for i in range(len(feats)):
        a, b = offs[i], offs[i + 1]
        o = np.lexsort((lwin[a:b], ltgt[a:b]))
        ltgt[a:b], lwin[a:b] = ltgt[a:b][o], lwin[a:b][o]
    return feats, offs, ltgt, lwin


@pytest.fixture(scope="module")
def tables():
    """(features, JAX classed and two-tier tables, the port's) as
    tests/test_classed.py stages them."""
    feats, offs, ltgt, lwin = _csr(np.random.default_rng(17))
    out = {"feats": feats, "offs": offs}
    with pytest.MonkeyPatch.context() as mp:
        for name, classed, budget in (("c", "1", 4 << 20),
                                      ("t", "0", 64 << 20)):
            mp.setenv("MC_CLASSED", classed)
            kw = dict(cap=254, budget_bytes=budget, allow_dense=False)
            out["j" + name] = jtd.device_layout_from_csr(
                feats, offs, ltgt, lwin, **kw)
            out["t" + name] = ttd.device_layout_from_csr(
                feats, offs, ltgt, lwin, device=CPU, **kw)
    assert out["jc"].classed and not out["jt"].classed
    lin = np.zeros((60, 21), np.int32)
    out["tables_c"] = tables_from_device(out["tc"], lin, lin[:, 0].copy())
    out["tables_t"] = tables_from_device(out["tt"], lin, lin[:, 0].copy())
    return out


def _tag(dt):
    kind = "classed" if dt.classed else "two_tier"
    return (kind, dt.head_slots, dt.packed, dt.ovf_packed, dt.slot_bits)


# copied from tests/test_classed.py:74-82
def _queries(rng, feats, b=64, f=16):
    qf = rng.choice(feats, (b, f)).astype(np.uint32)
    miss = rng.integers(0, 2**32, (b, f), dtype=np.uint64) \
        .astype(np.uint32)
    take_miss = rng.random((b, f)) < 0.3
    qf = np.where(take_miss, miss, qf)
    qf[0, :] = 0xFFFFFFFF          # all-sentinel query row
    return qf


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_staged_cells_equal_jax(tables):
    for name in ("uniq", "offsets", "head", "ovf", "brows"):
        want = np.asarray(getattr(tables["jc"], name))
        got = getattr(tables["tc"], name).numpy()
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got, want.view(np.int32)
                                      if want.dtype == np.uint32 else want)
    assert tables["tables_c"].dense == _tag(tables["jc"])


def test_classed_bucket_probe_matches_jax(tables):
    """pidx and found of every stored feature, absent ones and the
    sentinel (tests/test_classed.py:148-163)."""
    feats = tables["feats"]
    rng = np.random.default_rng(31)
    present = rng.choice(feats, 200).astype(np.uint32)
    absent = np.setdiff1d(rng.integers(0, 2**32, 200, dtype=np.uint64)
                          .astype(np.uint32), feats)
    probes = np.concatenate([present, absent, np.uint32([0xFFFFFFFF])])
    jc = tables["jc"]
    want = jprobe.probe_bucket_classed(jnp.asarray(probes), jc.brows,
                                       jc.bbits)
    tc = tables["tc"]
    got = tprobe.probe_bucket_classed(_t(probes), tc.brows, tc.bbits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[1][:200].all() and not got[1][200:].any()


@pytest.mark.parametrize("alt,pack", [(0, True), (256, True), (256, False)])
def test_classed_full_probe_matches_jax(tables, alt, pack):
    """probe_rows through the classed cells: equal to JAX's, with and
    without alternating runs, packed or decoded to (tgt, win), and to
    the two-tier layout's probe (tests/test_classed.py:85-89)."""
    qf = _queries(np.random.default_rng(23), tables["feats"])
    jc, jt = tables["jc"], tables["jt"]
    bits = jc.slot_bits if pack else 0
    want = jrows.probe_rows(jnp.asarray(qf), jc.uniq, jc.offsets, jc.head,
                            jc.ovf, jc.spf, jc.brows, jc.bbits, 0,
                            _tag(jc), alt_runs=alt, pack_bits=bits)
    got = trows.probe_rows(_t(qf), tables["tables_c"], alt_runs=alt,
                           pack_bits=bits)
    two = trows.probe_rows(_t(qf), tables["tables_t"], alt_runs=alt,
                           pack_bits=bits)
    for g, w, x in zip(got, want, two):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), x.numpy())


@pytest.mark.parametrize("alt", [64, 0])
def test_classed_head_probe_matches_jax(tables, alt):
    """The head-only classed probe (escalation phase 1): slots and over
    flags equal JAX's probe_rows_head (tests/test_classed.py:92-126)."""
    qf = _queries(np.random.default_rng(29), tables["feats"])
    jc = tables["jc"]
    want_pk, want_over = jrows.probe_rows_head(
        jnp.asarray(qf), jc.head, jc.brows, jc.bbits, _tag(jc),
        alt_runs=alt, pack_bits=jc.slot_bits)
    pk, over = trows.probe_rows_head(_t(qf), tables["tables_c"],
                                     alt_runs=alt,
                                     pack_bits=tables["tc"].slot_bits)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(want_pk))
    np.testing.assert_array_equal(over.numpy(), np.asarray(want_over))
    assert over.numpy().any() and not over.numpy().all()


def test_classed_redo_on_phase_one_probes(tables):
    """The full-depth probe on phase 1's saved cell addresses (idx_pre,
    the redo's input) equals the probe that finds them itself."""
    qf = _queries(np.random.default_rng(37), tables["feats"])
    t = tables["tables_c"]
    flat = _t(qf).reshape(-1)
    pidx = trows._bucket_idx(flat, t)
    kw = dict(alt_runs=256, pack_bits=t.slot_bits)
    got = trows.probe_rows(_t(qf), t, idx_pre=pidx, **kw)
    want = trows.probe_rows(_t(qf), t, **kw)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())


def test_classed_export_roundtrip(tables):
    """export_csr of the classed cells gives back the capped CSR
    (tests/test_classed.py:129-145), as JAX's does."""
    uniq, offs, locs = ttd.export_csr(tables["tc"])
    np.testing.assert_array_equal(uniq, tables["feats"])
    for a, b in zip((uniq, offs, locs), jtd.export_csr(tables["jc"])):
        np.testing.assert_array_equal(a, b)
