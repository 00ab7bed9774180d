"""metacache_tpu_torch's device table builder (ops/table_device.py, torch
ops on the CPU) against metacache_tpu's: the same (feature, tgt, win)
streams and CSR tables, in the parametrizations of
tests/test_table_device.py, give arrays bit-identical to JAX's, of the
same shapes, with the same layout and flags; export_csr gives back the
CSR the table was built from. Tolerance 0 (integer arrays)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.ops import table_device as jtd
from metacache_tpu.ops.table import FeatureTable, pack_locations
from metacache_tpu.ops.table import unpack_locations
from metacache_tpu_torch.ops import table_device as ttd

torch.set_num_threads(2)
CPU = torch.device("cpu")
ARRAYS = ("uniq", "offsets", "head", "ovf", "brows")
SCALARS = ("bbits", "nf", "spf", "head_slots", "num_locations", "dense",
           "packed", "ovf_packed", "max_win", "slot_bits", "classed")


# copied from tests/test_table_device.py:30-49
def _stream(rng, n, nf_hint, ntgt, deep_every=7):
    """Build-order (feature, tgt, win) stream: ascending (tgt, win),
    some features very deep (strain-sharing), some singletons."""
    feats, tgts, wins = [], [], []
    pool = rng.integers(0, 2**32, nf_hint, dtype=np.uint32)
    deep = pool[::deep_every]
    for t in range(ntgt):
        for w in range(n // ntgt):
            if rng.random() < 0.5:
                f = deep[rng.integers(0, len(deep))]
            else:
                f = pool[rng.integers(0, len(pool))]
            feats.append(f)
            tgts.append(t)
            wins.append(w)
    return (np.asarray(feats, np.uint32), np.asarray(tgts, np.int32),
            np.asarray(wins, np.int32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)
                            if a.dtype == np.uint32 else a.astype(np.int32))


def _chunks_jax(arrs, k):
    return [tuple(jnp.asarray(a[i:i + k]) for a in arrs)
            for i in range(0, len(arrs[0]), k)]


def _chunks_torch(arrs, k):
    return [tuple(_t(a[i:i + k]) for a in arrs)
            for i in range(0, len(arrs[0]), k)]


def assert_same_table(ours, ref):
    """Every array equal with its shape (u32 seen as int32), every flag
    and size equal, so both builders chose the same layout."""
    for name in SCALARS:
        assert getattr(ours, name) == getattr(ref, name), name
    for name in ARRAYS:
        want = np.asarray(getattr(ref, name))
        if want.dtype == np.uint32:
            want = want.view(np.int32)
        got = getattr(ours, name)
        assert got.dtype == torch.int32, name
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_array_equal(got.numpy(), want, err_msg=name)


def _csr(seed, n, nf_hint, ntgt, deep_every=7, cap=254):
    f, t, w = _stream(np.random.default_rng(seed), n, nf_hint, ntgt,
                      deep_every)
    ft = FeatureTable.build(f.copy(), pack_locations(t, w),
                            max_locations_per_feature=cap,
                            presorted_within_feature=True)
    ltgt, lwin = unpack_locations(ft.locations)
    return ft, ltgt, lwin


# tests/test_table_device.py:51-55: dense, a two-tier split (the classed
# cells refused), the classed cells the same budget takes when they are
# allowed, a tight cap
@pytest.mark.parametrize("cap,budget,classed", [
    (254, 1 << 40, None), (254, 1400 << 10, "0"), (254, 1400 << 10, None),
    (6, 1 << 40, None)])
def test_build_device_table_matches_jax(monkeypatch, cap, budget, classed):
    if classed is not None:
        monkeypatch.setenv("MC_CLASSED", classed)
    f, t, w = _stream(np.random.default_rng(5), 6000, 300, 8)
    ref = jtd.build_device_table(jnp.asarray(f), jnp.asarray(t),
                                 jnp.asarray(w), cap=cap,
                                 budget_bytes=budget, nch=4)
    ours = ttd.build_device_table(_t(f), _t(t), _t(w), cap=cap,
                                  budget_bytes=budget)
    assert (ours.dense, ours.classed) == (
        budget > 1 << 30, budget < 1 << 30 and classed is None)
    assert_same_table(ours, ref)


@pytest.mark.parametrize("presorted", [True, False])
def test_unsorted_stream_matches_jax(presorted):
    """presorted=False sorts by (feature, pk) itself: a shuffled stream
    gives the presorted stream's table; (tgt, win) lanes under
    MC_PACK_STORE=0 sort by (feature, tgt, win)."""
    f, t, w = _stream(np.random.default_rng(7), 4000, 300, 8)
    ref = jtd.build_device_table(jnp.asarray(f), jnp.asarray(t),
                                 jnp.asarray(w), cap=254,
                                 budget_bytes=1 << 40, nch=4)
    p = np.arange(len(f)) if presorted else \
        np.random.default_rng(1).permutation(len(f))
    ours = ttd.build_device_table(_t(f[p]), _t(t[p]), _t(w[p]), cap=254,
                                  budget_bytes=1 << 40, presorted=presorted)
    assert_same_table(ours, ref)


def test_unpacked_lanes_match_jax(monkeypatch):
    """MC_PACK_STORE=0: (tgt, win) lane pairs, dense and two-tier."""
    monkeypatch.setenv("MC_PACK_STORE", "0")
    f, t, w = _stream(np.random.default_rng(13), 5000, 300, 8)
    for budget in (1 << 40, 2 << 20):
        ref = jtd.build_device_table(jnp.asarray(f), jnp.asarray(t),
                                     jnp.asarray(w), cap=254,
                                     budget_bytes=budget, nch=4)
        p = np.random.default_rng(2).permutation(len(f))
        ours = ttd.build_device_table(_t(f[p]), _t(t[p]), _t(w[p]),
                                      cap=254, budget_bytes=budget,
                                      presorted=False)
        assert ours.slot_bits == 0
        assert_same_table(ours, ref)


@pytest.mark.parametrize("pack", ["0", "1"])
def test_pair_packed_rows_match_jax(monkeypatch, pack):
    """MC_PACK_ROWS=1 pair-packs the 64-lane head rows (hpack) and the
    bucket index; the port keeps JAX's (R, 128) shapes."""
    monkeypatch.setenv("MC_PACK_ROWS", pack)
    f, t, w = _stream(np.random.default_rng(5), 6000, 300, 8)
    for budget in (1 << 40, 4 << 20):
        ref = jtd.build_device_table(jnp.asarray(f), jnp.asarray(t),
                                     jnp.asarray(w), cap=60,
                                     budget_bytes=budget, nch=4)
        ours = ttd.build_device_table(_t(f), _t(t), _t(w), cap=60,
                                      budget_bytes=budget)
        assert ours.packed == (pack == "1")
        assert_same_table(ours, ref)


# tests/test_table_device.py:209-212 and :214
@pytest.mark.parametrize("cap,budget", [(254, 1 << 40), (254, 4 << 20),
                                        (6, 1 << 40)])
def test_grouped_build_matches_jax(cap, budget):
    """Four feature-range groups over chunks of 1111 elements: the
    arrays equal JAX's grouped build and the single-group build."""
    arrs = _stream(np.random.default_rng(17), 8000, 400, 8)
    ref = jtd.build_device_table_chunked(_chunks_jax(arrs, 1111), cap=cap,
                                         budget_bytes=budget, nch=4,
                                         gbits=2)
    ours = ttd.build_device_table_chunked(_chunks_torch(arrs, 1111),
                                          cap=cap, budget_bytes=budget,
                                          gbits=2)
    one = ttd.build_device_table_chunked(_chunks_torch(arrs, len(arrs[0])),
                                         cap=cap, budget_bytes=budget,
                                         gbits=0)
    assert_same_table(ours, ref)
    assert_same_table(one, ref)


@pytest.mark.parametrize("budget", [1 << 40, 4 << 20])
@pytest.mark.parametrize("gbits", [0, 2])
def test_device_layout_from_csr_matches_jax(budget, gbits):
    """tests/test_table_device.py:155 and :247: a saved CSR table staged
    as device rows, dense and two-tier, in one group and four."""
    ft, ltgt, lwin = _csr(3, 5000, 200, 6)
    ref = jtd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                     lwin, cap=254, budget_bytes=budget,
                                     nch=4, gbits=gbits)
    ours = ttd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                      lwin, device=CPU, cap=254,
                                      budget_bytes=budget, gbits=gbits)
    assert_same_table(ours, ref)


@pytest.mark.parametrize("gbits", [0, 2])
@pytest.mark.parametrize("budget", [6 << 20, 1400 << 10])
def test_classed_layout_matches_jax(monkeypatch, gbits, budget):
    """tests/test_table_device.py:273: MC_CLASSED=1 with the dense layout
    refused stages the size-classed cells (and overflow rows: buckets
    run deeper than 61), grouped or not."""
    monkeypatch.setenv("MC_CLASSED", "1")
    ft, ltgt, lwin = _csr(31, 9000, 250, 6, deep_every=3)
    kw = dict(cap=254, budget_bytes=budget, gbits=gbits, allow_dense=False)
    ref = jtd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                     lwin, nch=4, **kw)
    ours = ttd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                      lwin, device=CPU, **kw)
    assert ours.classed
    assert_same_table(ours, ref)


def test_classed_build_matches_jax(monkeypatch):
    """The classed cells from the build stream, grouped."""
    monkeypatch.setenv("MC_CLASSED", "1")
    arrs = _stream(np.random.default_rng(31), 9000, 250, 6, deep_every=3)
    ref = jtd.build_device_table_chunked(_chunks_jax(arrs, 999), cap=254,
                                         budget_bytes=1400 << 10, nch=4,
                                         gbits=1)
    ours = ttd.build_device_table_chunked(_chunks_torch(arrs, 999), cap=254,
                                          budget_bytes=1400 << 10, gbits=1)
    assert ours.classed and not ours.dense
    assert_same_table(ours, ref)


def test_auto_classed_when_the_budget_pinches_the_head():
    """MC_CLASSED unset: a budget that leaves only a head below 61 slots
    on buckets deeper than 61 takes the classed cells, as in JAX."""
    ft, ltgt, lwin = _csr(31, 9000, 250, 6, deep_every=3)
    kw = dict(cap=254, budget_bytes=1400 << 10, allow_dense=False)
    ref = jtd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                     lwin, nch=4, **kw)
    ours = ttd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                      lwin, device=CPU, **kw)
    assert ours.classed
    assert_same_table(ours, ref)


def test_tiny_and_empty_streams():
    ref = jtd.build_device_table(jnp.asarray(np.uint32([7, 7, 7])),
                                 jnp.asarray(np.int32([0, 1, 2])),
                                 jnp.asarray(np.int32([3, 4, 5])), cap=2,
                                 budget_bytes=1 << 30, nch=2)
    ours = ttd.build_device_table(_t(np.uint32([7, 7, 7])),
                                  _t(np.int32([0, 1, 2])),
                                  _t(np.int32([3, 4, 5])), cap=2,
                                  budget_bytes=1 << 30)
    assert_same_table(ours, ref)
    sent = np.full(40, 0xFFFFFFFF, np.uint32)
    z = np.zeros(40, np.int32)
    ref = jtd.build_device_table(jnp.asarray(sent), jnp.asarray(z),
                                 jnp.asarray(z), budget_bytes=1 << 30)
    ours = ttd.build_device_table(_t(sent), _t(z), _t(z),
                                  budget_bytes=1 << 30)
    assert ours.nf == 0
    assert_same_table(ours, ref)


@pytest.mark.parametrize("case,budget", [
    ("dense", 1 << 40), ("two_tier", 1400 << 10), ("classed", 1400 << 10),
    ("lanes", 1 << 40), ("lanes", 2500 << 10)])
def test_export_csr_roundtrip(monkeypatch, case, budget):
    """export_csr gives back the capped CSR the table holds: what
    metacache_tpu's export_csr gives, and FeatureTable.build's CSR of the
    same stream (the `build` mode's save path)."""
    if case == "two_tier":
        monkeypatch.setenv("MC_CLASSED", "0")
    if case == "lanes":
        monkeypatch.setenv("MC_PACK_STORE", "0")
    f, t, w = _stream(np.random.default_rng(23), 6000, 300, 8)
    ft = FeatureTable.build(f.copy(), pack_locations(t, w),
                            max_locations_per_feature=254,
                            presorted_within_feature=True)
    ours = ttd.build_device_table(_t(f), _t(t), _t(w), cap=254,
                                  budget_bytes=budget)
    assert ours.dense == (budget > 1 << 30)
    assert ours.classed == (case == "classed")
    uniq, offs, locs = ttd.export_csr(ours, chunk=7000)
    np.testing.assert_array_equal(uniq, ft.unique_features)
    np.testing.assert_array_equal(offs, ft.offsets)
    np.testing.assert_array_equal(locs, ft.locations)
    ref = jtd.build_device_table(jnp.asarray(f), jnp.asarray(t),
                                 jnp.asarray(w), cap=254,
                                 budget_bytes=budget, nch=4)
    for a, b in zip((uniq, offs, locs), jtd.export_csr(ref)):
        np.testing.assert_array_equal(a, b)


def test_device_accumulator_matches_host_build():
    """DeviceSketchAccumulator + the builder == SketchAccumulator +
    FeatureTable over sketched genomes (tests/test_table_device.py:120),
    and == metacache_tpu's device accumulator + builder."""
    from metacache_tpu.db.sketch_exec import \
        DeviceSketchAccumulator as JaxAcc
    from metacache_tpu_torch.config import SketchingOptions
    from metacache_tpu_torch.db.sketch_exec import (DeviceSketchAccumulator,
                                                    SketchAccumulator)
    from metacache_tpu_torch.ops import windows as W
    rng = np.random.default_rng(9)
    opt = SketchingOptions().resolved()
    genomes = [rng.integers(0, 4, 40_000, dtype=np.uint8) for _ in range(3)]
    genomes.append(genomes[0].copy())          # a duplicate "strain"
    hacc = SketchAccumulator(opt.kmerlen, opt.sketchlen, CPU)
    dacc = DeviceSketchAccumulator(opt.kmerlen, opt.sketchlen, CPU,
                                   batch=512)
    jacc = JaxAcc(opt.kmerlen, opt.sketchlen)
    for tid, g in enumerate(genomes):
        wm, vl = W.sequence_windows(g, opt)
        for acc in (hacc, dacc, jacc):
            acc.add_target(wm, vl, tid)
    ft = FeatureTable.build(*hacc.finish(), presorted_within_feature=True,
                            max_locations_per_feature=3)
    chunks = dacc.finish_chunks()
    assert len(chunks) > 1 and all(c[0].dtype == torch.int32
                                   for c in chunks)
    ours = ttd.build_device_table_chunked(chunks, cap=3,
                                          budget_bytes=1 << 40)
    assert chunks == []
    uniq, offs, locs = ttd.export_csr(ours)
    np.testing.assert_array_equal(uniq, ft.unique_features)
    np.testing.assert_array_equal(offs, ft.offsets)
    np.testing.assert_array_equal(locs, ft.locations)
    ref = jtd.build_device_table(*jacc.finish_device(), cap=3,
                                 budget_bytes=1 << 40, nch=4)
    assert_same_table(ours, ref)
