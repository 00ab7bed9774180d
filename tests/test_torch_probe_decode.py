"""metacache_tpu_torch's two-tier probe decode (kernels B6 and B7, plain
versions on the CPU) against metacache_tpu's Pallas head_decode /
full_decode in interpret mode and against its XLA decode in
probe_rows_head / probe_rows (MC_PROBE_PALLAS=0), on the layout of
tests/test_probe_pallas.py: 4000 features with counts 1..254, head 61,
18 window bits, misses and sentinels among the probes. The port's head
rows are that file's pair-packed rows un-paired to (F, 64). Tolerance 0
(integer outputs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.ops import probe_pallas as jpp
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops.probe import make_bucket_index, probe_bucket
from metacache_tpu_torch.db.state import DeviceTables
from metacache_tpu_torch.ops import probe_decode as D
from metacache_tpu_torch.ops import rows as trows

torch.set_num_threads(2)
HSL, SPF, F, BITS0, SB = 61, 254, 16, 12, 18


@pytest.fixture(scope="module")
def layout():
    rng = np.random.default_rng(11)
    nf = 4000
    feats = np.sort(rng.choice(2**32 - 3, nf, replace=False) + 1).astype(
        np.uint32)
    cnts = rng.integers(1, SPF + 1, nf).astype(np.int32)
    brows, bits = make_bucket_index(feats, BITS0)
    hl = np.zeros((nf, 64), np.int32)
    hl[:, 0] = feats.view(np.int32)
    hl[:, 1] = cnts
    novf = int((cnts > HSL).sum())
    hl[cnts > HSL, 2] = np.arange(1, novf + 1)
    hl[:, 3:] = rng.integers(0, 2**30, (nf, 61)).astype(np.int32)
    ovf = np.zeros((novf + 1, 200), np.int32)
    ovf[1:, :SPF - HSL] = rng.integers(0, 2**30, (novf, SPF - HSL))
    n = 8 * F
    flat = feats[rng.integers(0, nf, n)]
    miss = rng.random(n) < 0.3
    flat[miss] = rng.integers(1, 2**31, int(miss.sum()), dtype=np.uint32)
    flat[:3] = 0xFFFFFFFF
    idx = np.clip(np.asarray(probe_bucket(
        jnp.asarray(flat), jnp.asarray(brows), bits)[0]), 0, None)
    return dict(feats=feats, brows=brows, bits=bits, hl=hl, ovf=ovf,
                flat=flat, idx=idx)


def _pairpack(hl):
    return jnp.asarray(hl.reshape(-1, 128))


def _t(a):
    a = np.ascontiguousarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                            else a.astype(np.int32))


def _tables(d):
    return DeviceTables(
        _t(d["hl"]), _t(d["brows"]), torch.zeros((1, 21), dtype=torch.int32),
        torch.zeros(1, dtype=torch.int32), num_features=len(d["feats"]),
        bucket_bits=d["bits"], spf=SPF, slot_bits=SB, ovf_rows=_t(d["ovf"]),
        head_slots=HSL)


@pytest.mark.parametrize("rl", [64, 256])
def test_head_decode_plain_matches_pallas(layout, rl):
    d = layout
    idx = d["idx"]
    want_pk, want_cnt = jpp.head_decode(
        _pairpack(d["hl"])[idx >> 1], jnp.asarray(idx & 1),
        jnp.asarray(d["flat"]), HSL, rl, F, tile=64)
    pk, cnt = D.head_decode(_t(d["hl"]), _t(idx), _t(d["flat"]), HSL, rl, F)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(want_pk))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(want_cnt))
    assert (cnt.numpy() > HSL).any() and (cnt.numpy() == 0).any()


@pytest.mark.parametrize("rl", [256, 512])
def test_full_decode_plain_matches_pallas(layout, rl):
    d = layout
    idx = d["idx"]
    half = d["hl"][np.minimum(idx, len(d["hl"]) - 1)]
    fnd = (half[:, 0] == d["flat"].view(np.int32)) & \
        (d["flat"] != 0xFFFFFFFF)
    oidx = np.where(fnd, half[:, 2], 0)
    want = jpp.full_decode(
        _pairpack(d["hl"])[idx >> 1], jnp.asarray(d["ovf"][oidx]),
        jnp.asarray(idx & 1), jnp.asarray(d["flat"]), HSL, SPF, rl, F,
        tile=32)
    got = D.full_decode(_t(d["hl"]), _t(d["ovf"]), _t(idx), _t(d["flat"]),
                        HSL, SPF, rl, F)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rl", [64, 128])
def test_probe_rows_head_matches_xla(layout, rl, monkeypatch):
    """The head-only probe (B6 + over flags) against probe_rows_head's
    XLA branch on unpaired rows, with the port's own bucket probe."""
    d = layout
    monkeypatch.setenv("MC_PROBE_PALLAS", "0")
    want_pk, want_over = jrows.probe_rows_head(
        jnp.asarray(d["flat"].reshape(-1, F)), jnp.asarray(d["hl"]),
        jnp.asarray(d["brows"]), d["bits"],
        ("two_tier", HSL, False, False, SB), alt_runs=rl, pack_bits=SB)
    pk, over = trows.probe_rows_head(_t(d["flat"].reshape(-1, F)),
                                     _tables(d), alt_runs=rl, pack_bits=SB)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(want_pk))
    np.testing.assert_array_equal(over.numpy(), np.asarray(want_over))
    assert over.numpy().all()        # every query probes a deep bucket


@pytest.mark.parametrize("alt,pack", [(256, SB), (0, SB), (256, 0), (0, 0)])
def test_probe_rows_two_tier_matches_xla(layout, alt, pack, monkeypatch):
    """The two-tier branch of probe_rows (B7, then the caller's slot
    encoding) against the XLA branch, with and without alternating runs,
    packed and unpacked output; and with the bucket probe skipped."""
    d = layout
    monkeypatch.setenv("MC_PROBE_PALLAS", "0")
    want = jrows.probe_rows(
        jnp.asarray(d["flat"].reshape(-1, F)), jnp.asarray(d["feats"]),
        None, jnp.asarray(d["hl"]), jnp.asarray(d["ovf"]), SPF,
        prefix_starts=jnp.asarray(d["brows"]), prefix_bits=d["bits"],
        dense=("two_tier", HSL, False, False, SB), alt_runs=alt,
        pack_bits=pack)
    feats = _t(d["flat"].reshape(-1, F))
    got = trows.probe_rows(feats, _tables(d), alt_runs=alt, pack_bits=pack)
    pre = trows.probe_rows(feats, _tables(d), alt_runs=alt, pack_bits=pack,
                           idx_pre=_t(np.minimum(d["idx"],
                                                 len(d["feats"]) - 1)))
    for w, g, p in zip(want, got, pre):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))


def test_two_tier_lane_rows_match_xla(monkeypatch):
    """Two-tier (tgt, win) lane rows (pack bits 0), decoded by torch ops,
    against the XLA branch (rows.py:750-758), from one FeatureTable."""
    from metacache_tpu.ops.table import FeatureTable, pack_locations
    monkeypatch.setenv("MC_PROBE_PALLAS", "0")
    rng = np.random.default_rng(4)
    f = np.repeat(rng.choice(2**31, 300, replace=False).astype(np.uint32),
                  rng.integers(1, 40, 300))
    loc = pack_locations(rng.integers(0, 9000, len(f)).astype(np.uint32),
                         rng.integers(0, 80000, len(f)).astype(np.uint32))
    ft = FeatureTable.build(f, loc)
    spf, hsl = ft.max_bucket_size, 14
    head, ovf = ft.fused_rows_two_tier(spf, hsl)
    brows, bits = make_bucket_index(ft.unique_features)
    probes = np.concatenate([ft.unique_features[rng.integers(0, 300, 60)],
                             np.uint32([7, 0xFFFFFFFF, 123456, 99])])
    want = jrows.probe_rows(
        jnp.asarray(probes.reshape(-1, 16)), jnp.asarray(ft.unique_features),
        None, jnp.asarray(head), jnp.asarray(ovf), spf,
        prefix_starts=jnp.asarray(brows), prefix_bits=bits,
        dense=("two_tier", hsl, False, False, 0), alt_runs=64)
    t = DeviceTables(_t(head), _t(brows),
                     torch.zeros((1, 21), dtype=torch.int32),
                     torch.zeros(1, dtype=torch.int32),
                     num_features=ft.num_features, bucket_bits=bits,
                     spf=spf, slot_bits=0, ovf_rows=_t(ovf), head_slots=hsl)
    got = trows.probe_rows(_t(probes.reshape(-1, 16)), t, alt_runs=64)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_wrappers_check_shapes(layout):
    d = layout
    head, idx, flat = _t(d["hl"]), _t(d["idx"]), _t(d["flat"])
    with pytest.raises(ValueError):
        D.head_decode(head, idx, flat, 62, 64, F)      # hsl past the row
    with pytest.raises(ValueError):
        D.full_decode(head, _t(d["ovf"]), idx, flat, HSL, SPF, 128, F)
    with pytest.raises(ValueError):
        D.head_decode(head, idx[:-1], flat, HSL, 64, F)
