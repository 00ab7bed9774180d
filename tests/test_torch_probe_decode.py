"""metacache_tpu_torch's probe decode (kernels B6 to B9, plain versions
on the CPU) against metacache_tpu's Pallas head_decode / full_decode /
oidx_decode / bucket_decode in interpret mode and against its XLA decode
in probe_bucket / probe_rows_head / probe_rows (MC_PROBE_PALLAS=0), on
the layout of tests/test_probe_pallas.py: 4000 features with counts
1..254, head 61, 18 window bits, misses and sentinels among the probes.
The port's head rows are that file's pair-packed rows un-paired to
(F, 64), the same memory. Tolerance 0 (integer outputs)."""
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


def _pairpack_np(rows):
    return np.ascontiguousarray(rows.reshape(-1, 128))


def test_bucket_decode_plain_matches_pallas(layout):
    """B9's plain version on the pair-packed bucket rows against JAX's
    bucket_decode in interpret mode and probe_bucket's XLA decode; the
    port's probe_bucket takes B9 only when MC_PROBE_PALLAS names it."""
    import os
    d = layout
    flat = d["flat"].copy()
    flat[5::7] ^= np.uint32(0x10)           # more misses in real buckets
    bp = _pairpack_np(d["brows"])
    h = (flat >> np.uint32(32 - d["bits"])).astype(np.int32)
    want_i, want_f = jpp.bucket_decode(jnp.asarray(bp)[h >> 1],
                                       jnp.asarray(h & 1),
                                       jnp.asarray(flat), tile=64)
    os.environ["MC_PROBE_PALLAS"] = "0"
    try:
        xla_i, xla_f = probe_bucket(jnp.asarray(flat), jnp.asarray(bp),
                                    d["bits"])
    finally:
        del os.environ["MC_PROBE_PALLAS"]
    idx, found = D.bucket_decode(_t(bp), _t(flat), d["bits"])
    for got, w1, w2 in ((idx, want_i, xla_i), (found, want_f, xla_f)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w1))
        np.testing.assert_array_equal(got.numpy(), np.asarray(w2))
    assert found.numpy().any() and not found.numpy().all()
    assert (h & 1).any() and not (h & 1).all()


@pytest.mark.parametrize("gate", ["0", "bucket", "1"])
def test_probe_bucket_128_lanes(layout, gate, monkeypatch):
    """probe_bucket on 128-lane rows equals it on the 64-lane rows they
    pack, with the gate off (torch ops on the view) and on (B9)."""
    from metacache_tpu_torch.ops import probe as tprobe
    d = layout
    calls = []
    plain = D.bucket_decode_plain
    monkeypatch.setattr(D, "bucket_decode_plain",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setenv("MC_PROBE_PALLAS", gate)
    got = tprobe.probe_bucket(_t(d["flat"]), _t(_pairpack_np(d["brows"])),
                              d["bits"])
    want = tprobe.probe_bucket(_t(d["flat"]), _t(d["brows"]), d["bits"])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert bool(calls) == (gate != "0")


def test_oidx_decode_plain_matches_pallas(layout):
    """B8's plain version (lane 2 of the matching logical head row, else
    0) against JAX's oidx_decode in interpret mode, both parities."""
    d = layout
    idx = d["idx"]
    want = jpp.oidx_decode(_pairpack(d["hl"])[idx >> 1],
                           jnp.asarray(idx & 1), jnp.asarray(d["flat"]),
                           tile=64)
    got = D.oidx_decode(_t(d["hl"]), _t(idx), _t(d["flat"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() > 0).any() and (got.numpy() == 0).any()
    assert (idx & 1).any() and not (idx & 1).all()


@pytest.mark.parametrize("gate", ["0", "oidx"])
@pytest.mark.parametrize("alt", [256, 0])
def test_probe_rows_pair_packed_matches_xla(layout, gate, alt, monkeypatch):
    """probe_rows on pair-packed head rows (tag hpack): B8 then B7 where
    JAX runs oidx_decode (the oidx stage named, full runs), else B7 alone,
    against JAX's XLA decode of the (F / 2, 128) rows."""
    d = layout
    calls = []
    plain = D.oidx_decode_plain
    monkeypatch.setattr(D, "oidx_decode_plain",
                        lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setenv("MC_PROBE_PALLAS", "0")
    tag = ("two_tier", HSL, True, False, SB)
    want = jrows.probe_rows(
        jnp.asarray(d["flat"].reshape(-1, F)), jnp.asarray(d["feats"]),
        None, _pairpack(d["hl"]), jnp.asarray(d["ovf"]), SPF,
        prefix_starts=jnp.asarray(d["brows"]), prefix_bits=d["bits"],
        dense=tag, alt_runs=alt, pack_bits=SB)
    monkeypatch.setenv("MC_PROBE_PALLAS", gate)
    t = _tables(d)
    t.packed = True
    assert t.dense == tag
    got = trows.probe_rows(_t(d["flat"].reshape(-1, F)), t, alt_runs=alt,
                           pack_bits=SB)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert bool(calls) == (gate == "oidx" and alt > 0)


def test_decode_wrappers_check_shapes(layout):
    d = layout
    head, idx, flat = _t(d["hl"]), _t(d["idx"]), _t(d["flat"])
    with pytest.raises(ValueError):
        D.head_decode(head, idx, flat, 62, 64, F)      # hsl past the row
    with pytest.raises(ValueError):
        D.full_decode(head, _t(d["ovf"]), idx, flat, HSL, SPF, 128, F)
    with pytest.raises(ValueError):
        D.head_decode(head, idx[:-1], flat, HSL, 64, F)
    with pytest.raises(ValueError):
        D.oidx_decode(head[:, :2], idx, flat)          # no lane 2
    with pytest.raises(ValueError):
        D.bucket_decode(_t(d["brows"]), flat, d["bits"])   # 64-lane rows


I32_MAX = 2**31 - 1
_POISON = 0x5A5A5A5A     # what the model reads from row words never loaded


def _b6_model(head, idx, flat, hsl, rl, f):
    """B6 as the kernel computes it: a warp takes 32 consecutive probes;
    lane i reads probe p0 + i's row index (clamped) and feature and its
    row's meta as one 16-byte word (feature, count, ovf id, slot 0),
    giving the count and lim = min(count, hsl). A probe's rl / 4 output
    int4s go to a group of g threads (16 at rl <= 64, else 32), thread t
    taking int4s t, t + g, ...; it loads row int4 q only where
    4 q < 3 + lim (else nothing: the model reads poison there). Output
    int4 q holds slots 4q..4q+3, row lanes 4q+3..4q+6: the last lane of
    row int4 q and the first three of int4 q + 1, from the neighbouring
    thread; slots at or past lim are I32_MAX, and blocks of g int4s past
    hsl store I32_MAX whole. Odd probes ((p % f) & 1) store int4 q at
    rl / 4 - 1 - q, its values reversed."""
    nf, hw = head.shape
    n = len(idx)
    nq = rl // 4
    g = 32 if rl > 64 else 16
    pk = np.full((n, rl), _POISON, np.int64)
    cnt = np.zeros(n, np.int64)
    for p0 in range(0, n, 32):
        for p in range(p0, min(p0 + 32, n)):
            row = head[min(max(int(idx[p]), 0), nf - 1)]
            meta = row[:4]
            c = int(meta[1]) if meta[0] == flat[p] and flat[p] != -1 else 0
            cnt[p] = c
            lim = min(max(c, 0), hsl)
            odd = (p % f) & 1
            # 3 + lim <= hw: no int4 past the row is ever loaded
            quads = [row[4 * q:4 * q + 4] if 4 * q < 3 + lim
                     else np.full(4, _POISON) for q in range(nq + 1)]
            for q0 in range(0, nq, g):
                for t in range(g):
                    q = q0 + t
                    if q >= nq:
                        continue
                    if 4 * q0 >= hsl:
                        vals = np.full(4, I32_MAX)
                    else:
                        cur, nxt = quads[q], quads[q + 1]
                        vals = np.array([cur[3], nxt[0], nxt[1], nxt[2]])
                        vals = np.where(4 * q + np.arange(4) < lim, vals,
                                        I32_MAX)
                    if odd:
                        pk[p, 4 * (nq - 1 - q):4 * (nq - q)] = vals[::-1]
                    else:
                        pk[p, 4 * q:4 * q + 4] = vals
    return pk, cnt


@pytest.mark.parametrize("f", [1, 16])
@pytest.mark.parametrize("rl", [64, 128, 256])
def test_b6_model_matches_pallas(layout, rl, f):
    """B6's warp-of-32 layout (16-byte meta, the shift by 3 lanes by
    neighbouring int4s, mirrored int4s of odd probes, row words loaded
    only below lim) equals the interpreted Pallas kernel it replaces and
    its plain version, on 144 (f 16) or 137 (f 1) probes, not a multiple
    of 32, with misses, sentinels and indices past both ends clamped."""
    d = layout
    rng = np.random.default_rng(rl + f)
    n = 144 if f == 16 else 137
    nf = len(d["feats"])
    idx = rng.integers(0, nf, n)
    flat = d["feats"][idx].view(np.int32).copy()
    miss = rng.random(n) < 0.3
    flat[miss] = rng.integers(1, 2**31 - 1, int(miss.sum()))
    flat[::29] = -1
    idx[5::31] = nf + 7
    idx[7::37] = -3
    idx = idx.astype(np.int32)
    pk, cnt = _b6_model(d["hl"], idx, flat, HSL, rl, f)
    assert not (pk == _POISON).any()
    ci = np.clip(idx, 0, nf - 1)
    want_pk, want_cnt = jpp.head_decode(
        _pairpack(d["hl"])[ci >> 1], jnp.asarray(ci & 1),
        jnp.asarray(flat.view(np.uint32)), HSL, rl, f, tile=64)
    np.testing.assert_array_equal(pk, np.asarray(want_pk))
    np.testing.assert_array_equal(cnt, np.asarray(want_cnt))
    got_pk, got_cnt = D.head_decode(_t(d["hl"]), _t(idx), _t(flat), HSL,
                                    rl, f)
    np.testing.assert_array_equal(got_pk.numpy(), pk)
    np.testing.assert_array_equal(got_cnt.numpy(), cnt)
    assert (cnt > HSL).any() and (cnt == 0).any() and (cnt > 0).any()
