"""metacache_tpu_torch's bucket probe on the CPU against metacache_tpu's:
B9's plain version (bucket_decode_plain) on every width of a bucket-row
index, pair-packed 128-lane rows and the host's 64, 65 and 129 lanes,
against JAX's probe_bucket (its XLA decode, MC_PROBE_PALLAS=0) and, on
the pair-packed rows, its Pallas bucket_decode in interpret mode; its
u64 form against probe_bucket64; classed_bucket's plain version against
probe_bucket_classed; classed_decode's plain version, full depth and
head only, against JAX's _classed_probe and _classed_head_slots, and
through probe_rows and probe_rows_head against JAX's. A numpy model of
each kernel's warp algorithm (B9's chunks of 64 lanes and its shuffle
sum; classed_bucket's 32 probes a warp, P lanes a probe and U steps, its
two segment sums and the results gathered back to the probes' lanes, at
every lane and step count the source allows; classed_decode's head form
as 16-byte quads shifted by 2 or 3 lanes from the neighbour's, mirrored
for odd probes, zero past the half, and its 4-byte path; its full form's
output lanes) is held against the plain versions. The cases
(tests/test_torch_cuda.py::bucket_case, classed_csr, classed_kind_probes)
hold misses, sentinels, garbage addresses, every cell class at even and
odd indices, counts that leave a warp part-filled, a bucket at full
span, counts 0, below, at and past the 61-slot head and class C's
overflow rows. Tolerance 0 (integer outputs)."""
import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metacache_tpu.ops import probe as jprobe
from metacache_tpu.ops import probe_pallas as jpp
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops import table_device as jtd
from metacache_tpu_torch.db.state import tables_from_device
from metacache_tpu_torch.ops import probe as tprobe
from metacache_tpu_torch.ops import probe_decode as D
from metacache_tpu_torch.ops import rows as trows
from test_torch_cuda import (BUCKET_WIDTHS, CLASSED_KINDS, bucket_case,
                             bucket_flat, classed_csr, classed_garbage,
                             classed_kind_probes, classed_layout,
                             classed_probes)

torch.set_num_threads(2)
CPU = torch.device("cpu")
I32_MAX = 2**31 - 1


def _jax_bucket(d, monkeypatch):
    """JAX's probe_bucket / probe_bucket64 (XLA decode) on the case."""
    monkeypatch.setenv("MC_PROBE_PALLAS", "0")
    flat = d["flat"]
    if flat.dtype == np.uint64:
        with jax.enable_x64(True):
            out = jprobe.probe_bucket64(jnp.asarray(flat),
                                        jnp.asarray(d["brows"]), d["bits"])
            return [np.asarray(x) for x in out]
    out = jprobe.probe_bucket(jnp.asarray(flat), jnp.asarray(d["brows"]),
                              d["bits"])
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("width", BUCKET_WIDTHS)
def test_bucket_decode_plain_matches_jax(width, wide, monkeypatch):
    """B9's plain version, and probe_bucket / probe_bucket64 on CPU
    tensors, equal JAX's probe_bucket / probe_bucket64 on every index
    width: the sentinel's id before the clamp too; with ``hi`` the id is
    clamped into [0, hi]."""
    d = bucket_case(width, wide)
    want_i, want_f = _jax_bucket(d, monkeypatch)
    brows, flat = torch.from_numpy(d["brows"]), bucket_flat(d)
    got_i, got_f = D.bucket_decode(brows, flat, d["bits"])
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    probe = tprobe.probe_bucket64 if wide else tprobe.probe_bucket
    hi = d["nf"] - 1
    ci, cf = probe(flat, brows, d["bits"], hi)
    np.testing.assert_array_equal(ci.numpy(), np.clip(want_i, 0, hi))
    np.testing.assert_array_equal(cf.numpy(), want_f)
    sent = d["flat"] == np.iinfo(d["flat"].dtype).max
    assert want_f.any() and not want_f[sent].any()
    assert (want_i[sent] > hi).any()         # padding lanes matched


def test_bucket_decode_plain_matches_pallas():
    """On the pair-packed rows B9's plain version equals JAX's Pallas
    bucket_decode in interpret mode, both halves of a 128-lane row."""
    d = bucket_case("pair")
    flat = d["flat"]
    h = (flat >> np.uint32(32 - d["bits"])).astype(np.int32)
    want_i, want_f = jpp.bucket_decode(jnp.asarray(d["brows"])[h >> 1],
                                       jnp.asarray(h & 1),
                                       jnp.asarray(flat), tile=64)
    got_i, got_f = D.bucket_decode(torch.from_numpy(d["brows"]),
                                   bucket_flat(d), d["bits"])
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want_f))
    assert (h & 1).any() and not (h & 1).all()


def _butterfly(x):
    """The warp's __shfl_xor_sync sum over its 32 lanes, (32, N) uint32:
    every lane ends with the total, mod 2^32."""
    lane = np.arange(32)
    for o in (16, 8, 4, 2, 1):
        x = x + x[lane ^ o]
    return x


def _i32(x):
    return np.asarray(x, np.uint32).view(np.int32)


def _b9_model(brows, flat, bits, hi=None):
    """B9 as the kernel computes it: one warp a probe walks the logical
    row h in chunks of 64 lanes, lane l taking lanes c0 + 2l and
    c0 + 2l + 1 (even widths: one 8-byte load) or c0 + l and c0 + 32 + l
    (odd widths); each lane sums the ranks of its matching lanes, the
    warp adds them by shuffles and lane 0 adds the row's start (int32
    wrap), then clamps."""
    lanes = 64 if brows.shape[1] == 128 else brows.shape[1]
    rows64 = brows.reshape(-1, lanes)
    wide = flat.dtype == np.uint64
    h = (flat >> (np.uint64(64 - bits) if wide
                  else np.uint32(32 - bits))).astype(np.int64)
    key = (flat & flat.dtype.type(0xFFFFFFFF)).astype(np.uint32) \
        .view(np.int32)
    row = rows64[h]
    local = np.zeros((32, len(flat)), np.uint32)
    anym = np.zeros((32, len(flat)), bool)
    for c0 in range(0, lanes, 64):
        for lane in range(32):
            j0, j1 = ((c0 + 2 * lane, c0 + 2 * lane + 1) if lanes % 2 == 0
                      else (c0 + lane, c0 + 32 + lane))
            for j in (j0, j1):
                if 1 <= j < lanes:
                    m = row[:, j] == key
                    local[lane] += np.where(m, j - 1, 0).astype(np.uint32)
                    anym[lane] |= m
    total = _butterfly(local)[0]
    idx = _i32(row[:, 0].view(np.uint32) + total)
    if hi is not None:
        idx = np.clip(idx, 0, max(hi, 0))
    return idx, anym.any(axis=0) & (flat != np.iinfo(flat.dtype).max)


@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("width", BUCKET_WIDTHS)
def test_bucket_model_matches_plain(width, wide):
    d = bucket_case(width, wide, seed=7, n=1500)
    brows, flat = torch.from_numpy(d["brows"]), bucket_flat(d)
    for hi in (None, d["nf"] - 1):
        mi, mf = _b9_model(d["brows"], d["flat"], d["bits"], hi)
        pi, pf = D.bucket_decode_plain(brows, flat, d["bits"], hi)
        np.testing.assert_array_equal(pi.numpy(), mi)
        np.testing.assert_array_equal(pf.numpy(), mf)


@pytest.mark.parametrize("gate", [None, "0", "1", "bucket", "head,full",
                                  "bucket,oidx"])
def test_every_gate_takes_b9(gate, monkeypatch):
    """probe_bucket and probe_bucket64 take B9's wrapper (its plain
    version on CPU tensors) under every MC_PROBE_PALLAS, with the same
    result."""
    calls = []
    plain = D.bucket_decode_plain
    monkeypatch.setattr(D, "bucket_decode_plain",
                        lambda *a: calls.append(1) or plain(*a))
    if gate is None:
        monkeypatch.delenv("MC_PROBE_PALLAS", raising=False)
    else:
        monkeypatch.setenv("MC_PROBE_PALLAS", gate)
    for wide, probe in ((False, tprobe.probe_bucket),
                        (True, tprobe.probe_bucket64)):
        d = bucket_case(65, wide, n=300)
        got = probe(bucket_flat(d), torch.from_numpy(d["brows"]), d["bits"])
        want = _b9_model(d["brows"], d["flat"], d["bits"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w)
    assert len(calls) == 2


@pytest.mark.parametrize("value", ["2", "bucket,decode", "yes"])
def test_probe_pallas_refuses_other_values(value, monkeypatch):
    d = bucket_case("pair", n=10)
    monkeypatch.setenv("MC_PROBE_PALLAS", value)
    with pytest.raises(ValueError, match="MC_PROBE_PALLAS"):
        tprobe.probe_bucket(bucket_flat(d), torch.from_numpy(d["brows"]),
                            d["bits"])


def test_bucket_decode_refuses_bad_shapes():
    d = bucket_case(64, n=10)
    brows, flat = torch.from_numpy(d["brows"]), bucket_flat(d)
    with pytest.raises(ValueError):
        D.bucket_decode(brows, flat, d["bits"] + 1)        # 2^bits rows
    with pytest.raises(ValueError):
        D.bucket_decode(brows[:, :1], flat, d["bits"])     # no lane 1
    with pytest.raises(ValueError):
        D.bucket_decode(brows, flat.to(torch.int16), d["bits"])
    with pytest.raises(ValueError):
        D.bucket_decode(brows.to(torch.int64), flat, d["bits"])
    with pytest.raises(ValueError):
        tprobe.probe_bucket64(flat, brows, d["bits"])      # u32 features
    with pytest.raises(ValueError):
        tprobe.probe_bucket(flat.to(torch.int64), brows, d["bits"])


# ------------------------------------------------------- the classed cells
@pytest.fixture(scope="module")
def classed():
    """classed_csr staged by JAX's builder and the port's (MC_CLASSED=1,
    dense rows refused), the port's tables, and probes."""
    csr = classed_csr()
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MC_CLASSED", "1")
        jc = jtd.device_layout_from_csr(*csr, cap=254, budget_bytes=4 << 20,
                                        allow_dense=False)
    tc = classed_layout(csr, CPU)
    assert jc.classed and tc.classed and tc.head_slots == 61
    lin = np.zeros((60, 21), np.int32)
    flat = classed_probes(csr[0], tc.bbits)
    return dict(csr=csr, jc=jc, tc=tc, flat=flat,
                tables=tables_from_device(tc, lin, lin[:, 0].copy()))


def _tag(dt):
    return ("classed", dt.head_slots, dt.packed, dt.ovf_packed, dt.slot_bits)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def test_classed_staging_equals_jax(classed):
    for name in ("uniq", "offsets", "head", "ovf", "brows"):
        want = np.asarray(getattr(classed["jc"], name))
        got = getattr(classed["tc"], name).numpy()
        np.testing.assert_array_equal(
            got, want.view(np.int32) if want.dtype == np.uint32 else want)


def _jax_pidx(classed):
    jc = classed["jc"]
    return [np.asarray(x) for x in jprobe.probe_bucket_classed(
        jnp.asarray(classed["flat"]), jc.brows, jc.bbits)]


def test_classed_bucket_plain_matches_jax(classed):
    tc = classed["tc"]
    got = D.classed_bucket(tc.brows, _t(classed["flat"]), tc.bbits)
    want = _jax_pidx(classed)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    f = want[1]
    assert f.any() and not f.all() and not f[:3].any()
    assert len(set((want[0][f] & 3).tolist())) == 3     # classes A, B, C


def test_classed_case_covers_its_edges(classed):
    """The staged probes reach counts 0, below, at and past the head,
    class C cells with and without overflow rows, every class."""
    tc = classed["tc"]
    pidx, found = D.classed_bucket(tc.brows, _t(classed["flat"]), tc.bbits)
    _pk, cnt = D.classed_decode(tc.head, tc.ovf, pidx, _t(classed["flat"]),
                                61, tc.spf, 61, 1, tc.slot_bits,
                                tc.slot_bits, head=True)
    cnt, cls = cnt.numpy(), pidx.numpy() & 3
    assert (cnt[~found.numpy()] == 0).all()
    for depth in (1, 13, 29, 60, 61, 62, 100):
        assert (cnt == depth).any(), depth
    assert ((cls == 2) & (cnt > 61)).any() and ((cls == 2) & (cnt <= 61)).any()


@pytest.mark.parametrize("head", [False, True])
def test_classed_decode_plain_matches_jax(classed, head):
    """classed_decode's plain version at full depth (rl = c) against
    JAX's _classed_probe, and head only (rl = hsl) against JAX's
    _classed_head_slots masked to min(count, hsl), with its counts."""
    jc, tc = classed["jc"], classed["tc"]
    pidx = _jax_pidx(classed)[0]
    flat = jnp.asarray(classed["flat"])
    hsl, c, sb = tc.head_slots, tc.spf, tc.slot_bits
    got = D.classed_decode(tc.head, tc.ovf, torch.from_numpy(pidx.copy()),
                           _t(classed["flat"]), hsl, c, hsl if head else c,
                           1, sb, sb, head=head)
    if head:
        _w, _f, cnt, _c, slots = jrows._classed_head_slots(
            flat, jc.head, _tag(jc), jnp.asarray(pidx))
        j = np.arange(hsl)[None, :]
        cnt = np.asarray(cnt)
        want = np.where(j < np.minimum(cnt, hsl)[:, None], np.asarray(slots),
                        I32_MAX)
        np.testing.assert_array_equal(got[1].numpy(), cnt)
    else:
        want = np.asarray(jrows._classed_probe(
            flat, jc.head, jc.ovf, _tag(jc), c, jnp.asarray(pidx))[0])
    np.testing.assert_array_equal(got[0].numpy(), want)


@pytest.mark.parametrize("pack", ["slot", "rebase", "unpack"])
@pytest.mark.parametrize("alt", [0, 128, 256])
def test_classed_probe_rows_match_jax(classed, alt, pack):
    """probe_rows through classed_bucket and classed_decode (plain
    versions) equals JAX's, alternating runs off and at powers of two
    >= c, in the stored encoding, re-based and as (tgt, win)."""
    jc = classed["jc"]
    q = classed["flat"][:4096].reshape(-1, 16)
    bits = {"slot": jc.slot_bits, "rebase": jc.slot_bits + 2,
            "unpack": 0}[pack]
    want = jrows.probe_rows(jnp.asarray(q), jc.uniq, jc.offsets, jc.head,
                            jc.ovf, jc.spf, jc.brows, jc.bbits, 0,
                            _tag(jc), alt_runs=alt, pack_bits=bits)
    got = trows.probe_rows(_t(q), classed["tables"], alt_runs=alt,
                           pack_bits=bits)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("alt", [0, 64, 128])
def test_classed_head_rows_match_jax(classed, alt):
    """probe_rows_head through classed_decode's head form equals JAX's:
    slots and over flags."""
    jc = classed["jc"]
    q = classed["flat"][:4096].reshape(-1, 16)
    want_pk, want_over = jrows.probe_rows_head(
        jnp.asarray(q), jc.head, jc.brows, jc.bbits, _tag(jc),
        alt_runs=alt, pack_bits=jc.slot_bits)
    pk, over = trows.probe_rows_head(_t(q), classed["tables"], alt_runs=alt,
                                     pack_bits=jc.slot_bits)
    np.testing.assert_array_equal(pk.numpy(), np.asarray(want_pk))
    np.testing.assert_array_equal(over.numpy(), np.asarray(want_over))
    assert over.numpy().any() and not over.numpy().all()


def _kernel_constant(name):
    """An int constexpr of csrc/probe_decode.cu (the kernels' lanes and
    steps), so the models follow the source."""
    src = os.path.join(os.path.dirname(D.__file__), os.pardir, "csrc",
                       "probe_decode.cu")
    with open(src) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


LANE = np.arange(32)


def _seg_sum(x, p):
    """The __shfl_xor_sync sum over each aligned segment of p lanes of
    (W, 32) uint32 / int64 values: every lane ends with its segment's
    total (uint32: mod 2^32)."""
    o = p // 2
    while o:
        x = x + x[:, LANE ^ o]
        o //= 2
    return x


def _cb_row_lane(p, lane_in_probe, r):
    """cb_row_lane: the row lane of word r of a probe's lane l."""
    l = lane_in_probe
    return 2 * l + r if p == 32 else 4 * l + 4 * p * (r >> 2) + (r & 3)


def _classed_bucket_model(brows, flat, bits, lanes=None, steps=None):
    """classed_bucket as the kernel computes it: one warp takes 32
    consecutive probes (lane i loads probe i's feature; past n a
    sentinel); it decodes G = 32 / P probes a step, P lanes each (P =
    ``lanes``, kCBLanes by default), lane l of a probe holding row lanes
    cb_row_lane(l, r), the U = ``steps`` (kCBSteps) steps' rows loaded
    before any is reduced (rows past n read as zeros); each lane sums
    idx2 + (cls << 16) over its matching entries and the probe's lanes
    add by xor shuffles, the match flag by a segment-masked ballot; pre
    is a second segment sum, the bases come from the probe's first lanes;
    lane i then takes its probe's result from its probe's first lane."""
    P = lanes or _kernel_constant("kCBLanes")
    U = steps or _kernel_constant("kCBSteps")
    G, R = 32 // P, 64 // P
    n = len(flat)
    nw = -(-n // 32)
    fv = np.full(nw * 32, 0xFFFFFFFF, np.uint32)
    fv[:n] = flat.view(np.uint32)
    fv = fv.reshape(nw, 32)
    pos = np.arange(nw)[:, None] * 32
    rows = brows.reshape(-1, 64).view(np.uint32)
    kmask = np.uint32((1 << (32 - bits)) - 1)
    g, l = LANE // P, LANE % P
    src = LANE - l
    rlane = np.stack([_cb_row_lane(P, l, r) for r in range(R)], 1)  # (32, R)
    mine = np.zeros((nw, 32), np.uint32)
    mine_hit = np.zeros((nw, 32), bool)
    for i0 in range(0, 32, G * U):
        for u in range(U):
            i = i0 + u * G + g
            f = fv[:, i]
            live = pos + i < n
            h = (f >> np.uint32(32 - bits)).astype(np.int64)
            w = np.where(live[..., None],
                         rows[h[..., None], rlane[None]], np.uint32(0))
            key = f & kmask
            acc = np.zeros((nw, 32), np.uint32)
            anym = np.zeros((nw, 32), bool)
            ents = []
            for q in range(2 * R):
                r = rlane[:, q >> 1]
                x = (w[..., q >> 1] >> np.uint32(16)) if q & 1 else \
                    (w[..., q >> 1] & np.uint32(0xFFFF))
                e = x - np.uint32(1)
                valid = (r >= 3) & (x != 0)
                idx2 = 2 * (r - 3) + (q & 1)
                m = valid & ((e & np.uint32(0x3FFF)) == key)
                acc += np.where(m, (idx2 + ((e >> np.uint32(14)) <<
                                            np.uint32(16))).astype(np.uint32),
                                np.uint32(0))
                anym |= m
                ents.append((valid, e >> np.uint32(14), idx2))
            acc = _seg_sum(acc, P)
            hit = anym.reshape(nw, G, P).any(-1).repeat(P, 1) & \
                (f != np.uint32(0xFFFFFFFF))
            j = (acc & np.uint32(0xFFFF)).astype(np.int64)
            cls = acc >> np.uint32(16)
            pre = np.zeros((nw, 32), np.int64)
            for valid, ecls, idx2 in ents:
                pre += valid & (ecls == cls) & (idx2 < j)
            pre = _seg_sum(pre, P)
            a = w[:, src, 0]
            b = w[:, src, 1]
            c = w[:, src + (1 if P == 32 else 0), 2 % R]
            base = np.where(cls == 0, a, np.where(cls == 1, b, c))
            w16 = np.where(cls == 0, 1, np.where(cls == 1, 2, 4))
            addr = (base.astype(np.int64) + pre * w16) & 0xFFFFFFFF
            res = np.where(hit, ((addr << 2) & 0xFFFFFFFF) |
                           cls.astype(np.int64), 0).astype(np.uint32)
            frm = (LANE % G) * P
            sel = (LANE // (G * U) == i0 // (G * U)) & \
                ((LANE % (G * U)) // G == u)
            mine[:, sel] = res[:, frm][:, sel]
            mine_hit[:, sel] = hit[:, frm][:, sel]
    return _i32(mine.reshape(-1)[:n]), mine_hit.reshape(-1)[:n]


def test_classed_bucket_model_matches_plain(classed):
    tc = classed["tc"]
    flat = classed["flat"][:1500]
    mp, mf = _classed_bucket_model(tc.brows.numpy(), flat, tc.bbits)
    pp, pf = D.classed_bucket_plain(tc.brows, _t(flat), tc.bbits)
    np.testing.assert_array_equal(pp.numpy(), mp)
    np.testing.assert_array_equal(pf.numpy(), mf)


@pytest.mark.parametrize("n", [1, 45, 1500])
@pytest.mark.parametrize("lanes,steps", [(4, 2), (8, 1), (8, 2), (8, 4),
                                         (16, 2), (32, 2), (32, 4)])
def test_classed_bucket_designs_match_plain(classed, lanes, steps, n):
    """classed_bucket's lane counts (4, 8 or 16 lanes a probe, 16-byte
    loads; 32, one 8-byte load each) and step counts, on probe counts
    that leave a warp's last steps part-filled."""
    tc = classed["tc"]
    flat = classed["flat"][:n]
    mp, mf = _classed_bucket_model(tc.brows.numpy(), flat, tc.bbits, lanes,
                                   steps)
    pp, pf = D.classed_bucket_plain(tc.brows, _t(flat), tc.bbits)
    np.testing.assert_array_equal(pp.numpy(), mp)
    np.testing.assert_array_equal(pf.numpy(), mf)


@pytest.mark.parametrize("kind", CLASSED_KINDS)
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("cls", [0, 1, 2])
def test_classed_bucket_model_kinds_match_plain(classed, cls, parity, kind):
    """classed_bucket's model against its plain version on 45 probes of
    one kind (stored features of class ``cls`` cells, misses, sentinels,
    random features) at even or odd indices."""
    tc = classed["tc"]
    flat = classed_kind_probes(tc, cls, parity, kind)[0]
    mp, mf = _classed_bucket_model(tc.brows.numpy(), flat, tc.bbits)
    pp, pf = D.classed_bucket_plain(tc.brows, _t(flat), tc.bbits)
    np.testing.assert_array_equal(pp.numpy(), mp)
    np.testing.assert_array_equal(pf.numpy(), mf)
    if kind == "found":
        assert mf.sum() == len(flat[parity::2])
        assert ((mp[mf] & 3) == cls).all()


def _classed_head_model(cells, pidx, flat, hsl, rl, f, steps=None):
    """classed_decode's head form as the kernel computes it: one warp
    takes 32 consecutive probes; lane i reads probe i's cell address
    (half a16 >> 2, clamped; 16-lane offset sh), the cell's feature and
    count, and keeps lim = min(count, hsl), the shift s (3 for class C,
    else 2) and the parity. rl a multiple of 4 (the 16-byte path): groups
    of 16 threads copy two probes a step, ``steps`` steps' loads first;
    thread t loads the half's int4 sh / 4 + t where 4t < s + lim and it
    lies in the half (else zeros), takes the next s lanes from thread t +
    1 (the group's last thread: zeros) and writes output int4 t, mirrored
    and reversed for odd probes, slots at or past lim I32_MAX; output
    int4s from 16 on are padding. Else (the 4-byte path) lane l writes
    output lanes l, l + 32, ..., slot j from half lane sh + s + j, 0 past
    the half. ``steps``: kCHSteps by default."""
    steps = steps or _kernel_constant("kCHSteps")
    halves = cells.reshape(-1, 64)
    n = len(flat)
    nw = -(-n // 32)
    pi = np.zeros(nw * 32, np.uint32)
    pi[:n] = pidx.view(np.uint32)
    fv = np.full(nw * 32, -1, np.int32)
    fv[:n] = flat
    a16 = pi >> np.uint32(2)
    hr = np.minimum(a16 >> np.uint32(2), len(halves) - 1).astype(np.int64)
    sh = (16 * (a16 & 3)).astype(np.int64)
    live = np.arange(nw * 32) < n
    found = (halves[hr, sh] == fv) & (fv != -1)
    cnt = np.where(found, halves[hr, sh + 1], 0)
    lim = np.where(live, np.clip(cnt, 0, hsl), 0)
    s = np.where((pi & 3) == 2, 3, 2)
    odd = (np.arange(nw * 32) % f) & 1 == 1
    out = np.full((nw * 32, rl), -12345, np.int32)     # never written
    if rl % 4:
        for c in range(rl):
            j = np.where(odd, rl - 1 - c, c)
            lane = sh + s + j
            v = np.where(lane < 64, halves[hr, np.minimum(lane, 63)], 0)
            out[:, c] = np.where(j < lim, v, I32_MAX)
        return out[:n], cnt[:n]
    nq = rl // 4
    t, grp = LANE & 15, LANE >> 4
    wbase = np.arange(nw)[:, None] * 32
    for i0 in range(0, 32, 2 * steps):
        for u in range(steps):
            pr = wbase + i0 + 2 * u + grp                   # (W, 32)
            k = sh[pr] // 4 + t
            need = (k < 16) & (4 * t < s[pr] + lim[pr])
            quads = halves[hr[pr]].reshape(nw, 32, 16, 4)
            cur = np.where(need[..., None], np.take_along_axis(
                quads, np.minimum(k, 15)[..., None, None], 2)[:, :, 0], 0)
            nxt = np.where((t < 15)[None, :, None],
                           cur[:, np.minimum(LANE + 1, 31)], 0)
            s3 = (s[pr] == 3)[..., None]
            vals = np.where(s3, np.concatenate([cur[..., 3:], nxt[..., :3]],
                                               -1),
                            np.concatenate([cur[..., 2:], nxt[..., :2]], -1))
            j = 4 * t[:, None] + np.arange(4)
            vals = np.where(j[None] < lim[pr][..., None], vals, I32_MAX)
            od = odd[pr]
            q = np.where(od, nq - 1 - t, t)
            vals = np.where(od[..., None], vals[..., ::-1], vals)
            ok = (pr < n) & (t < nq)
            out4 = out.reshape(nw * 32, nq, 4)
            out4[pr[ok], q[ok]] = vals[ok]
            # the padding: thread t of a group stores int4s 16 + t, 32 +
            # t, ... of its probe (mirrored for odd probes)
            for q2 in range(16, nq):
                tl = q2 % 16 + 16 * np.arange(2)        # the two groups
                p2 = pr[:, tl][pr[:, tl] < n]
                out4[p2, np.where(odd[p2], nq - 1 - q2, q2)] = I32_MAX
    return out[:n], cnt[:n]


def _classed_decode_model(cells, ovf, pidx, flat, hsl, c, rl, f, sb, pb,
                          head):
    """classed_decode as the kernel computes it (``head``: its head
    form, _classed_head_model): one warp a probe reads the cell's 64-lane
    half (a16 >> 2, clamped) at the cell's 16-lane offset, then lane l
    writes output lanes l, l + 32, ..., slot j (mirrored for odd
    features) from the half (zero past its end) below hsl, else from the
    overflow row, re-encoded."""
    if head:
        return _classed_head_model(cells, pidx, flat, hsl, rl, f)
    halves = cells.reshape(-1, 64)
    a16 = pidx.view(np.uint32) >> np.uint32(2)
    sh = (16 * (a16 & 3)).astype(np.int64)
    half = halves[np.minimum(a16 >> 2, len(halves) - 1).astype(np.int64)]
    pr = np.arange(len(flat))
    found = (half[pr, sh] == flat) & (flat != -1)
    cnt = np.where(found, half[pr, sh + 1], 0)
    isC = (pidx.view(np.uint32) & 3) == 2
    lim = np.clip(cnt, 0, hsl if head else c)
    sb0 = sh + np.where(isC, 3, 2)
    o = np.where(found & isC, half[pr, sh + 2], 0)
    orow = ovf[np.clip(o, 0, len(ovf) - 1)]
    odd = (pr % f) & 1 == 1
    outs = [np.empty((len(flat), rl), np.int32) for _ in range(1 if pb else 2)]
    for lane in range(32):
        for p in range(lane, rl, 32):
            j = np.where(odd, rl - 1 - p, p)
            src = np.minimum(sb0 + j, 63)
            hv = np.where(sb0 + j < 64, half[pr, src], 0)
            ov = orow[pr, np.clip(j - hsl, 0, orow.shape[1] - 1)]
            a = np.where(j < lim, np.where(j < hsl, hv, ov), I32_MAX)
            u = a.view(np.uint32)
            pad = a == I32_MAX
            if pb == sb:
                outs[0][:, p] = a
            elif pb:
                outs[0][:, p] = np.where(pad, I32_MAX, _i32(
                    ((u >> np.uint32(sb)) << np.uint32(pb)) |
                    (u & np.uint32((1 << sb) - 1))))
            else:
                outs[0][:, p] = np.where(pad, I32_MAX, _i32(u >> np.uint32(sb)))
                outs[1][:, p] = np.where(pad, I32_MAX,
                                         _i32(u & np.uint32((1 << sb) - 1)))
    return (outs[0], cnt) if head else tuple(outs)


@pytest.mark.parametrize("probes", ["staged", "garbage"])
@pytest.mark.parametrize("mode", ["head", "pass", "rebase", "unpack"])
@pytest.mark.parametrize("alt,f", [(0, 1), (128, 16)])
def test_classed_decode_model_matches_plain(classed, alt, f, mode, probes):
    tc = classed["tc"]
    hsl, c, sb = tc.head_slots, tc.spf, tc.slot_bits
    if probes == "staged":
        flat = classed["flat"][:1024].view(np.int32)
        pidx = D.classed_bucket(tc.brows, _t(flat), tc.bbits)[0].numpy()
    else:
        pidx, flat = classed_garbage(tc.head.numpy(), 1024)
    head = mode == "head"
    pb = {"head": sb, "pass": sb, "rebase": sb + 2, "unpack": 0}[mode]
    rl = alt or (hsl if head else c)
    args = (hsl, c, rl, f if alt else 1, sb, pb, head)
    want = _classed_decode_model(tc.head.numpy(), tc.ovf.numpy(), pidx,
                                 flat, *args)
    got = D.classed_decode_plain(tc.head, tc.ovf, torch.from_numpy(pidx),
                                 torch.from_numpy(flat), *args)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("mode", ["head", "pass"])
@pytest.mark.parametrize("kind", CLASSED_KINDS)
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("cls", [0, 1, 2])
def test_classed_decode_model_kinds_match_plain(classed, cls, parity, kind,
                                                mode):
    """classed_decode's model, head form at rl 64 and full form at rl
    256 (f 16), against its plain version on 45 probes of one kind and
    class at even or odd indices: stored features, misses, sentinels and
    garbage addresses."""
    tc = classed["tc"]
    flat, pidx = classed_kind_probes(tc, cls, parity, kind)
    head = mode == "head"
    args = (tc.head_slots, tc.spf, 64 if head else 256, 16, tc.slot_bits,
            tc.slot_bits, head)
    want = _classed_decode_model(tc.head.numpy(), tc.ovf.numpy(), pidx,
                                 flat, *args)
    got = D.classed_decode_plain(tc.head, tc.ovf, torch.from_numpy(pidx),
                                 torch.from_numpy(flat), *args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (want[0] != I32_MAX).any() == (kind in ("found", "garbage"))


@pytest.mark.parametrize("n", [1, 45, 1024])
@pytest.mark.parametrize("rl", [61, 64, 100, 256])
@pytest.mark.parametrize("steps", [4, 8, 16])
def test_classed_head_designs_match_plain(classed, steps, rl, n):
    """The head form's model at U = 4, 8 and 16 steps, on rl of the 4-byte
    path (61) and of the 16-byte path (64; 100 and 256 with padding int4s
    past the 16th), on n staged probes and n garbage addresses."""
    tc = classed["tc"]
    flat = classed["flat"][:n].view(np.int32)
    pidx = D.classed_bucket(tc.brows, _t(flat), tc.bbits)[0].numpy()
    gp, gf = classed_garbage(tc.head.numpy(), n)
    pidx, flat = np.concatenate([pidx, gp]), np.concatenate([flat, gf])
    want = _classed_head_model(tc.head.numpy(), pidx, flat, tc.head_slots,
                               rl, 16, steps)
    got = D.classed_decode_plain(tc.head, None, torch.from_numpy(pidx),
                                 torch.from_numpy(flat), tc.head_slots,
                                 tc.spf, rl, 16, tc.slot_bits, tc.slot_bits,
                                 True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_classed_wrappers_refuse_bad_shapes(classed):
    tc = classed["tc"]
    flat = _t(classed["flat"][:64])
    pidx = D.classed_bucket(tc.brows, flat, tc.bbits)[0]
    sb, c = tc.slot_bits, tc.spf
    with pytest.raises(ValueError):
        D.classed_bucket(tc.brows.view(-1, 64), flat, tc.bbits)
    with pytest.raises(ValueError):
        D.classed_bucket(tc.brows, flat, tc.bbits + 1)
    for bad in (dict(hsl=62), dict(rl=c - 1), dict(head=True, pb=0),
                dict(cells=tc.head.view(-1, 64)), dict(ovf=None)):
        kw = dict(cells=tc.head, ovf=tc.ovf, hsl=61, rl=c, pb=sb,
                  head=False)
        kw.update(bad)
        with pytest.raises(ValueError):
            D.classed_decode(kw["cells"], kw["ovf"], pidx, flat, kw["hsl"],
                             c, kw["rl"], 1, sb, kw["pb"], head=kw["head"])
