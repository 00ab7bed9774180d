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
sum; classed_bucket's 8-byte loads, its packed sum and its ballots;
classed_decode's output lanes) is held against the plain versions. The
cases (tests/test_torch_cuda.py::bucket_case, classed_csr) hold misses,
sentinels, a bucket at full span, counts 0, below, at and past the
61-slot head and class C's overflow rows. Tolerance 0 (integer
outputs)."""
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
from test_torch_cuda import (BUCKET_WIDTHS, bucket_case, bucket_flat,
                             classed_csr, classed_garbage, classed_layout,
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


def _classed_bucket_model(brows, flat, bits):
    """classed_bucket as the kernel computes it: lane l of the warp loads
    row lanes 2l and 2l + 1 (one 8-byte load) and holds entries q = 0..3
    (lane 2l + (q >> 1), half q & 1); it sums idx2 + (cls << 16) over its
    matching entries, the warp adds by shuffles; pre is the popcount of
    four ballots of the valid entries of class cls before j; lanes 0 and
    1 give the bases."""
    h = (flat >> np.uint32(32 - bits)).astype(np.int64)
    key = (flat & np.uint32((1 << (32 - bits)) - 1)).astype(np.int64)
    row = brows.reshape(-1, 64)[h].view(np.uint32)
    n = len(flat)
    acc = np.zeros((32, n), np.uint32)
    anym = np.zeros((32, n), bool)
    ents = []
    for lane in range(32):
        for q in range(4):
            r = 2 * lane + (q >> 1)
            w = row[:, r]
            e = (w >> np.uint32(16)) if q & 1 else (w & np.uint32(0xFFFF))
            id2 = 2 * (r - 3) + (q & 1)
            live = (r >= 3) & (e != 0)
            em1 = (e - np.uint32(1)) & np.uint32(0xFFFF)
            m = live & ((em1 & np.uint32(0x3FFF)).astype(np.int64) == key)
            acc[lane] += np.where(m, np.uint32(id2 & 0xFFFFFFFF) +
                                  ((em1 >> np.uint32(14)) << np.uint32(16)),
                                  np.uint32(0)).astype(np.uint32)
            anym[lane] |= m
            ents.append((lane, q, id2, live, em1 >> np.uint32(14)))
    total = _butterfly(acc)[0]
    j = (total & np.uint32(0xFFFF)).astype(np.int64)
    cls = (total >> np.uint32(16)).astype(np.int64)
    pre = np.zeros(n, np.int64)
    for q in range(4):
        ballot = np.zeros(n, np.uint64)
        for lane, qq, id2, live, ecls in ents:
            if qq == q:
                same = live & (ecls.astype(np.int64) == cls) & (id2 < j)
                ballot |= same.astype(np.uint64) << np.uint64(lane)
        pre += np.array([bin(int(b)).count("1") for b in ballot])
    base = np.where(cls == 0, row[:, 0], np.where(cls == 1, row[:, 1],
                                                  row[:, 2]))
    w16 = np.where(cls == 0, 1, np.where(cls == 1, 2, 4)).astype(np.uint32)
    addr = (base + pre.astype(np.uint32) * w16).astype(np.uint32)
    hit = anym.any(axis=0) & (flat != np.uint32(0xFFFFFFFF))
    pidx = np.where(hit, (addr << np.uint32(2)) | cls.astype(np.uint32), 0)
    return _i32(pidx.astype(np.uint32)), hit


def test_classed_bucket_model_matches_plain(classed):
    tc = classed["tc"]
    flat = classed["flat"][:1500]
    mp, mf = _classed_bucket_model(tc.brows.numpy(), flat, tc.bbits)
    pp, pf = D.classed_bucket_plain(tc.brows, _t(flat), tc.bbits)
    np.testing.assert_array_equal(pp.numpy(), mp)
    np.testing.assert_array_equal(pf.numpy(), mf)


def _classed_decode_model(cells, ovf, pidx, flat, hsl, c, rl, f, sb, pb,
                          head):
    """classed_decode as the kernel computes it: one warp a probe reads
    the cell's 64-lane half (a16 >> 2, clamped) at the cell's 16-lane
    offset, then lane l writes output lanes l, l + 32, ..., slot j
    (mirrored for odd features) from the half (zero past its end) below
    hsl, else from the overflow row, re-encoded."""
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
