"""metacache_tpu_torch's 64-bit features (k 17..32) against metacache_tpu,
with inputs made from a numpy seed, bit for bit: the plain u64 sketch
(the 64-bit sketch kernel's plain version, which a numpy model of the
kernel's steps is held against too), the u64 bucket-row index and
its probe, the u64 device layout (dense and two-tier rows with two meta
lanes) and the row steps on the wide layout tags: the per-read step, the
scan, and the escalation's head-only phase 1 and full-depth redo, in all
QueryResult fields.

JAX's 64-bit types are on only inside ``with jax.enable_x64(True):``, so
that no other test on the same worker sees them."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from metacache_tpu.ops import probe as jprobe
from metacache_tpu.ops import rows as jrows
from metacache_tpu.ops import table_device as jtd
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu.ops.table import FeatureTable as JFeatureTable
from metacache_tpu_torch.db.state import tables_from_device
from metacache_tpu_torch.ops import probe as tprobe
from metacache_tpu_torch.ops import rows as trows
from metacache_tpu_torch.ops import sketch as S
from metacache_tpu_torch.ops import table_device as ttd
from metacache_tpu_torch.ops.table import pack_locations, unpack_locations

torch.set_num_threads(2)
ARGS = (1, 0.5, 19, 0)    # hits_min, hits_diff, highest rank, merge rank
NTGT = 24
CPU = torch.device("cpu")


def _jax_sketch64(codes, valid, k, s=16):
    with jax.enable_x64(True):
        out = jax_sketch(jnp.asarray(codes), jnp.asarray(valid), k=k,
                         sketchlen=s)
        return np.asarray(out).view(np.int64)


# ------------------------------------------------------------- sketch
def _pack(codes):
    """(n, 4 m) codes 0..3 -> (n, m) bytes, four a byte, low bits first
    (the runner's infeed)."""
    return np.ascontiguousarray(codes[:, 0::4] | (codes[:, 1::4] << 2) |
                                (codes[:, 2::4] << 4) | (codes[:, 3::4] << 6))


def _sketch64_windows(k, w, seed, n=96):
    """n windows of w codes: ambiguous codes and runs of them, an
    all-ambiguous window, a period-4 window and one whose every start is
    the same k-mer; valid lengths below k, at k, at the chunk boundary
    (128 + k - 2, 128 + k - 1 and 128 + k, where the window holds
    them), at and past w, 0, and random."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, w), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.02] = 4
    codes[3::13, 10:50] = 4
    codes[4] = 4
    codes[5] = np.tile(np.array([0, 1, 2, 3], np.uint8), w)[:w]
    codes[9] = 0
    valid = rng.integers(0, w + 1, n).astype(np.int32)
    valid[::7] = w
    valid[1::11] = k - 1
    valid[2::13] = k
    valid[6] = w + 30
    valid[8] = 0
    valid[9] = w
    for i, vl in zip((10, 12, 15), (128 + k - 2, 128 + k - 1, 128 + k)):
        valid[i] = min(vl, w)
    return codes, valid


@pytest.mark.parametrize("w", [96, 127, 128, 255, 511, 1024])
@pytest.mark.parametrize("k", [17, 18, 24, 31, 32])
def test_sketch64_plain_matches_jax(k, w):
    """Windows with ambiguous codes and runs of them, repeated windows,
    valid lengths below k, at k, at the 128-start chunk boundary, at and
    past w, and random; s = 1 and 16, and 128 at w >= 255 (JAX's
    sketcher takes s up to w - k + 1); windows of several chunks at w
    511 and 1024. The packed infeed (no ambiguous code) through
    sketch_windows_packed, rows of w / 4 bytes and, cropped, of 1, 7
    and 25 bytes, equals JAX's sketch of the unpacked codes, padded with
    code 4 to 128 (JAX's sketcher takes no window narrower than k +
    s - 1)."""
    codes, valid = _sketch64_windows(k, w, seed=k * 1000 + w)
    for s in (1, 16, 128) if w >= 255 else (1, 16):
        want = _jax_sketch64(codes, valid, k, s)
        got = S.sketch_windows(torch.from_numpy(codes),
                               torch.from_numpy(valid), k, s)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    if w <= 128:
        clean = np.where(codes < 4, codes, 1).astype(np.uint8)
        for nb in sorted({w // 4} | {b for b in (1, 7, 25) if b < w // 4}):
            pk = _pack(clean[:, :4 * nb])
            ref = np.full((len(clean), 128), 4, np.uint8)
            ref[:, :4 * nb] = clean[:, :4 * nb]
            for s in (1, 16) if nb == w // 4 else (16,):
                got = S.sketch_windows_packed(torch.from_numpy(pk),
                                              torch.from_numpy(valid), k, s)
                np.testing.assert_array_equal(
                    got.numpy(), _jax_sketch64(ref, valid, k, s),
                    err_msg=f"{nb} bytes")


_U64 = np.uint64
_SENT64 = _U64(2**64 - 1)


def _fmix64(x):
    with np.errstate(over="ignore"):
        x = x ^ (x >> _U64(33))
        x = x * _U64(0xFF51AFD7ED558CCD)
        x = x ^ (x >> _U64(33))
        x = x * _U64(0xC4CEB9FE1A85EC53)
        return x ^ (x >> _U64(33))


def _groups64(codes, pos, span):
    """The kernel's 4-code groups at positions pos (one a lane) of each
    row: codes 2 bits each, low bits first, in bits 0-7, the mask of the
    ambiguous ones in bits 8-11; codes at or past span read as 0."""
    g = np.zeros((codes.shape[0], len(pos)), np.uint64)
    for j in range(4):
        p = pos[None, :] + j
        c = np.where(p < span[:, None],
                     codes[:, np.minimum(pos + j, codes.shape[1] - 1)], 0)
        c = c.astype(np.uint64)
        g |= np.where(c < 4, c << _U64(2 * j), _U64(0x100 << j))
    return g


def _hashes64(x, nv, k, packed):
    """A chunk's hashed canonical k-mers, (n, 32 lanes, 4 starts), from
    each lane's word x (its group in bits 0-11, lanes 0-7 the group 128
    codes on in bits 16-27) as the kernel computes them: codes 4 lane ..
    4 lane + 35 from the next 8 lanes' words (the following lanes, past
    lane 31 the first lanes' second groups), the reverse complement of
    start j the complement of window bits [2j, 2j + 2k), the forward
    k-mer of codes 0 .. k - 2 the window's code order reversed, then
    rolled one code a step."""
    lane = np.arange(32)
    cw = x & _U64(0xFF)
    ch = np.zeros_like(cw)
    am = np.zeros_like(cw) if packed else (x >> _U64(8)) & _U64(0xF)
    for d in range(1, 9):
        y = x[:, (lane + d) & 31]
        g = np.where(lane + d < 32, y & _U64(0xFFF), y >> _U64(16))
        if d < 8:
            cw |= (g & _U64(0xFF)) << _U64(8 * d)
        else:
            ch = g & _U64(0xFF)
        if not packed:
            am |= ((g >> _U64(8)) & _U64(0xF)) << _U64(4 * d)
    kmask = _SENT64 if k == 32 else _U64((1 << (2 * k)) - 1)
    amask = _U64((1 << k) - 1)
    fw = np.zeros_like(cw)
    for b in range(64):                                  # __brevll
        fw |= ((cw >> _U64(b)) & _U64(1)) << _U64(63 - b)
    fw = ((fw >> _U64(1)) & _U64(0x5555555555555555)) | \
        ((fw & _U64(0x5555555555555555)) << _U64(1))
    fw >>= _U64(66 - 2 * k)
    sn = 2 * k - 2
    nxt = (cw >> _U64(sn)) | (ch << _U64(64 - sn))
    v = np.empty(x.shape + (4,), np.uint64)
    for j in range(4):
        fw = ((fw << _U64(2)) | ((nxt >> _U64(2 * j)) & _U64(3))) & kmask
        lw = (cw >> _U64(2 * j)) | (ch << _U64(64 - 2 * j)) if j else cw
        rc = ~lw & kmask
        ok = 4 * lane[None, :] + j < nv[:, None]
        if not packed:
            ok &= ((am >> _U64(j)) & amask) == 0
        v[:, :, j] = np.where(ok, _fmix64(np.minimum(fw, rc)), _SENT64)
    return v


def _pop64(v, where):
    v[where] = np.concatenate([v[where][:, 1:], np.full(
        (int(where.sum()), 1), _SENT64, np.uint64)], axis=1)


def _select64(v, s, run=None):
    """Each lane sorts its 4 values and drops its own duplicates; round r
    takes the warp's minimum of the lanes' heads (and, with a running
    sketch, of its lanes' heads), popped wherever it is a head ->
    (n, s) values of the s rounds, sentinels once the minimum is."""
    v = np.sort(v, axis=2)
    v[:, :, 1:][v[:, :, 1:] == v[:, :, :-1]] = _SENT64
    v = np.sort(v, axis=2)
    out = np.empty((v.shape[0], s), np.uint64)
    for r in range(s):
        head = v[:, :, 0] if run is None else np.minimum(v[:, :, 0],
                                                         run[:, :, 0])
        out[:, r] = m = head.min(axis=1)
        _pop64(v, v[:, :, 0] == m[:, None])
        if run is not None:
            _pop64(run, run[:, :, 0] == m[:, None])
    return out


def _sketch64_model(codes, valid, k, s, packed=False):
    """The 64-bit sketch kernel (csrc/sketch.cu::sketch64_kernel) as it
    computes: packed rows (W / 4 <= 32 bytes, lane l byte l, lanes past
    the row 0) in one chunk; coded rows by chunks of 128 starts, in one
    chunk where min(valid, W) - (k - 1) <= 128, else with a running
    sketch (value 32 q + lane in slot q of the lane) that each chunk's
    rounds merge into and replace."""
    n = codes.shape[0]
    span = np.clip(valid.astype(np.int64), 0,
                   4 * codes.shape[1] if packed else codes.shape[1])
    nst = span - (k - 1)
    lane = np.arange(32)

    def chunk(rows, lo):
        if packed:
            x = np.zeros((len(rows), 32), np.uint64)
            x[:, :codes.shape[1]] = codes[rows]
            return _hashes64(x, nst[rows], k, True)
        x = _groups64(codes[rows], lo + 4 * lane, span[rows])
        x[:, :8] |= _groups64(codes[rows], lo + 128 + 4 * lane[:8],
                              span[rows]) << _U64(16)
        return _hashes64(x, nst[rows] - lo, k, False)
    out = np.empty((n, s), np.uint64)
    one = np.nonzero(packed | (nst <= 128))[0]
    out[one] = _select64(chunk(one, 0), s)
    many = np.nonzero(~(packed | (nst <= 128)))[0]
    run = np.full((len(many), 32, 4), _SENT64, np.uint64)
    for lo in range(0, int(nst[many].max(initial=0)), 128):
        nxt = np.full((len(many), 128), _SENT64, np.uint64)
        nxt[:, :s] = _select64(chunk(many, lo), s, run.copy())
        nxt = nxt.reshape(-1, 4, 32).transpose(0, 2, 1)
        run = np.where((lo < nst[many])[:, None, None], nxt, run)
    out[many] = run.transpose(0, 2, 1).reshape(-1, 128)[:, :s]
    return out.view(np.int64)


@pytest.mark.parametrize("w", [128, 146, 255, 511, 1024])
@pytest.mark.parametrize("k", [17, 18, 32])
def test_sketch64_model_matches(k, w):
    """The 64-bit sketch kernel's steps (codes gathered from the
    following lanes' words, k-mers read off the 72-bit window and rolled,
    B1's rounds on u64 heads, the running sketch across 128-start
    chunks) equal its plain version, s = 1, 16 and 128, on coded rows
    and, at w = 128, on packed rows of 32, 25, 7 and 1 bytes."""
    codes, valid = _sketch64_windows(k, w, seed=k * 7 + w)
    for s in (1, 16, 128):
        np.testing.assert_array_equal(
            _sketch64_model(codes, valid, k, s),
            S.sketch_windows64_plain(torch.from_numpy(codes),
                                     torch.from_numpy(valid), k, s).numpy(),
            err_msg=f"s={s}")
    if w == 128:
        clean = np.where(codes < 4, codes, 3).astype(np.uint8)
        for nb in (32, 25, 7, 1):
            pk = _pack(clean[:, :4 * nb])
            np.testing.assert_array_equal(
                _sketch64_model(pk, valid, k, 16, packed=True),
                S.sketch_windows64_plain(torch.from_numpy(clean[:, :4 * nb]),
                                         torch.from_numpy(valid), k,
                                         16).numpy(), err_msg=f"{nb} bytes")


# ------------------------------------------------ bucket index + probe
# the generator of tests/test_u64_layout.py:_u64_table (that module
# switches JAX's 64-bit mode on for its whole process when imported)
def _u64_table(rng, nfeat=3000, ntgt=48, deep_every=9, cap=254):
    pool = rng.integers(0, 2**63, nfeat).astype(np.uint64) * 2 + 1
    pool = np.unique(pool)
    fs, ts, ws = [], [], []
    for i, fv in enumerate(pool):
        depth = 100 if i % deep_every == 0 else 4
        for j in range(depth):
            fs.append(fv)
            ts.append((i + j) % ntgt)
            ws.append(j % 40)
    f = np.asarray(fs, np.uint64)
    t = np.asarray(ts, np.uint32)
    w = np.asarray(ws, np.uint32)
    order = np.lexsort((w, t, f))
    return JFeatureTable.build(f[order].copy(),
                               pack_locations(t[order], w[order]),
                               max_locations_per_feature=cap)


@pytest.mark.parametrize("case", ["table", "bits12", "collision",
                                  "wide-span"])
def test_bucket_index64_and_probe_match_jax(case):
    """make_bucket_index64 equals JAX's (the rows and bits, or None for a
    low-32 collision within a bucket), and probe_bucket64 finds every
    stored feature and equals JAX's row ids and found flags on stored
    features, misses and the sentinel."""
    rng = np.random.default_rng(7)
    bits = None
    if case == "table":
        feats = _u64_table(rng).unique_features
    elif case == "bits12":
        feats, bits = _u64_table(rng, nfeat=500).unique_features, 12
    elif case == "collision":
        feats, bits = np.sort(np.asarray(
            [0x1234567800000001, 0x123456F800000001, 0x9000000000000005],
            np.uint64)), 12
    else:
        # 40 features in one 12-bit bucket: the index widens to 1 + 64
        feats = np.sort(np.concatenate([
            (np.uint64(0xABC) << np.uint64(52)) +
            rng.integers(0, 2**40, 40).astype(np.uint64),
            rng.integers(0, 2**63, 200).astype(np.uint64)]))
        feats, bits = np.unique(feats), 12
    want = jprobe.make_bucket_index64(feats, bits)
    got = tprobe.make_bucket_index64(feats, bits)
    if case == "collision":
        assert want is None and got is None
        return
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    q = np.concatenate([feats[rng.integers(0, len(feats), 64)],
                        rng.integers(0, 2**63, 32).astype(np.uint64) * 2,
                        np.asarray([2**64 - 1], np.uint64)])
    with jax.enable_x64(True):
        ji, jf = jprobe.probe_bucket64(jnp.asarray(q),
                                       jnp.asarray(want[0]), want[1])
        ji, jf = np.asarray(ji), np.asarray(jf)
    ti, tf = tprobe.probe_bucket64(torch.from_numpy(q.view(np.int64)),
                                   torch.from_numpy(got[0]), got[1])
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_array_equal(ti.numpy()[jf], ji[jf])
    assert jf[:64].all() and not jf[-1]
    np.testing.assert_array_equal(feats[ti.numpy()[:64]], q[:64])


# ------------------------------------------------------ device layout
def _index_bytes(ft):
    """Bytes of the u64 bucket index, which the port counts in its
    budget beside the rows (JAX counts the rows only)."""
    return tprobe.make_bucket_index64(ft.unique_features)[0].nbytes


def _layouts(ft, budget):
    """Both packages' layouts at a budget for the rows: the port's
    budget adds the bucket index's bytes."""
    ltgt, lwin = unpack_locations(ft.locations)
    got = ttd.device_layout_from_csr(ft.unique_features, ft.offsets, ltgt,
                                     lwin, device=CPU,
                                     budget_bytes=budget + _index_bytes(ft))
    with jax.enable_x64(True):
        want = jtd.device_layout_from_csr(ft.unique_features, ft.offsets,
                                          ltgt, lwin, budget_bytes=budget,
                                          nch=4)
        want = want._replace(**{f: np.asarray(getattr(want, f)) for f in
                                ("uniq", "offsets", "head", "ovf", "brows")})
    return got, want


@pytest.mark.parametrize("budget,dense", [(1 << 40, True), (3 << 19, False)])
def test_u64_device_layout_matches_jax(budget, dense):
    """device_layout_from_csr on u64 features: the same arrays as JAX's
    (uniq as int64 bits, offsets, head rows with [flo, fhi] meta, overflow
    rows, the host-built bucket index) and the same layout choices, at a
    budget that holds the dense rows and one that takes two-tier rows."""
    ft = _u64_table(np.random.default_rng(71))
    got, want = _layouts(ft, budget)
    assert want.dense == dense and got.dense == dense
    for f in ("bbits", "nf", "spf", "head_slots", "num_locations", "packed",
              "ovf_packed", "slot_bits", "max_win", "classed"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.uniq.dtype == torch.int64
    np.testing.assert_array_equal(got.uniq.numpy(), want.uniq.view(np.int64))
    for f in ("offsets", "head", "ovf", "brows"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f), err_msg=f)
    t = tables_from_device(got, np.zeros((1, 21), np.int32),
                           np.zeros(1, np.int32))
    assert t.wide and t.dense == (
        f"u64pk{got.slot_bits}" if dense else
        ("u64_two_tier", got.head_slots, False, False, got.slot_bits))


def test_u64_layout_budget_counts_the_bucket_index():
    """The rows and the bucket index share the budget: the dense rows
    stage where both fit, two-tier rows where the dense rows fit only
    without the index, and no layout where the budget holds the index
    alone (the runner then stages the CSR layout, as JAX's does)."""
    ft = _u64_table(np.random.default_rng(71))
    ltgt, lwin = unpack_locations(ft.locations)
    ib = _index_bytes(ft)
    rows = ttd.dense_bytes(ft.num_features, ft.max_bucket_size, 1,
                           wide=True)

    def layout(budget):
        return ttd.device_layout_from_csr(
            ft.unique_features, ft.offsets, ltgt, lwin, device=CPU,
            budget_bytes=budget)
    dt = layout(rows + ib)
    assert dt.dense and dt.layout_bytes == rows + ib == \
        dt.head.numel() * 4 + 512 + dt.brows.numel() * 4
    dt = layout(rows + ib - 1)
    assert not dt.dense and dt.layout_bytes <= rows + ib - 1
    with pytest.raises(MemoryError, match="budget"):
        layout(ib)


@pytest.mark.parametrize("seed", range(6))
def test_u64_collision_width_matches_jax(seed):
    """On features whose low 32 bits collide (a few thousand, low 32 bits
    from a small range, distinct ones apart in their top 13-16 bits):
    collision_free_bits64 is the least width at which JAX's
    make_bucket_index64 takes the table (from its least, 12), and the
    port's index equals JAX's at that width and refuses the table one bit
    below, as JAX's does."""
    rng = np.random.default_rng(seed)
    n, k = int(rng.integers(500, 4000)), 13 + seed % 4
    top = rng.integers(0, 2**k, n).astype(np.uint64) << np.uint64(64 - k)
    low = rng.integers(0, 2**int(rng.integers(6, 12)), n).astype(np.uint64)
    f = np.unique(top | low)
    b = tprobe.collision_free_bits64(f)
    assert 0 < b <= k
    b = max(b, 12)
    want = jprobe.make_bucket_index64(f, b)
    got = tprobe.make_bucket_index64(f, b)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] == b
    if b > 12:
        assert jprobe.make_bucket_index64(f, b - 1) is None
        assert tprobe.make_bucket_index64(f, b - 1) is None


def test_u64_bucket_index_widens_past_a_collision():
    """Two features of one 12-bit bucket with equal low 32 bits, apart in
    the 13th bit: JAX's index refuses the table (its runner then takes
    the CSR probe); the port's staging widens the index to 13 bits,
    where they part, and probes both."""
    f = np.asarray([0x1230000000000001, 0x1238000000000001,
                    0x5000000000000007], np.uint64)
    assert jprobe.make_bucket_index64(f) is None
    assert tprobe.collision_free_bits64(f) == 13
    dt = ttd.device_layout_from_csr(
        f, np.arange(4, dtype=np.int64), np.arange(3, dtype=np.uint32),
        np.zeros(3, np.uint32), device=CPU)
    assert dt.bbits == 13
    np.testing.assert_array_equal(
        dt.brows.numpy(), tprobe.make_bucket_index64(f, 13)[0])
    idx, found = tprobe.probe_bucket64(torch.from_numpy(f.view(np.int64)),
                                       dt.brows, dt.bbits)
    assert found.all() and idx.tolist() == [0, 1, 2]


@pytest.mark.parametrize("seed", range(4))
def test_collision_free_bits64_is_the_least_width(seed):
    """collision_free_bits64 against every width in turn: the least one
    at which no two features share their top bits and low 32 bits (0
    when all low 32 bits differ)."""
    rng = np.random.default_rng(seed)
    n = 300
    hi = rng.integers(0, 2**int(rng.integers(4, 33)), n).astype(np.uint64)
    f = np.unique((hi << np.uint64(32)) |
                  rng.integers(0, 8, n).astype(np.uint64))
    low = f & np.uint64(0xFFFFFFFF)

    def collides(bits):
        top = f >> np.uint64(64 - bits) if bits else np.zeros_like(f)
        return len({(t, l) for t, l in zip(top.tolist(), low.tolist())}) \
            < len(f)
    want = next(b for b in range(65) if not collides(b))
    assert tprobe.collision_free_bits64(f) == (want if collides(0) else 0)


def test_u64_device_layout_refuses_what_jax_does_not_stage():
    """Unpackable slots, and a low-32 collision within a bucket at every
    index width, raise MemoryError, where the runner falls back to the
    CSR layout, as JAX's does."""
    f = np.asarray([1 << 40, (1 << 40) + 5], np.uint64)
    offs = np.asarray([0, 1, 2], np.int64)
    with pytest.raises(MemoryError, match="slot-packable"):
        ttd.device_layout_from_csr(
            f, offs, np.asarray([1, 2**20], np.uint32),
            np.asarray([0, 2**14], np.uint32), device=CPU)
    f = np.asarray([0x1234567800000001, 0x1234567900000001], np.uint64)
    with pytest.raises(MemoryError, match="collision"):
        ttd.device_layout_from_csr(
            f, offs, np.zeros(2, np.uint32), np.zeros(2, np.uint32),
            device=CPU)


# ------------------------------------------------------ row steps
@pytest.fixture(scope="module")
def wide_case():
    """K = 2 stacks of 32 reads of 100 bp (some shorter than k, one
    empty), k = 18, s = 16, and a table of their features: each read's
    features point at its own target plus 0-2 random locations, every
    other read's at 100 (deeper than the two-tier head, 45); the dense and
    the two-tier u64 layouts of both packages (the budget just below the
    port's dense rows, whose 104 lanes JAX weighs as 128)."""
    rng = np.random.default_rng(18)
    K, B, W = 2, 32, 128
    codes = np.full((K, B, 1, W), 4, np.uint8)
    codes[..., :100] = rng.integers(0, 4, (K, B, 1, 100))
    lens = np.full((K, B, 1), 100, np.int32)
    lens[0, 3, 0] = 12
    lens[1, 5, 0] = 0
    codes[lens == 0] = 4
    mwir = np.full((K, B), 2, np.int32)
    feats = _jax_sketch64(codes.reshape(-1, W), lens.reshape(-1), 18) \
        .view(np.uint64).reshape(K * B, 16)
    fs, ts, ws = [], [], []
    seen = set()
    for r in range(K * B):
        for f in np.unique(feats[r]):
            if f == np.uint64(2**64 - 1) or int(f) in seen:
                continue
            seen.add(int(f))
            extra = 99 if r % 2 == 0 else int(rng.integers(0, 3))
            fs += [f] * (1 + extra)
            ts += [r % NTGT] + rng.integers(0, NTGT, extra).tolist()
            ws += [r % 5 + 3] + rng.integers(0, 40, extra).tolist()
    f = np.asarray(fs, np.uint64)
    t = np.asarray(ts, np.uint32)
    w = np.asarray(ws, np.uint32)
    order = np.lexsort((w, t, f))
    ft = JFeatureTable.build(f[order].copy(),
                             pack_locations(t[order], w[order]),
                             max_locations_per_feature=254)
    lin = np.zeros((NTGT, 21), np.int32)
    lin[:, 0] = -np.arange(NTGT) - 1
    lin[:, 4] = np.arange(NTGT) // 8 + 100
    lin[:, 20] = 1
    layouts = {}
    for name, budget in (("dense", 1 << 40), ("two_tier", None)):
        if budget is None:
            nf_pad = len(ttd.device_layout_from_csr(
                ft.unique_features, ft.offsets, *unpack_locations(
                    ft.locations), device=CPU).uniq)
            budget = ttd.dense_bytes(nf_pad, ft.max_bucket_size, 1,
                                     wide=True) - 1
        got, want = _layouts(ft, budget)
        assert got.dense == want.dense == (name == "dense") and \
            got.head_slots == want.head_slots
        tables = tables_from_device(got, lin, lin[:, 0].copy())
        tag = (f"u64pk{want.slot_bits}" if want.dense else
               ("u64_two_tier", want.head_slots, want.packed,
                want.ovf_packed, want.slot_bits))
        jtab = (jnp.asarray(want.uniq), jnp.asarray(want.offsets),
                jnp.asarray(want.head), jnp.asarray(want.ovf),
                jnp.asarray(lin[:, 0].copy()), jnp.asarray(lin),
                jnp.int32(ARGS[0]), jnp.float32(ARGS[1]),
                jnp.int32(ARGS[2]), jnp.int32(ARGS[3]),
                jnp.asarray(want.brows))
        layouts[name] = (tables, jtab, dict(
            slots_per_feature=want.spf, prefix_bits=want.bbits, dense=tag,
            pack_bits=want.slot_bits))
    return dict(codes=codes, lens=lens, mwir=mwir, layouts=layouts, K=K,
                B=B)


def _check_fields(got, want):
    for nm in want._fields:
        np.testing.assert_array_equal(getattr(got, nm).numpy(),
                                      np.asarray(getattr(want, nm)),
                                      err_msg=nm)


@pytest.mark.parametrize("layout", ["dense", "two_tier"])
@pytest.mark.parametrize("route", ["fused", "nonfused-allhits", "unpacked"])
def test_wide_query_step_rows_matches_jax(wide_case, layout, route):
    """query_step_rows on the u64 dense and two-tier rows, all nine
    fields: the fused candidates (walk), the non-fused path with per-hit
    lists and 8 candidates, and the slots decoded to (tgt, win)."""
    d = wide_case
    tables, jtab, jkw = d["layouts"][layout]
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              fused_candidates=True, emit_hits=False,
              pack_bits=jkw["pack_bits"])
    if route == "nonfused-allhits":
        kw.update(max_candidates=8, fast_top2=False, fused_candidates=False,
                  emit_hits=True)
    elif route == "unpacked":
        kw.update(pack_bits=0)
    codes, lens = d["codes"][0], d["lens"][0]
    mwir = d["mwir"][0]
    got = trows.query_step_rows(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(mwir), tables, *ARGS, k=18, sketchlen=16,
        windows_per_query=1, **kw)
    with jax.enable_x64(True):
        want = jrows.query_step_rows(
            jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(mwir),
            *jtab[:10], jtab[10], k=18, sketchlen=16, windows_per_query=1,
            **{**jkw, **kw})
        want = want._replace(**{f: np.asarray(getattr(want, f))
                                for f in want._fields})
    _check_fields(got, want)
    assert (got.cls_tax.numpy() != 0).sum() > d["B"] // 2


@pytest.mark.parametrize("infeed", ["coded", "packed"])
@pytest.mark.parametrize("layout", ["dense", "two_tier"])
def test_wide_scan_step_matches_jax(wide_case, layout, infeed):
    """The summary scan over K stacks on the u64 rows (the runner's
    packed infeed too, which the 64-bit sketch reads itself)."""
    d = wide_case
    tables, jtab, jkw = d["layouts"][layout]
    codes = d["codes"]
    if infeed == "packed":
        c = np.where(codes < 4, codes, 0).astype(np.uint8)[..., :100]
        codes = np.ascontiguousarray(
            c[..., 0::4] | (c[..., 1::4] << 2) | (c[..., 2::4] << 4) |
            (c[..., 3::4] << 6))
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              pack_bits=jkw["pack_bits"], infeed_packed=infeed == "packed")
    got = trows.query_step_rows_scan(
        torch.from_numpy(codes), torch.from_numpy(d["lens"]),
        torch.from_numpy(d["mwir"]), tables, *ARGS, k=18, sketchlen=16,
        windows_per_query=1, **kw)
    with jax.enable_x64(True):
        want = np.asarray(jrows.query_step_rows_scan(
            jnp.asarray(codes), jnp.asarray(d["lens"]),
            jnp.asarray(d["mwir"]), *jtab, k=18, sketchlen=16,
            windows_per_query=1, fused_candidates=True,
            **{**jkw, **kw}))
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.numpy() != 0).sum() > d["K"] * d["B"] // 2


def test_wide_escalation_steps_match_jax(wide_case):
    """Escalation phase 1 on the u64 two-tier rows (head rows, torch ops
    as JAX's XLA path) and the redo of the flagged reads at full depth:
    classified taxa, overflow bits, sketches and feature rows equal
    JAX's, and their merge equals the full-depth scan."""
    d = wide_case
    tables, jtab, jkw = d["layouts"]["two_tier"]
    K, B = d["K"], d["B"]
    inputs = [torch.from_numpy(d[k]) for k in ("codes", "lens", "mwir")]
    kw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
              pack_bits=jkw["pack_bits"])
    cls1, over, fk, ik = trows.query_step_rows_scan_head(
        *inputs, tables, *ARGS, k=18, sketchlen=16, **kw)
    with jax.enable_x64(True):
        jc, jo, jf, ji = (np.asarray(x) for x in
                          jrows.query_step_rows_scan_head(
            *(jnp.asarray(d[k]) for k in ("codes", "lens", "mwir")),
            *jtab, k=18, sketchlen=16, prefetch=True, return_feats=True,
            fused_candidates=True, **{**jkw, **kw}))
    np.testing.assert_array_equal(cls1.numpy(), jc)
    np.testing.assert_array_equal(over.numpy(), jo)
    np.testing.assert_array_equal(fk.numpy(), jf.view(np.int64))
    # a missing feature's row past the last real one: JAX keeps it, its
    # gather clamps it; the port clamps first
    nf = tables.num_features
    np.testing.assert_array_equal(ik.numpy(), np.minimum(ji, nf - 1))
    mask = (((over.numpy().reshape(-1)[:, None] >> np.arange(32)) & 1)
            .astype(bool).reshape(K * B))
    idxs = np.nonzero(mask)[0]
    assert 0 < len(idxs) < K * B
    sel = torch.from_numpy(idxs)
    cls2 = trows.query_step_rows_redo_scan(
        fk.reshape(-1, 16)[sel][None], ik.reshape(-1, 16)[sel][None],
        inputs[2].reshape(-1)[sel][None], tables, *ARGS,
        fused_candidates=True, **kw)
    with jax.enable_x64(True):
        jr = np.asarray(jrows.query_step_rows_redo_scan(
            jnp.asarray(jf.reshape(-1, 16)[idxs][None]),
            jnp.asarray(ji.reshape(-1, 16)[idxs][None]),
            jnp.asarray(d["mwir"].reshape(-1)[idxs][None]), *jtab[:-1],
            sketchlen=16, fused_candidates=True, **{**jkw, **kw}))
    np.testing.assert_array_equal(cls2.numpy(), jr)
    full = trows.query_step_rows_scan(
        *inputs, tables, *ARGS, k=18, sketchlen=16, windows_per_query=1,
        **kw).numpy().reshape(-1)
    merged = cls1.numpy().reshape(-1).copy()
    merged[idxs] = cls2.reshape(-1)
    np.testing.assert_array_equal(merged, full)
