"""metacache_tpu_torch's window sketchers (B1, B2 and their plain
versions) against metacache_tpu's sketchers and the NumPy oracle;
tolerance 0 (integer features)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from metacache_tpu.config import SketchingOptions
from metacache_tpu.core.sketch import sketch_codes
from metacache_tpu.ops.sketch_jax import sketch_windows as jax_sketch
from metacache_tpu.ops.sketch_pallas import (sketch_windows_pallas,
                                             sketch_windows_pallas_long)
from metacache_tpu_torch.ops import sketch as S
from test_torch_cuda import pack_2bit

torch.set_num_threads(2)


def _windows(case, n, w, seed):
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n, w)).astype(np.uint8)
    valid = np.full(n, w, np.int32)
    if case == "ambiguous":
        codes[rng.random((n, w)) < 0.03] = 4
        codes[1, 10:90] = 4
        codes[2, :] = 4
    elif case == "dups":
        codes[::2] = np.tile(np.array([0, 1, 2, 3], np.uint8), w)[:w]
        codes[1::4, :] = 2
    elif case == "short":
        valid = rng.integers(0, w + 1, n).astype(np.int32)
        valid[:4] = [0, 15, 16, 17]
    return codes, valid


def _port(codes, valid, k, s):
    got = S.sketch_windows(torch.from_numpy(codes), torch.from_numpy(valid),
                           k, s)
    return got.numpy().view(np.uint32)


CASES = ["random", "ambiguous", "dups", "short"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("w", [127, 100, 128])
def test_sketch_matches_jax(case, w):
    """Plain version == the XLA sort-based sketcher, padded widths < 128
    included."""
    codes, valid = _windows(case, 64, w, seed=w)
    want = np.asarray(jax_sketch(jnp.asarray(codes), jnp.asarray(valid),
                                 k=16, sketchlen=16))
    np.testing.assert_array_equal(_port(codes, valid, 16, 16), want)


@pytest.mark.parametrize("case", CASES)
def test_sketch_matches_pallas_interpret(case):
    """Plain version == the Pallas kernel it replaces, interpreted."""
    codes, valid = _windows(case, 64, 128, seed=5)
    valid = np.minimum(valid, 127)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(sketch_windows_pallas(
            jnp.asarray(codes), jnp.asarray(valid), k=16, sketchlen=16,
            tile=64))
    np.testing.assert_array_equal(_port(codes, valid, 16, 16), want)


@pytest.mark.parametrize("k,s", [(16, 16), (12, 8)])
def test_sketch_matches_oracle(k, s):
    """Plain version == the NumPy oracle window by window."""
    codes, valid = _windows("short", 48, 127, seed=k)
    codes[5, 30:40] = 4
    got = _port(codes, valid, k, s)
    opt = SketchingOptions(kmerlen=k, sketchlen=s, winlen=127)
    for i in range(len(codes)):
        want = sketch_codes(codes[i, :valid[i]], opt)
        want = np.zeros(0, np.uint32) if want is None else want
        row = got[i]
        np.testing.assert_array_equal(row[:len(want)], want)
        assert (row[len(want):] == 0xFFFFFFFF).all()


def _long_windows(w, k, seed):
    """The edge cases of tests/test_pallas.py:76-98 at width w: an
    ambiguous run across the first chunk cut, an all-ambiguous window,
    valid 130, k - 1, 113 and 250, repeated content, random lengths."""
    rng = np.random.default_rng(seed)
    n = 64
    codes = rng.integers(0, 4, (n, w)).astype(np.uint8)
    codes[3, 100:180] = 4
    codes[4, :] = 4
    codes[5] = np.tile(np.array([0, 1, 2, 3], np.uint8), w)[:w]
    codes[rng.random((n, w)) < 0.01] = 4
    valid = np.full(n, w, np.int32)
    valid[7] = 130
    valid[9] = k - 1
    valid[11] = 113
    valid[13] = 250
    valid[16:32] = rng.integers(0, w + 1, 16)
    return codes, valid


LONG = [(200, 12), (255, 16), (256, 16), (511, 16), (512, 16)]


@pytest.mark.parametrize("ref", ["pallas_long", "xla", "plain"])
@pytest.mark.parametrize("w,k", LONG)
def test_long_window_sketch_matches(w, k, ref):
    """W > 128 through sketch_windows on CPU tensors (B2's plain version,
    chunk and merge) == the interpreted Pallas kernel B2 replaces, the
    XLA sketcher and B1's plain version over the whole window."""
    codes, valid = _long_windows(w, k, seed=w + k)
    got = _port(codes, valid, k, 16)
    if ref == "pallas_long":
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(sketch_windows_pallas_long(
                jnp.asarray(codes), jnp.asarray(valid), k=k, sketchlen=16,
                tile=64))
    elif ref == "xla":
        want = np.asarray(jax_sketch(jnp.asarray(codes), jnp.asarray(valid),
                                     k=k, sketchlen=16))
    else:
        want = S.sketch_windows_plain(
            torch.from_numpy(codes), torch.from_numpy(valid), k, 16
        ).numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert (got[4] == 0xFFFFFFFF).all() and (got[9] == 0xFFFFFFFF).all()


_M32 = np.uint64(0xFFFFFFFF)


def _tm_hash(x):
    """thomas_mueller on uint64 arrays of u32 values."""
    m = np.uint64(0x45D9F3B)
    x = (((x >> np.uint64(16)) ^ x) * m) & _M32
    x = (((x >> np.uint64(16)) ^ x) * m) & _M32
    return (x >> np.uint64(16)) ^ x


def _take_s(vals, s):
    """The s smallest distinct values, sentinel padded."""
    u = np.unique(vals)[:s]
    return np.concatenate([u, np.full(s - len(u), 0xFFFFFFFF, np.uint64)])


def _whole_window_model(codes, valid, k, s):
    """B2 as the kernel computes it: per window the span min(valid, W);
    the k-mer and its reverse complement rolled one code a step, and the
    position of the last ambiguous code; a hash at each start p with
    p + k <= span and no ambiguous code, else the sentinel; spans up to
    512 in one sort + dedup + take s, wider ones in 512-char chunks at
    stride 512 - (k - 1), each chunk's s smallest distinct merged into a
    running sketch by sort + dedup + take s."""
    n, w = codes.shape
    span = np.clip(valid.astype(np.int64), 0, w)
    kmask = np.uint64((1 << (2 * k)) - 1)
    fw = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    last = np.full(n, -1)
    hashes = np.full((n, w), 0xFFFFFFFF, np.uint64)
    for t in range(w):
        amb = codes[:, t] >= 4
        c = np.where(amb, 0, codes[:, t]).astype(np.uint64)
        fw = ((fw << np.uint64(2)) | c) & kmask
        rc = (rc >> np.uint64(2)) | ((np.uint64(3) - c) <<
                                     np.uint64(2 * k - 2))
        last = np.where(amb, t, last)
        p = t - (k - 1)
        if p >= 0:
            ok = (last < p) & (t < span)
            hashes[:, p] = np.where(ok, _tm_hash(np.minimum(fw, rc)),
                                    0xFFFFFFFF)
    out = np.empty((n, s), np.uint64)
    stride = 512 - (k - 1)
    for i in range(n):
        nv = max(int(span[i]) - (k - 1), 0)
        if span[i] <= 512:
            out[i] = _take_s(hashes[i, :max(nv, 1)], s)
            continue
        run = np.full(s, 0xFFFFFFFF, np.uint64)
        for lo in range(0, nv, stride):
            cnt = min(int(span[i]) - lo, 512) - (k - 1)   # starts in chunk
            chunk = _take_s(hashes[i, lo:lo + cnt], s)
            run = _take_s(np.concatenate([run, chunk]), s)
        out[i] = run
    return out.astype(np.uint32)


@pytest.mark.parametrize("s", [8, 16, 128])
@pytest.mark.parametrize("k", [12, 16])
@pytest.mark.parametrize("w", [129, 200, 255, 256, 511, 512, 600, 1000])
def test_whole_window_model_matches(w, k, s):
    """B2's whole-window definition (rolling k-mers, ambiguity by the
    last ambiguous position, one sort, dedup and take s; 512-char chunks
    and a running sketch above 512) equals its plain version and the
    interpreted Pallas kernel it replaces, with valid lengths below k, at
    113, 128, 130 and 250, at W, past W and random."""
    codes, valid = _long_windows(w, k, seed=w + k + s)
    valid[17] = 128
    valid[18] = w + 37
    want = _whole_window_model(codes, valid, k, s)
    np.testing.assert_array_equal(_port(codes, valid, k, s), want)
    with pltpu.force_tpu_interpret_mode():
        jx = np.asarray(sketch_windows_pallas_long(
            jnp.asarray(codes), jnp.asarray(valid), k=k, sketchlen=s,
            tile=64))
    np.testing.assert_array_equal(jx, want)


def _unpack_model(packed):
    """The kernel's read of a packed row of W / 4 <= 32 bytes: lane l
    takes byte l (lanes past the row take 0), code j of the lane is bits
    2j..2j+1 (low bits first)."""
    n, wb = packed.shape
    out = np.zeros((n, 128), np.uint8)
    for j in range(4):
        out[:, j:4 * wb:4] = (packed >> (2 * j)) & 3
    return out


def _shfl_down(x, d):
    """__shfl_down_sync over the 32 lanes of axis 1: lanes past 31 keep
    their own value."""
    out = x.copy()
    out[:, :32 - d] = x[:, d:]
    return out


def _revcomp_codes(x, n):
    """The kernel's reverse complement of the n codes in the low 2n bits
    of x: bit reversal of x << (32 - 2n), each code's bits swapped back,
    complemented."""
    u64 = np.uint64
    x = (x << u64(32 - 2 * n)) & _M32
    r = np.zeros_like(x)
    for i in range(32):                                   # __brev
        r |= ((x >> u64(i)) & u64(1)) << u64(31 - i)
    r = ((r >> u64(1)) & u64(0x55555555)) | ((r & u64(0x55555555)) << u64(1))
    return r ^ u64((1 << (2 * n)) - 1)


def _b1_model(codes, valid, k, s, packed=False):
    """B1 as the kernel computes it: each lane packs its 4 codes 2 bits a
    code (first code highest) with a mask of ambiguous ones (none on
    packed rows), takes the next 16 codes and their mask from the
    following 4 lanes by shuffles into a 64-bit window, reads the first
    k - 1 codes off it whole (the reverse complement by bit reversal),
    rolls the k-mer and its reverse complement one code a step over its
    4 starts, and hashes the canonical k-mer at starts
    4 lane + j < min(valid, 128) - (k - 1) whose k codes hold no
    ambiguous one (on packed rows of W / 4 bytes the span ends at W).
    Selection: each lane sorts its 4 values and drops its duplicates,
    then s rounds take the warp's minimum of the lanes' first values,
    the lanes holding it popping it, stopping at the sentinel."""
    u64 = np.uint64
    span = 128
    if packed:
        span = 4 * codes.shape[1]
        codes = _unpack_model(codes)
    n = codes.shape[0]
    c = codes.reshape(n, 32, 4).astype(np.uint64)
    pc = np.zeros((n, 32), np.uint64)
    am = np.zeros((n, 32), np.uint64)
    for j in range(4):
        pc = (pc << u64(2)) | np.where(c[:, :, j] < 4, c[:, :, j], 0)
        am = (am << u64(1)) | (c[:, :, j] >= 4).astype(np.uint64)
    if packed:
        am[:] = 0
    win = pc << u64(56)
    amb = am << u64(28)
    for d in range(1, 5):
        win |= _shfl_down(pc, d) << u64(64 - 8 * (d + 1))
        amb |= _shfl_down(am, d) << u64(32 - 4 * (d + 1))
    kmask = u64((1 << (2 * k)) - 1)
    top = u64(2 * k - 2)
    fw = win >> u64(66 - 2 * k)
    rc = _revcomp_codes(fw, k - 1) << u64(2)
    nxt = ((win << top) & u64(2**64 - 1)) >> u64(56)
    nv = np.minimum(valid.astype(np.int64), span)[:, None] - (k - 1)
    lane = np.arange(32)[None, :]
    hashes = np.full((n, 32, 4), 0xFFFFFFFF, np.uint64)
    for j in range(4):
        b = (nxt >> u64(2 * (3 - j))) & u64(3)
        fw = ((fw << u64(2)) | b) & kmask
        rc = (rc >> u64(2)) | ((u64(3) - b) << top)
        amb_j = (((amb << u64(j)) & _M32) >> u64(32 - k)) != 0
        ok = (4 * lane + j < nv) & ~amb_j
        hashes[:, :, j] = np.where(ok, _tm_hash(np.minimum(fw, rc)),
                                   0xFFFFFFFF)
    out = np.full((n, s), 0xFFFFFFFF, np.uint64)
    v = np.sort(hashes, axis=2)
    v[:, :, 1:][v[:, :, 1:] == v[:, :, :-1]] = 0xFFFFFFFF
    v = np.sort(v, axis=2)
    for r in range(s):
        m = v[:, :, 0].min(axis=1)
        if (m == 0xFFFFFFFF).all():
            break                     # every window's rounds have stopped
        out[:, r] = m
        pop = v[:, :, 0] == m[:, None]
        v[pop] = np.concatenate([v[pop][:, 1:], np.full(
            (int(pop.sum()), 1), 0xFFFFFFFF, np.uint64)], axis=1)
    return out.astype(np.uint32)


def _b1_windows(k, seed, packed):
    """64 windows of 128 codes: valid below k, exactly k, 100, 127 and
    128, repeated content, all-ambiguous and partly ambiguous windows
    (not on packed rows, which hold none)."""
    rng = np.random.default_rng(seed)
    n = 64
    codes = rng.integers(0, 4, (n, 128)).astype(np.uint8)
    valid = rng.integers(0, 129, n).astype(np.int32)
    valid[:8] = [0, k - 1, k, k + 1, 100, 127, 128, 1]
    codes[8] = np.tile(np.array([0, 1, 2, 3], np.uint8), 32)
    codes[9] = 2
    codes[10, 64:] = codes[10, :64]
    valid[8:11] = 127
    if not packed:
        codes[13:][rng.random((n - 13, 128)) < 0.02] = 4
        codes[11] = 4
        codes[12, 30:50] = 5
        valid[11:13] = 127
    return codes, valid


@pytest.mark.parametrize("width", [128, 32, 28])
@pytest.mark.parametrize("s", [8, 16, 128])
@pytest.mark.parametrize("k", [12, 16])
def test_b1_model_matches(k, s, width):
    """B1's steps (the low-bits-first read of packed rows of 32 and 28
    bytes, the runner's rows cropped to 100 bp reads; k-mers rolled from
    2-bit words with ambiguity from the mask; s warp minima) equal its
    plain version (sketch_windows on CPU tensors of 128 codes, through
    the unpack for packed rows) and the interpreted Pallas kernel it
    replaces in both of its modes, on the codes padded with code 4."""
    packed = width < 128
    codes, valid = _b1_windows(k, seed=k * 131 + s + width, packed=packed)
    if width == 28:
        codes = codes.copy()
        codes[:, 112:] = 4             # what padding 112 codes gives
    feed = pack_2bit(codes[:, :4 * width]) if packed else codes
    want = _b1_model(feed, valid, k, s, packed=packed)
    if packed:
        got = S.sketch_windows_packed(torch.from_numpy(feed),
                                      torch.from_numpy(valid), k, s)
    else:
        got = S.sketch_windows(torch.from_numpy(codes),
                               torch.from_numpy(valid), k, s)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    for mode in ("sort", "extract"):
        with pltpu.force_tpu_interpret_mode():
            jx = np.asarray(sketch_windows_pallas(
                jnp.asarray(codes), jnp.asarray(valid), k=k, sketchlen=s,
                tile=64, mode=mode))
        np.testing.assert_array_equal(jx, want, err_msg=mode)
    assert (want[0] == 0xFFFFFFFF).all() and (want[1] == 0xFFFFFFFF).all()
    assert (want[2, 1:] == 0xFFFFFFFF).all() and want[2, 0] != 0xFFFFFFFF
    if not packed:
        assert (want[11] == 0xFFFFFFFF).all()


def test_unpack_2bit_low_bits_first():
    """The port's unpack of the infeed equals the kernel's read of it."""
    rng = np.random.default_rng(3)
    for wb in (32, 25):
        packed = rng.integers(0, 256, (16, wb)).astype(np.uint8)
        got = S.unpack_2bit(torch.from_numpy(packed)).numpy()
        assert got.shape == (16, 4 * wb)
        np.testing.assert_array_equal(got, _unpack_model(packed)[:, :4 * wb])
        np.testing.assert_array_equal(pack_2bit(got), packed)


@pytest.mark.parametrize("setting", [None, "sort", "extract"])
def test_sketch_mode_setting_matches_jax(setting, monkeypatch):
    """MC_SKETCH_MODE unset, "sort" and "extract": the port's sketches
    (unpacked and packed rows; the setting changes nothing in the port)
    equal JAX's Pallas dispatch under the same setting (rows.py:28-50,
    interpreted)."""
    from metacache_tpu.ops.rows import _sketch_dispatch
    if setting is None:
        monkeypatch.delenv("MC_SKETCH_MODE", raising=False)
    else:
        monkeypatch.setenv("MC_SKETCH_MODE", setting)
    codes, valid = _b1_windows(16, seed=7, packed=True)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(_sketch_dispatch(
            jnp.asarray(codes[:, :100]), jnp.asarray(valid), 16, 16, True))
    got = S.sketch_windows(torch.from_numpy(codes[:, :100]),
                           torch.from_numpy(valid), 16, 16)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    got = S.sketch_windows_packed(torch.from_numpy(pack_2bit(
        codes[:, :100])), torch.from_numpy(valid), 16, 16)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


def test_sketch_mode_rejects_unknown(monkeypatch):
    monkeypatch.setenv("MC_SKETCH_MODE", "bitonic")
    codes, valid = _b1_windows(16, seed=8, packed=True)
    with pytest.raises(ValueError, match="MC_SKETCH_MODE"):
        S.sketch_windows(torch.from_numpy(codes), torch.from_numpy(valid),
                         16, 16)
    with pytest.raises(ValueError, match="packed"):
        S.sketch_windows_packed(torch.from_numpy(codes),
                                torch.from_numpy(valid), 16, 16)
