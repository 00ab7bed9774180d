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
