"""metacache_tpu_torch's slot sort (B3), candidate sweep + top-k (B4)
and two-key candidates (B5) against metacache_tpu's Pallas kernels
(interpreted on the CPU); tolerance 0 (integer outputs)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from metacache_tpu.ops.candidates_pallas import (candidates_pallas,
                                                 candidates_pallas_packed,
                                                 sort_pallas_packed)
from metacache_tpu_torch.ops import candidates as C

torch.set_num_threads(2)
I32_MAX = 2**31 - 1


def _pk(tgt, win, wbits):
    pk = (tgt.astype(np.int64) << wbits) | win
    return np.where(tgt == I32_MAX, I32_MAX, pk).astype(np.int32)


def _slots(rng, b, l, ntgt, nwin, wbits, fill=0.7, dup=False):
    tgt = np.full((b, l), I32_MAX, np.int64)
    win = np.full((b, l), I32_MAX, np.int64)
    for i in range(b):
        n = int(rng.integers(0, int(l * fill) + 1))
        tgt[i, :n] = rng.integers(0, ntgt, n)
        win[i, :n] = rng.integers(0, nwin, n)
    if dup:       # duplicate (tgt, win) runs like overlapping sketches
        d = rng.random((b, l)) < 0.5
        keep = tgt == I32_MAX
        tgt = np.where(keep, tgt, np.where(d, np.roll(tgt, 1, 1), tgt))
        win = np.where(keep, win, np.where(d, np.roll(win, 1, 1), win))
        win = np.where(tgt == I32_MAX, I32_MAX, win)
    return _pk(tgt, win, wbits)


def _alternating(pk, r):
    """Rows as the probe emits them for alt_runs = r: sorted runs of r
    lanes, odd runs reversed."""
    b, l = pk.shape
    runs = np.sort(pk.reshape(b, l // r, r), axis=2)
    runs[:, 1::2] = runs[:, 1::2, ::-1]
    return np.ascontiguousarray(runs.reshape(b, l))


def _port(pk, mwir, wbits, **kw):
    got = C.candidates_packed(torch.from_numpy(pk), torch.from_numpy(mwir),
                              wbits, **kw)
    return [g.numpy() for g in got]


def _jax(pk, mwir, wbits, **kw):
    got = candidates_pallas_packed(jnp.asarray(pk), jnp.asarray(mwir),
                                   wbits, **kw)
    return [np.asarray(g) for g in got]


@pytest.mark.parametrize("mode", ["walk", "dedup"])
@pytest.mark.parametrize("kk", [2, 4])
@pytest.mark.parametrize("presorted,split", [(0, False), (0, True),
                                             (64, False), (64, True)])
def test_candidates_match_pallas(mode, kk, presorted, split):
    rng = np.random.default_rng(kk * 7 + presorted)
    b, l, ntgt, nwin = 16, 512, 24, 60
    wbits = max(1, (2 * (nwin - 1)).bit_length())
    pk = _slots(rng, b, l, ntgt, nwin, wbits, dup=mode == "dedup")
    if presorted:
        pk = _alternating(pk, presorted)
    if mode == "walk":
        kw = dict(walk_elems=10)
        mwir = np.full(b, 3, np.int32)
    else:
        kw = dict(dedup_walk=6)
        mwir = np.full(b, 6, np.int32)
    want = _jax(pk, mwir, wbits, max_candidates=kk, presorted=presorted,
                split=split, **kw)
    got = _port(pk, mwir, wbits, max_candidates=kk, presorted=presorted,
                **kw)
    for w, g, nm in zip(want, got, ("tgt", "hits", "beg", "end")):
        np.testing.assert_array_equal(g, w, err_msg=nm)


@pytest.mark.parametrize("presorted", [0, 128])
def test_sort_matches_pallas(presorted):
    rng = np.random.default_rng(3)
    pk = _slots(rng, 8, 1024, 50, 400, 10)
    if presorted:
        pk = _alternating(pk, presorted)
    want = np.asarray(sort_pallas_packed(jnp.asarray(pk),
                                         presorted=presorted))
    got = C.sort_packed(torch.from_numpy(pk), presorted).numpy()
    np.testing.assert_array_equal(got, want)


def test_candidates_padding_narrow_rows():
    """Rows narrower than 128 lanes pad with I32_MAX like the JAX call."""
    rng = np.random.default_rng(4)
    pk = _slots(rng, 8, 32, 6, 20, 6)
    mwir = np.full(8, 2, np.int32)
    want = _jax(pk, mwir, 6, walk_elems=4, max_candidates=2)
    got = _port(pk, mwir, 6, walk_elems=4, max_candidates=2)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)


def test_candidates_topk_tie_stress():
    """The adversarial ties of tests/test_candidates_pallas.py:264: equal
    best hit counts across groups, duplicate slots, single-group rows,
    all groups tied at one hit, and a later group with more hits."""
    ntgt, l = 16, 192
    rows_t, rows_w = [], []
    t = np.full(l, I32_MAX, np.int64)
    w = np.full(l, I32_MAX, np.int64)
    for g in range(8):
        t[g * 6:(g + 1) * 6] = g
        w[g * 6:(g + 1) * 6] = 50
    rows_t.append(t.copy()); rows_w.append(w.copy())
    t[:] = I32_MAX; w[:] = I32_MAX
    t[:ntgt] = np.arange(ntgt)
    w[:ntgt] = np.arange(ntgt) * 7
    rows_t.append(t.copy()); rows_w.append(w.copy())
    t[:] = I32_MAX; w[:] = I32_MAX
    t[:10] = 3
    w[:10] = np.arange(10)
    rows_t.append(t.copy()); rows_w.append(w.copy())
    t[:] = I32_MAX; w[:] = I32_MAX
    t[:4] = 1; w[:4] = 9
    t[4:12] = 14; w[4:12] = 9
    rows_t.append(t.copy()); rows_w.append(w.copy())
    tgt, win = np.stack(rows_t), np.stack(rows_w)
    wbits = max(1, int(2 * win[win != I32_MAX].max()).bit_length())
    pk = _pk(tgt, win, wbits)
    mwir = np.full(len(pk), 3, np.int32)
    for kk in (2, 4):
        want = _jax(pk, mwir, wbits, walk_elems=12, max_candidates=kk)
        got = _port(pk, mwir, wbits, walk_elems=12, max_candidates=kk)
        for w_, g, nm in zip(want, got, ("tgt", "hits", "beg", "end")):
            np.testing.assert_array_equal(g, w_, err_msg=nm)


def test_candidates_reject_bad_arguments():
    pk = torch.full((2, 128), I32_MAX, dtype=torch.int32)
    mw = torch.full((2,), 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        C.candidates_packed(pk, mw, 8, max_candidates=2)      # no sweep
    with pytest.raises(ValueError):
        C.candidates_packed(pk, mw, 8, walk_elems=4, max_candidates=5)
    with pytest.raises(ValueError):
        C.sort_packed(pk[:, :100])


# ---------------------------------------------------------------- B5
def _pairs(rng, b, l, ntgt, nwin, fill=0.7, dup=False, empty_rows=()):
    """(tgt, win) int32 rows with (I32_MAX, I32_MAX) padding at the end,
    targets and windows past the packing bound of a many-target
    database (9217 targets, windows up to 71427)."""
    tgt = np.full((b, l), I32_MAX, np.int64)
    win = np.full((b, l), I32_MAX, np.int64)
    for i in range(b):
        if i in empty_rows:
            continue
        n = int(rng.integers(0, int(l * fill) + 1))
        base = rng.integers(0, ntgt - 8)
        tgt[i, :n] = base + rng.integers(0, 8, n)    # one strain group
        win[i, :n] = rng.integers(nwin - 60, nwin, n)
    if dup:
        d = rng.random((b, l)) < 0.5
        keep = tgt == I32_MAX
        tgt = np.where(keep, tgt, np.where(d, np.roll(tgt, 1, 1), tgt))
        win = np.where(keep, win, np.where(d, np.roll(win, 1, 1), win))
        win = np.where(tgt == I32_MAX, I32_MAX, win)
    return tgt.astype(np.int32), win.astype(np.int32)


def _alternating_pairs(tgt, win, r):
    """(tgt, win) rows as the probe emits them for alt_runs = r."""
    b, l = tgt.shape
    t = tgt.reshape(b, l // r, r).astype(np.int64)
    w = win.reshape(b, l // r, r).astype(np.int64)
    order = np.argsort((t << 32) | w, axis=2, kind="stable")
    t = np.take_along_axis(t, order, 2)
    w = np.take_along_axis(w, order, 2)
    t[:, 1::2] = t[:, 1::2, ::-1]
    w[:, 1::2] = w[:, 1::2, ::-1]
    return (np.ascontiguousarray(t.reshape(b, l)).astype(np.int32),
            np.ascontiguousarray(w.reshape(b, l)).astype(np.int32))


def _port_pairs(tgt, win, mwir, **kw):
    got = C.candidates_unpacked(torch.from_numpy(tgt), torch.from_numpy(win),
                                torch.from_numpy(mwir), **kw)
    return [g.numpy() for g in got]


def _jax_pairs(tgt, win, mwir, **kw):
    with pltpu.force_tpu_interpret_mode():
        got = candidates_pallas(jnp.asarray(tgt), jnp.asarray(win),
                                jnp.asarray(mwir), **kw)
    return [np.asarray(g) for g in got]


def _assert_same(want, got):
    for w, g, nm in zip(want, got, ("tgt", "hits", "beg", "end")):
        np.testing.assert_array_equal(g, w, err_msg=nm)


@pytest.mark.parametrize("mode", ["walk", "dedup"])
@pytest.mark.parametrize("kk", [1, 2, 3, 4])
@pytest.mark.parametrize("presorted", [0, 64])
def test_unpacked_candidates_match_pallas(mode, kk, presorted):
    """B5's plain version: walk and dedup sweeps, K = 1-4, shuffled rows
    and alternating presorted runs, with empty rows."""
    rng = np.random.default_rng(kk * 13 + presorted)
    b, l = 8, 512
    tgt, win = _pairs(rng, b, l, 9217, 71428, dup=mode == "dedup",
                      empty_rows=(2,))
    if presorted:
        tgt, win = _alternating_pairs(tgt, win, presorted)
    else:
        perm = rng.permuted(np.tile(np.arange(l), (b, 1)), axis=1)
        tgt = np.take_along_axis(tgt, perm, 1)
        win = np.take_along_axis(win, perm, 1)
    if mode == "walk":
        kw = dict(walk_elems=10)
        mwir = np.full(b, 3, np.int32)
    else:
        kw = dict(dedup_walk=6)
        mwir = np.full(b, 6, np.int32)
    want = _jax_pairs(tgt, win, mwir, max_candidates=kk,
                      presorted=presorted, **kw)
    got = _port_pairs(tgt, win, mwir, max_candidates=kk,
                      presorted=presorted, **kw)
    _assert_same(want, got)
    assert (got[0][2] == -1).all() and (want[0][2] == -1).all()


def test_unpacked_candidates_empty_and_narrow_rows():
    """All-padding rows give no candidate; rows narrower than 128 lanes
    pad with (I32_MAX, I32_MAX) like the JAX call."""
    tgt = np.full((4, 192), I32_MAX, np.int32)
    got = _port_pairs(tgt, tgt.copy(), np.full(4, 3, np.int32),
                      walk_elems=12, max_candidates=2)
    assert (got[0] == -1).all() and (got[1] == 0).all()
    rng = np.random.default_rng(5)
    tgt, win = _pairs(rng, 8, 40, 20, 30)
    mwir = np.full(8, 2, np.int32)
    _assert_same(_jax_pairs(tgt, win, mwir, walk_elems=4, max_candidates=2),
                 _port_pairs(tgt, win, mwir, walk_elems=4, max_candidates=2))


@pytest.mark.parametrize("kk", [2, 4])
def test_unpacked_candidates_topk_tie_stress(kk):
    """The adversarial ties of tests/test_candidates_pallas.py:264 on
    two keys: equal best hit counts across groups, duplicate slots, a
    single group, all groups tied at one hit, a later group with more
    hits, and targets beyond 2^13 (no slot packing)."""
    l = 192
    rows = []
    t = np.full(l, I32_MAX, np.int64)
    w = np.full(l, I32_MAX, np.int64)
    for g in range(8):
        t[g * 6:(g + 1) * 6] = 9000 + g
        w[g * 6:(g + 1) * 6] = 70000
    rows.append((t.copy(), w.copy()))
    t[:] = I32_MAX; w[:] = I32_MAX
    t[:16] = np.arange(16) * 500
    w[:16] = np.arange(16) * 4000
    rows.append((t.copy(), w.copy()))
    t[:] = I32_MAX; w[:] = I32_MAX
    t[:10] = 9216
    w[:10] = 71418 + np.arange(10)
    rows.append((t.copy(), w.copy()))
    t[:] = I32_MAX; w[:] = I32_MAX
    t[:4] = 1; w[:4] = 9
    t[4:12] = 8200; w[4:12] = 9
    rows.append((t.copy(), w.copy()))
    tgt = np.stack([r[0] for r in rows]).astype(np.int32)
    win = np.stack([r[1] for r in rows]).astype(np.int32)
    mwir = np.full(len(rows), 3, np.int32)
    _assert_same(_jax_pairs(tgt, win, mwir, walk_elems=12, max_candidates=kk),
                 _port_pairs(tgt, win, mwir, walk_elems=12,
                             max_candidates=kk))


def test_unpacked_candidates_reject_bad_arguments():
    t = torch.full((2, 128), I32_MAX, dtype=torch.int32)
    mw = torch.full((2,), 2, dtype=torch.int32)
    with pytest.raises(ValueError):
        C.candidates_unpacked(t, t, mw, max_candidates=2)       # no sweep
    with pytest.raises(ValueError):
        C.candidates_unpacked(t, t[:, :64], mw, walk_elems=4)
    with pytest.raises(ValueError):
        C.candidates_unpacked(t, t, mw, walk_elems=4, presorted=3)
