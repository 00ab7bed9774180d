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
                split=split, **kw)
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


# ------------------------------------------------ the kernels' algebra
# numpy models of the CUDA kernels' own steps (csrc/row_sort.cuh, and
# B5's sweep in csrc/candidates_unpacked.cu), held against the plain
# versions on adversarial rows
def _run_lane(i, r):
    """row_sort.cuh::run_lane: odd runs of r lanes reversed."""
    return np.where((r > 1) & ((i & r) != 0), i ^ (r - 1), i)


def _sort_regs(v):
    """row_sort.cuh::sort_regs on (threads, E) keys: the bitonic
    network with the kernel's compare-exchange indices."""
    v = v.copy()
    e = v.shape[1]
    size = 2
    while size <= e:
        stride = size >> 1
        while stride:
            for i in range(e):
                j = i ^ stride
                if j > i:
                    a, b = v[:, i].copy(), v[:, j].copy()
                    up = (i & size) == 0
                    v[:, i] = np.where((a < b) == up, a, b)
                    v[:, j] = np.where((a < b) == up, b, a)
            stride >>= 1
        size <<= 1
    return v


def _merge_runs(sm, run, t0, e):
    """row_sort.cuh::merge_runs for the thread whose first lane is t0."""
    a0 = t0 & ~(2 * run - 1)
    b0 = a0 + run
    diag = t0 - a0
    lo, hi = max(0, diag - run), min(diag, run)
    while lo < hi:
        m = (lo + hi) >> 1
        if sm[b0 + diag - 1 - m] < sm[a0 + m]:
            hi = m
        else:
            lo = m + 1
    ia, ib = a0 + lo, b0 + diag - lo
    out = []
    for _ in range(e):
        tb = ib < b0 + run and (ia >= b0 or sm[ib] < sm[ia])
        out.append(sm[ib] if tb else sm[ia])
        ib, ia = ib + tb, ia + (not tb)
    return out


def _block_sort_model(row, presorted, e):
    """row_sort.cuh::block_sort_row on one row loaded as the kernels load
    it: the register network below E, then the merge levels."""
    l2 = len(row)
    sm = np.empty(l2 + 1, row.dtype)
    sm[_run_lane(np.arange(l2), presorted)] = row
    run = max(presorted, 1)
    if run < e:
        sm[:l2] = _sort_regs(sm[:l2].reshape(-1, e)).reshape(-1)
        run = e
    while run < l2:
        sm[:l2] = np.concatenate([_merge_runs(sm, run, t0, e)
                                  for t0 in range(0, l2, e)])
        run <<= 1
    return sm[:l2]


def _edge_rows(rng, l2, dtype):
    """Random keys, many duplicates, all padding, one key repeated and
    keys at the i32 (u64) limits."""
    info = np.iinfo(dtype)
    top = info.max if dtype == np.int32 else I32_MAX
    return [rng.integers(info.min, info.max, l2, dtype=dtype,
                         endpoint=True),
            rng.choice(np.array([info.min, -1 if info.min else 1, 0, 7,
                                 top - 1, top], dtype), l2),
            np.full(l2, top, dtype), np.full(l2, 5, dtype)]


@pytest.mark.parametrize("dtype", [np.int32, np.uint64])
@pytest.mark.parametrize("l2,e", [(128, 16), (128, 4), (256, 8),
                                  (1024, 16), (2048, 32)])
def test_block_merge_sort_model_sorts(dtype, l2, e):
    """The block merge sort's index arithmetic (merge-path search,
    serial merge, odd-run reversal, register network) sorts every
    presorted form the kernels take: 0, runs shorter and longer than E,
    and the whole row."""
    rng = np.random.default_rng(l2 + e)
    for r in sorted({0, 1, 2, e // 2, e, 4 * e, 64, l2} - {l2 * 2}):
        for row in _edge_rows(rng, l2, dtype):
            src = row.copy()
            if r > 1:
                runs = np.sort(src.reshape(-1, r), axis=1)
                runs[1::2] = runs[1::2, ::-1]
                src = runs.reshape(-1)
            np.testing.assert_array_equal(_block_sort_model(src, r, e),
                                          np.sort(row), err_msg=f"r={r}")


def _wrap(x):
    return ((np.asarray(x, np.int64) + 2**31) % 2**32 - 2**31)


def _run_first(key, i, ne, mw1):
    """candidates_unpacked.cu::run_first on sorted (tgt, win) pairs."""
    t, w = key[i]
    lo = _wrap(w - mw1)
    a, b = max(0, i - ne + 1), i
    while a < b:
        m = (a + b) >> 1
        if key[m][0] == t and key[m][1] >= lo:
            b = m
        else:
            a = m + 1
    return a


def _sweep_model(tgt, win, mwir, walk, dedup, kk):
    """B5's sweep as the kernel computes it: sort, then per lane the
    binary search for the first lane f of the run it counts: hits
    1 + i - f (walk), or the difference of two run starts over the
    compacted keys (dedup), begin window win(f); then the top-k
    rounds."""
    b, l2 = tgt.shape
    res = np.zeros((b, kk, 4), np.int64)
    for r in range(b):
        key = sorted(zip(tgt[r].tolist(), win[r].tolist()))
        mw1 = int(_wrap(int(mwir[r]) - 1))
        lanes = key
        starts = list(range(l2))
        if dedup:
            starts = [i for i in range(l2) if i == 0 or key[i] != key[i - 1]]
            lanes = [key[s] for s in starts]
            lanes += [(I32_MAX, I32_MAX)] * (l2 - len(lanes))
        starts = starts + [l2]
        ne = dedup or walk
        lk = np.full(l2, -1, np.int64)
        for i, (t, _w) in enumerate(lanes):
            if t == I32_MAX:
                continue
            f = _run_first(lanes, i, ne, mw1)
            hits = starts[i + 1] - starts[f] if dedup else 1 + i - f
            lk[i] = hits * l2 + (l2 - 1 - i)
        for k in range(kk):
            best = int(lk.max())
            if best <= 0:
                res[r, k] = (-1, 0, 0, 0)
                continue
            bc = (l2 - 1) - (best & (l2 - 1))
            tb, we = lanes[bc]
            f = _run_first(lanes, bc, ne, mw1)
            res[r, k] = (tb, best >> (l2.bit_length() - 1), lanes[f][1], we)
            lk[[i for i, (t, _) in enumerate(lanes) if t == tb]] = -1
    return res.astype(np.int32)


def _sweep_rows(rng, l2):
    """Adversarial (tgt, win) rows: duplicates, target changes inside a
    walk window, windows at the i32 limits (a window I32_MAX with
    mwir 0 wraps its range to INT32_MIN), negative values, an all
    padding row and a row without padding."""
    big = np.array([0, 1, 2, I32_MAX - 2, I32_MAX - 1, I32_MAX, -2**31,
                    -2**31 + 1, -1], np.int64)
    rows = []
    t = rng.integers(0, 4, l2)
    rows.append((t, rng.integers(0, 6, l2)))                  # dense dups
    rows.append((rng.integers(0, 3, l2) * 5 + 3,
                 rng.choice(big, l2)))                        # limits
    rows.append((rng.choice(np.array([-2**31, -1, 0, I32_MAX - 1]), l2),
                 rng.choice(big, l2)))
    rows.append((np.repeat(np.arange(l2 // 4), 4),
                 np.tile([I32_MAX - 1, I32_MAX, 0, 1], l2 // 4)))
    rows.append((np.full(l2, I32_MAX), np.full(l2, I32_MAX)))  # padding
    rows.append((np.sort(rng.integers(0, 40, l2)),
                 rng.integers(I32_MAX - 40, I32_MAX, l2, endpoint=True)))
    tgt = np.stack([r[0] for r in rows])
    win = np.stack([r[1] for r in rows])
    n = rng.integers(l2 // 2, l2, len(rows))
    n[-1] = l2                                                # no padding
    pad = np.arange(l2)[None, :] >= n[:, None]
    pad[4] = True
    tgt = np.where(pad, I32_MAX, tgt)
    win = np.where(pad, I32_MAX, win)
    return tgt.astype(np.int32), win.astype(np.int32)


@pytest.mark.parametrize("walk,dedup", [(1, 0), (2, 0), (32, 0), (48, 0),
                                        (0, 1), (0, 6)])
@pytest.mark.parametrize("mwir", [0, 1, 2, 7, 2**31 - 1])
def test_unpacked_sweep_model_matches_plain(walk, dedup, mwir):
    """B5's sweep by binary search over the sorted row equals the plain
    version's walk over shifted lanes, K = 4 (and so every K below)."""
    rng = np.random.default_rng(walk * 7 + dedup * 3 + mwir % 97)
    tgt, win = _sweep_rows(rng, 128)
    mw = np.full(len(tgt), mwir, np.int32)
    mw[::2] = rng.choice(np.array([0, 1, 2, 7]), len(mw[::2]))
    want = C.candidates_unpacked_plain(
        torch.from_numpy(tgt), torch.from_numpy(win), torch.from_numpy(mw),
        walk, dedup, 4).numpy()
    np.testing.assert_array_equal(_sweep_model(tgt, win, mw, walk, dedup, 4),
                                  want)


def _lift(val, i, lim, lo, top):
    """candidates.cu::sweep's binary lifting: the first lane f >= lim of
    the run of lanes j < i with val(j) >= lo that ends at i - 1 (i when
    there is none), by steps top, top / 2, .., 1."""
    f, step = i, top
    while step:
        j = f - step
        if j >= lim and val(j) >= lo:
            f = j
        step >>= 1
    return f


def _packed_sweep_model(pk, mwir, wbits, walk, dedup, kk):
    """B4 as the kernel computes it on each sorted row: binary lifting
    for the first lane f that lane i counts (walk: hits 1 + i - f; dedup:
    over the compacted run starts S, hits S[i + 1] - S[f]); per lane its
    key and target; K rounds whose winner's begin slot comes from its
    own f, recovered from its key (walk: lane bc + 1 - hits; dedup: lane
    S[bc + 1] - hits), masking the lanes of the winner's target."""
    b, l2 = pk.shape
    wmask = (1 << wbits) - 1
    ne = dedup or walk
    top = 1 << ((ne - 1).bit_length() - 1) if ne > 1 else 0
    res = np.zeros((b, kk, 4), np.int64)
    for r in range(b):
        a = np.sort(pk[r]).astype(np.int64)
        mw1 = int(_wrap(int(mwir[r]) - 1))
        if dedup:
            starts = [i for i in range(l2) if i == 0 or a[i] != a[i - 1]]
            n = len(starts)
            starts.append(l2)
            val = lambda c: int(a[starts[c]])                 # noqa: E731
            hits = lambda i, f: starts[i + 1] - starts[f]     # noqa: E731
            begin = lambda c, h: int(a[starts[c + 1] - h])    # noqa: E731
        else:
            n = l2
            val = lambda i: int(a[i])                         # noqa: E731
            hits = lambda i, f: 1 + i - f                     # noqa: E731
            begin = lambda c, h: int(a[c + 1 - h])            # noqa: E731
        lk = np.full(l2, -1, np.int64)
        lt = np.full(l2, (I32_MAX >> wbits), np.int64)
        for i in range(n):
            p = val(i)
            lt[i] = (p & 0xFFFFFFFF) >> wbits
            if p != I32_MAX:
                f = _lift(val, i, max(0, i - ne + 1), int(_wrap(p - mw1)),
                          top)
                lk[i] = hits(i, f) * l2 + (l2 - 1 - i)
        for k in range(kk):
            best = int(lk.max())
            if best <= 0:
                res[r, k] = (-1, 0, 0, 0)
                continue
            bc = (l2 - 1) - (best & (l2 - 1))
            h = best >> (l2.bit_length() - 1)
            tb = (val(bc) & 0xFFFFFFFF) >> wbits
            res[r, k] = (tb, h, begin(bc, h) & wmask, val(bc) & wmask)
            lk[lt == tb] = -1
    return res.astype(np.int32)


def _packed_sweep_rows(rng, l2, wbits):
    """Adversarial packed rows: runs of equal slots; targets whose
    windows end at 2^wbits - 1 beside the next target's window 0 (a carry
    into the target bits inside a walk); slots near I32_MAX and negative
    slots; an all-padding row and a row without padding."""
    top = 1 << wbits
    tmax = (1 << (31 - wbits)) - 1
    rows = [rng.integers(0, 4, l2) << wbits | rng.integers(0, 6, l2),
            rng.integers(0, 5, l2) << wbits |
            rng.choice(np.array([0, 1, 2, top - 3, top - 2, top - 1]), l2),
            np.repeat(rng.integers(0, 50, l2 // 8), 8) << wbits |
            np.repeat(rng.integers(0, top, l2 // 8), 8),
            (tmax - rng.integers(0, 3, l2)) << wbits |
            rng.integers(top - 8, top, l2),
            rng.choice(np.array([-2**31, -2**31 + 1, -1, 0, 1,
                                 I32_MAX - 1]), l2),
            np.full(l2, I32_MAX),
            rng.integers(0, 40, l2) << wbits | rng.integers(0, top, l2)]
    pk = np.stack(rows)
    n = rng.integers(l2 // 2, l2, len(rows))
    n[-1] = l2                                                # no padding
    pad = np.arange(l2)[None, :] >= n[:, None]
    pad[5] = True
    return np.where(pad, I32_MAX, pk).astype(np.int32)


@pytest.mark.parametrize("l2", [128, 1024])
@pytest.mark.parametrize("walk,dedup", [(1, 0), (2, 0), (32, 0), (48, 0),
                                        (0, 1), (0, 6)])
@pytest.mark.parametrize("mwir", [0, 1, 2, 7, "half", 2**31 - 1])
def test_packed_sweep_model_matches_plain(l2, walk, dedup, mwir):
    """B4's sweep by binary lifting, its top-k keys and targets held per
    lane and the winner's begin slot from its own key equal the plain
    version's walk over shifted lanes, K = 4 (and so every K below), for
    mwir 0 (mwir - 1 wraps every padding lane's bound to INT32_MIN), 1,
    2, 7, 2^(wbits - 1) and 2^31 - 1."""
    wbits = 10
    mwir = 1 << (wbits - 1) if mwir == "half" else mwir
    rng = np.random.default_rng(l2 + walk * 7 + dedup * 3 + mwir % 97)
    pk = _packed_sweep_rows(rng, l2, wbits)
    mw = np.full(len(pk), mwir, np.int32)
    mw[::2] = rng.choice(np.array([0, 1, 2, 7]), len(mw[::2]))
    srt = torch.sort(torch.from_numpy(pk), dim=1).values
    want = C.candidates_sorted_plain(srt, torch.from_numpy(mw), wbits,
                                     walk, dedup, 4).numpy()
    np.testing.assert_array_equal(
        _packed_sweep_model(pk, mw, wbits, walk, dedup, 4), want)


# ------------------------------------------------ the wide form
@pytest.mark.parametrize("mode", ["walk", "dedup"])
@pytest.mark.parametrize("pairs", [False, True])
def test_wide_rows_match_pallas(mode, pairs):
    """Rows wider than one block holds (65,536 packed slots, 32,768
    pairs; on the card they take the wide form) through the plain
    versions, which the wide form is held against on the card, equal
    JAX's Pallas kernels, which take rows of any width."""
    rng = np.random.default_rng(11 + 2 * pairs + (mode == "dedup"))
    kw = dict(walk_elems=10) if mode == "walk" else dict(dedup_walk=6)
    b, r = 2, 256
    l = C.MAX_UNPACKED_L2 * 2 if pairs else C.MAX_CAND_L2 * 2
    mwir = np.full(b, 3 if mode == "walk" else 6, np.int32)
    if pairs:
        tgt = rng.integers(0, 3000, (b, l)).astype(np.int32)
        win = rng.integers(0, 900, (b, l)).astype(np.int32)
        tgt[:, l // 2:] = win[:, l // 2:] = I32_MAX
        order = np.lexsort((win.reshape(-1, r), tgt.reshape(-1, r)))
        tgt = np.take_along_axis(tgt.reshape(-1, r), order, 1)
        win = np.take_along_axis(win.reshape(-1, r), order, 1)
        tgt[1::2], win[1::2] = tgt[1::2, ::-1], win[1::2, ::-1]
        tgt, win = (np.ascontiguousarray(x.reshape(b, l)) for x in (tgt, win))
        want = _jax_pairs(tgt, win, mwir, max_candidates=4, presorted=r,
                          **kw)
        got = _port_pairs(tgt, win, mwir, max_candidates=4, presorted=r,
                          **kw)
    else:
        pk = _alternating(_slots(rng, b, l, 3000, 900, 11, dup=True), r)
        want = _jax(pk, mwir, 11, max_candidates=4, presorted=r, **kw)
        got = _port(pk, mwir, 11, max_candidates=4, presorted=r, **kw)
    _assert_same(want, got)
    assert (got[0] >= 0).all()


class _PackedSlots:
    """The wide form's view of packed slots (csrc/candidates_wide.cu
    Packed): signed order, padding I32_MAX."""

    def __init__(self, wbits):
        self.wbits = wbits

    def match(self, p):
        return p != I32_MAX

    def tgt(self, p):
        return (p & 0xFFFFFFFF) >> self.wbits

    def win(self, p):
        return p & ((1 << self.wbits) - 1)

    def in_range(self, q, p, mw1):
        return q >= int(_wrap(p - mw1))


class _PairSlots:
    """(tgt, win) pairs as one int64 key tgt * 2^32 + (win + 2^31), in
    the signed (tgt, win) order of the kernel's u64 keys."""

    def match(self, p):
        return self.tgt(p) != I32_MAX

    def tgt(self, p):
        return p >> 32

    def win(self, p):
        return (p & 0xFFFFFFFF) - 2**31

    def in_range(self, q, p, mw1):
        return (self.tgt(q) == self.tgt(p) and
                self.win(q) >= int(_wrap(self.win(p) - mw1)))


def _merge_pass(src, run, e=8):
    """candidates_wide.cu::merge_pass_kernel over the flat key array:
    runs of ``run`` keys merged pairwise, ``e`` outputs a thread."""
    out = np.empty_like(src)
    for t0 in range(0, len(src), e):
        a0 = t0 & ~(2 * run - 1)
        b0 = a0 + run
        diag = t0 - a0
        lo, hi = max(0, diag - run), min(diag, run)
        while lo < hi:
            m = (lo + hi) >> 1
            if src[b0 + diag - 1 - m] < src[a0 + m]:
                hi = m
            else:
                lo = m + 1
        ia, ib = a0 + lo, b0 + diag - lo
        for k in range(e):
            tb = ib < b0 + run and (ia >= b0 or src[ib] < src[ia])
            out[t0 + k] = src[ib] if tb else src[ia]
            ib, ia = ib + tb, ia + (not tb)
    return out


def _wide_model(keys, mwir, pol, walk, dedup, kk, sort_tile, tile):
    """The wide form's six steps on (B, L2) int64 keys: tiles of
    ``sort_tile`` sorted, merge passes to whole rows, the run starts
    compacted (dedup), per sweep tile of ``tile`` lanes the binary
    search for each lane's first counted lane and the tile's K records,
    then the row's K picks from the records."""
    b, l2 = keys.shape
    flat = np.concatenate([np.sort(keys.reshape(-1)[i:i + sort_tile])
                           for i in range(0, b * l2, sort_tile)])
    run = sort_tile
    while run < l2:
        flat = _merge_pass(flat, run)
        run <<= 1
    rows = flat.reshape(b, l2)
    np.testing.assert_array_equal(rows, np.sort(keys, axis=1))
    ne, lshift = dedup or walk, l2.bit_length() - 1
    res = np.zeros((b, kk, 4), np.int64)
    for r in range(b):
        row = [int(x) for x in rows[r]]
        mw1 = int(_wrap(int(mwir[r]) - 1))
        S = list(range(l2 + 1))
        if dedup:
            S = [i for i in range(l2) if i == 0 or row[i] != row[i - 1]]
        n = len(S) if dedup else l2
        S = S + [l2] if dedup else S

        def val(c):
            return row[S[c]]
        recs = []
        for base in range(0, l2, tile):
            lk, lt = {}, {}
            for i in range(base, min(base + tile, n)):
                p = val(i)
                if not pol.match(p):
                    continue
                a, z = max(0, i - ne + 1), i
                while a < z:
                    m = (a + z) >> 1
                    if pol.in_range(val(m), p, mw1):
                        z = m
                    else:
                        a = m + 1
                lk[i] = (S[i + 1] - S[a]) * l2 + (l2 - 1 - i)
                lt[i] = pol.tgt(p)
            for _ in range(kk):
                best = max(lk.values(), default=-1)
                if best <= 0:
                    recs.append((-1, -1, 0, 0))
                    continue
                bc = (l2 - 1) - (best & (l2 - 1))
                h, tb = best >> lshift, pol.tgt(val(bc))
                recs.append((best, tb, pol.win(row[S[bc + 1] - h]),
                             pol.win(val(bc))))
                lk = {i: v for i, v in lk.items() if lt[i] != tb}
        for k in range(kk):
            best = max(rc[0] for rc in recs)
            if best <= 0:
                res[r, k] = (-1, 0, 0, 0)
                continue
            _key, tb, beg, end = next(rc for rc in recs if rc[0] == best)
            res[r, k] = (tb, best >> lshift, beg, end)
            recs = [(-1, *rc[1:]) if rc[1] == tb else rc for rc in recs]
    return res.astype(np.int32)


@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("walk,dedup", [(1, 0), (32, 0), (0, 1), (0, 6)])
@pytest.mark.parametrize("mwir", [0, 2, 7])
def test_wide_form_model_matches_plain(pairs, walk, dedup, mwir):
    """The wide form's steps (tile sort, merge passes, compaction, the
    sweep split over tiles with K records a tile, the row's picks from
    them) equal the plain version, K = 4, at tiles far smaller than the
    kernel's (sort tiles of 64 lanes, sweep tiles of 32, rows of 256) so
    that runs, walks and targets cross tile borders."""
    rng = np.random.default_rng(walk * 7 + dedup * 3 + mwir + 50 * pairs)
    l2 = 256
    if pairs:
        tgt, win = _sweep_rows(rng, l2)
        keys = tgt.astype(np.int64) * 2**32 + (win.astype(np.int64) + 2**31)
        pol = _PairSlots()
    else:
        pk = _packed_sweep_rows(rng, l2, 10)
        keys, pol = pk.astype(np.int64), _PackedSlots(10)
    mw = np.full(len(keys), mwir, np.int32)
    mw[::2] = rng.choice(np.array([0, 1, 2, 7]), len(mw[::2]))
    if pairs:
        want = C.candidates_unpacked_plain(
            torch.from_numpy(tgt), torch.from_numpy(win),
            torch.from_numpy(mw), walk, dedup, 4).numpy()
    else:
        want = C.candidates_sorted_plain(
            torch.sort(torch.from_numpy(pk), dim=1).values,
            torch.from_numpy(mw), 10, walk, dedup, 4).numpy()
    np.testing.assert_array_equal(
        _wide_model(keys, mw, pol, walk, dedup, 4, 64, 32), want)


def _path_split(at, a0, run, diag):
    """candidates_wide.cu::path_split: the keys of run a among the first
    diag outputs of the merge of runs a (from lane a0) and b, by the
    kernel's rounds: 32 lanes test the points lo + span * lane / 32 and
    the first lane that finds the b key below the a key (f, 32 if none)
    leaves the interval between the points of lanes f - 1 and f."""
    b0 = a0 + run
    lo, hi = max(0, diag - run), min(diag, run)
    while lo < hi:
        span = hi - lo
        ms = [lo + ((span * lane) >> 5) for lane in range(32)]
        f = next((lane for lane, m in enumerate(ms)
                  if at(b0 + diag - 1 - m) < at(a0 + m)), 32)
        nlo = lo + ((span * (f - 1)) >> 5) + 1 if f else lo
        hi = hi if f == 32 else lo + ((span * f) >> 5)
        lo = nlo
    return lo


@pytest.mark.parametrize("run", [1, 2, 3, 5, 31, 32, 33, 64, 100])
def test_path_split_rounds_match_bisection(run):
    """The kernel's 32-way rounds find the same merge-path split as a
    bisection, at every diagonal of two sorted runs of ``run`` keys with
    ties inside and across them, spans below, at and above 32."""
    rng = np.random.default_rng(run)
    for trial in range(4):
        keys = np.concatenate([np.sort(rng.integers(0, 1 + run // 2 + trial,
                                                    run))
                               for _ in range(2)])
        for diag in range(2 * run + 1):
            lo, hi = max(0, diag - run), min(diag, run)
            while lo < hi:
                m = (lo + hi) >> 1
                if keys[run + diag - 1 - m] < keys[m]:
                    hi = m
                else:
                    lo = m + 1
            assert _path_split(keys.__getitem__, 0, run, diag) == lo, \
                (trial, diag)


def _merge_staged(st, la, lb, d, e):
    """candidates_wide.cu::merge_staged: outputs d .. d + e - 1 of the
    merge of st[:la] and st[la:la + lb] (one spare key past them)."""
    lo, hi = max(0, d - lb), min(d, la)
    while lo < hi:
        m = (lo + hi) >> 1
        if st[la + d - 1 - m] < st[m]:
            hi = m
        else:
            lo = m + 1
    ia, ib = lo, d - lo
    ka, kb = st[ia], st[la + ib]
    out = []
    for _ in range(e):
        tb = ib < lb and (ia >= la or kb < ka)
        out.append(kb if tb else ka)
        ib, ia = ib + tb, ia + (not tb)
        x = st[la + ib if tb else ia]
        ka, kb = (ka, x) if tb else (x, kb)
    return out


def _cluster_merge(tiles, run, threads, step):
    """One merge level of csrc/candidates_wide.cu's cluster route: block
    q's tile of outputs, from lane q * step on, of the merge of the two
    runs of ``run`` lanes that hold it, in two halves: each half's inputs
    (a stretch of each run, split by the merge-path search over the
    blocks' tiles) staged, then merged from there by each of the block's
    ``threads``."""
    tile = len(tiles[0])
    half = tile // 2
    e = half // threads

    def at(j):
        return tiles[j // tile][j % tile]
    new = []
    for q in range(len(tiles)):
        t0 = q * step
        a0 = t0 & ~(2 * run - 1)
        b0 = a0 + run
        split = [_path_split(at, a0, run, t0 - a0 + h * half)
                 for h in range(3)]
        out = []
        for h in range(2):
            sa, la = split[h], split[h + 1] - split[h]
            ib0 = b0 + (t0 - a0 + h * half) - sa - la
            st = [at(a0 + sa + j) if j < la else at(ib0 + j)
                  for j in range(half)] + [None]
            for d in range(0, half, e):
                out += _merge_staged(st, la, half - la, d, e)
        new.append(out)
    return new


def _top_add(top, key, tgt, f, end, kk):
    """candidates_wide.cu::TopK::add: a thread's best key of each of its
    top kk targets, {tgt: (key, first lane, end window)}."""
    if tgt in top:
        if key <= top[tgt][0]:
            return
    elif len(top) == kk:
        lo = min(top, key=lambda t: top[t][0])
        if key <= top[lo][0]:
            return
        del top[lo]
    top[tgt] = (key, f, end)


def _cluster_model(keys, mwir, pol, walk, dedup, kk, tile, threads=4):
    """The wide form's cluster route on (B, L2) int64 keys, one cluster
    of C = L2 / tile blocks a row, ``threads`` threads a block: each
    block sorts its tile and counts its matching slots; log2(C) merge
    levels across the tiles, the last dealing the nm matching lanes out
    w = ceil(nm / C) a block; in dedup mode each block's run starts as
    local lanes (its first lane against the previous block's last),
    each tile rewritten as the keys of its run starts, and the blocks'
    offsets in the compacted row; each block's sweep of its compacted
    lanes, reading keys and run starts of earlier blocks, each thread's
    top K targets and the block's K rounds over them; block 0's K picks
    from the C x K records."""
    b, l2 = keys.shape
    nc = l2 // tile
    ne, lshift = dedup or walk, l2.bit_length() - 1
    res = np.zeros((b, kk, 4), np.int64)
    for r in range(b):
        tiles = [sorted(int(x) for x in keys[r, q * tile:(q + 1) * tile])
                 for q in range(nc)]
        # the matching lanes [0, nm) dealt out w a block at the last level
        nm = sum(pol.match(x) for t in tiles for x in t)
        w = max(1, -(-nm // nc))
        run = tile
        while run < l2:
            tiles = _cluster_merge(tiles, run, threads,
                                   w if 2 * run == l2 else tile)
            run <<= 1
        own = [max(0, min(w, nm - q * w)) for q in range(nc)]
        assert sum((t[:o] for t, o in zip(tiles, own)), []) == \
            sorted(int(x) for x in keys[r])[:nm]
        if dedup:
            starts = [[i for i in range(own[q])
                       if (q == 0 and i == 0) or
                       tiles[q][i] != (tiles[q][i - 1] if i
                                       else tiles[q - 1][w - 1])]
                      for q in range(nc)]
            offs = [0]
            for st in starts:
                offs.append(offs[-1] + len(st))
            # each tile rewritten as the keys of its run starts
            tiles = [[tiles[q][i] for i in starts[q]] for q in range(nc)]
        else:
            offs = [q * w for q in range(nc)] + [nm]
            offs = [min(o, nm) for o in offs]
        n = offs[nc]

        def owner(m):
            return next(q for q in range(nc) if offs[q] <= m < offs[q + 1])

        def key_at(m):
            q = owner(m)
            return tiles[q][m - offs[q]]

        def s_at(m):
            if not dedup:
                return m
            if m >= n:
                return nm
            q = owner(m)
            return q * w + starts[q][m - offs[q]]
        mw1 = int(_wrap(int(mwir[r]) - 1))
        recs = []
        for q in range(nc):
            ents = []
            for t in range(threads):
                top = {}
                for c in range(offs[q] + t, offs[q + 1], threads):
                    p = key_at(c)
                    if not pol.match(p):
                        continue
                    a, z = max(0, c - ne + 1), c
                    while a < z:
                        m = (a + z) >> 1
                        if pol.in_range(key_at(m), p, mw1):
                            z = m
                        else:
                            a = m + 1
                    hits = s_at(c + 1) - s_at(a) if dedup else 1 + c - a
                    _top_add(top, hits * l2 + (l2 - 1 - c), pol.tgt(p), a,
                             pol.win(p), kk)
                ents += [(k, tg, f, en) for tg, (k, f, en) in top.items()]
            for _ in range(kk):
                best = max((x[0] for x in ents), default=-1)
                if best <= 0:
                    recs.append((-1, -1, 0, 0))
                    continue
                _k, tb, f, en = next(x for x in ents if x[0] == best)
                recs.append((best, tb, pol.win(key_at(f)), en))
                ents = [x for x in ents if x[1] != tb]
        for k in range(kk):
            best = max(rc[0] for rc in recs)
            if best <= 0:
                res[r, k] = (-1, 0, 0, 0)
                continue
            _key, tb, beg, end = next(rc for rc in recs if rc[0] == best)
            res[r, k] = (tb, best >> lshift, beg, end)
            recs = [(-1, *rc[1:]) if rc[1] == tb else rc for rc in recs]
    return res.astype(np.int32)


def _plain_of(pairs, rows, mw, walk, dedup, kk, wbits=10):
    """The plain version of B5 (pairs: (tgt, win)) or of B4 on the sorted
    packed rows."""
    if pairs:
        tgt, win = rows
        return C.candidates_unpacked_plain(
            torch.from_numpy(tgt), torch.from_numpy(win),
            torch.from_numpy(mw), walk, dedup, kk).numpy()
    return C.candidates_sorted_plain(
        torch.sort(torch.from_numpy(rows), dim=1).values,
        torch.from_numpy(mw), wbits, walk, dedup, kk).numpy()


def _model_keys(pairs, rows, wbits=10):
    if pairs:
        tgt, win = rows
        keys = tgt.astype(np.int64) * 2**32 + (win.astype(np.int64) + 2**31)
        return keys, _PairSlots()
    return rows.astype(np.int64), _PackedSlots(wbits)


@pytest.mark.parametrize("nc", [2, 4, 8])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("walk,dedup", [(1, 0), (32, 0), (0, 1), (0, 6)])
@pytest.mark.parametrize("mwir", [0, 2, 7])
def test_cluster_route_model_matches_plain(nc, pairs, walk, dedup, mwir):
    """The wide form's cluster route (tile sorts, merge-path levels across
    the tiles, run starts per tile with cross-tile first lanes, the sweep
    reaching into earlier tiles, per-thread and per-tile top K, block 0's
    picks) equals the plain version, K = 4, at tiles of 32 lanes, C = 2,
    4 and 8 tiles a row, so that runs, walks and targets cross tile
    borders."""
    rng = np.random.default_rng(walk * 7 + dedup * 3 + mwir + 50 * pairs +
                                100 * nc)
    l2 = 32 * nc
    rows = _sweep_rows(rng, l2) if pairs else _packed_sweep_rows(rng, l2, 10)
    keys, pol = _model_keys(pairs, rows)
    mw = np.full(len(keys), mwir, np.int32)
    mw[::2] = rng.choice(np.array([0, 1, 2, 7]), len(mw[::2]))
    np.testing.assert_array_equal(
        _cluster_model(keys, mw, pol, walk, dedup, 4, 32),
        _plain_of(pairs, rows, mw, walk, dedup, 4))


def _border_rows(rng, l2, pairs):
    """Rows (tgt, win) whose runs cross tile borders of 32 lanes: one
    slot repeated over half the row and 4 lanes (2 to 4 tiles) beside 20
    lanes of its target's neighbouring windows; one target at 6 windows
    of l2 / 12 lanes each (dedup 6 reaches 2 to 4 tiles back); one target
    in every lane at windows 0-3 and then 1,000; and a row of 3 targets
    each filling about a third of the row."""
    rows = []
    run, per = l2 // 2 + 4, l2 // 12
    t = np.full(l2, 9)
    w = rng.integers(0, 30, l2)
    t[:run], w[:run] = 5, 10
    t[run:run + 20], w[run:run + 20] = 5, rng.integers(8, 13, 20)
    rows.append((t, w))
    t = rng.integers(0, 20, l2)
    w = rng.integers(0, 50, l2)
    t[:6 * per], w[:6 * per] = 3, np.repeat(np.arange(6), per)
    rows.append((t, w))
    rows.append((np.full(l2, 1), np.where(np.arange(l2) < l2 - 4,
                                          rng.integers(0, 4, l2), 1000)))
    rows.append((np.repeat(np.arange(3), -(-l2 // 3))[:l2],
                 rng.integers(0, 9, l2)))
    tgt = np.stack([x[0] for x in rows])
    win = np.stack([x[1] for x in rows])
    perm = rng.permuted(np.tile(np.arange(l2), (len(rows), 1)), axis=1)
    tgt = np.take_along_axis(tgt, perm, 1).astype(np.int32)
    win = np.take_along_axis(win, perm, 1).astype(np.int32)
    return (tgt, win) if pairs else _pk(tgt, win, 10)


@pytest.mark.parametrize("nc", [4, 8])
@pytest.mark.parametrize("pairs", [False, True])
@pytest.mark.parametrize("walk,dedup", [(32, 0), (0, 6), (0, 48)])
def test_cluster_route_model_runs_across_tiles(nc, pairs, walk, dedup):
    """The cluster route's model where a run of equal slots spans three
    tiles and more, dedup 6 and 48 count runs one to several tiles back,
    and targets cross tile borders, K = 2 and 4."""
    rng = np.random.default_rng(nc + 10 * pairs + walk + dedup)
    l2 = 32 * nc
    rows = _border_rows(rng, l2, pairs)
    keys, pol = _model_keys(pairs, rows)
    mw = np.array([3, 6, 2, 7], np.int32)
    for kk in (2, 4):
        np.testing.assert_array_equal(
            _cluster_model(keys, mw, pol, walk, dedup, kk, 32),
            _plain_of(pairs, rows, mw, walk, dedup, kk))


@pytest.mark.parametrize("l2,pairs,route", [
    (1 << 16, False, "cluster"), (1 << 17, False, "cluster"),
    (1 << 18, False, "cluster"), (1 << 19, False, "passes"),
    (1 << 24, False, "passes"), (1 << 15, True, "cluster"),
    (1 << 16, True, "cluster"), (1 << 17, True, "cluster"),
    (1 << 18, True, "passes"), (1 << 20, True, "passes")])
def test_wide_route_by_shape(l2, pairs, route):
    """B4's and B5's wide form pick their route by the row's width alone:
    up to 8 sort tiles (32,768 packed slots, 16,384 pairs) one cluster
    launch, wider rows the merge passes; narrower rows are not wide."""
    assert C.wide_route(l2, pairs) == route
    with pytest.raises(ValueError):
        C.wide_route(C.MAX_UNPACKED_L2 if pairs else C.MAX_CAND_L2, pairs)
    with pytest.raises(ValueError):
        C.wide_route(2 * C.MAX_WIDE_L2, pairs)


@pytest.mark.parametrize("value,split", [(None, False), ("0", False),
                                         ("1", True), ("yes", True)])
def test_split_route_reads_mc_split_cand(monkeypatch, value, split):
    """MC_SPLIT_CAND as JAX's rows.py reads it ("0" fuses the sort into
    B4, any other value splits it out), the fused form when unset; on
    CPU tensors both routes give the plain sort and sweep's result."""
    from metacache_tpu_torch.ops.rows import split_candidates
    if value is None:
        monkeypatch.delenv("MC_SPLIT_CAND", raising=False)
    else:
        monkeypatch.setenv("MC_SPLIT_CAND", value)
    assert split_candidates() is split
    rng = np.random.default_rng(8)
    pk = _alternating(_slots(rng, 8, 512, 24, 60, 7), 64)
    mwir = np.full(8, 3, np.int32)
    got = _port(pk, mwir, 7, walk_elems=10, presorted=64,
                split=split_candidates())
    want = _jax(pk, mwir, 7, walk_elems=10, presorted=64, split=split)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g, w)
