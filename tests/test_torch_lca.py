"""metacache_tpu_torch's step tail on the CPU against metacache_tpu's:
the ranked LCA (classify_candidates, the plain version of the
classify_lca kernel), its lookup form (classify_with_taxa, JAX's
candidate-taxon lookup of rows.py:171-173 then classify_candidates) and
the summary's rank histogram (rank_histogram, the plain version of the
rank_hist kernel) against JAX's _rank_hist_jit and
_rank_hist_masked_jit; a numpy model of each kernel's algorithm (the
warp's walk over the candidates, stopped at the first left out, and
the two first-set-rank picks; the lower-bound search and the bins)
against the plain versions; and the whole scan step, fused and
non-fused, against JAX's. Inputs come from numpy with a seed
(test_torch_cuda.lca_case and hist_case); tolerance 0 (integer outputs;
the threshold is float32 on every side)."""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.classify.runner import (_rank_hist_jit,
                                           _rank_hist_masked_jit)
from metacache_tpu.ops import pipeline as jpipe
from metacache_tpu.ops import rows as jrows
from metacache_tpu_torch.classify import runner as trunner
from metacache_tpu_torch.db.state import tables_from_numpy
from metacache_tpu_torch.ops import pipeline as P
from metacache_tpu_torch.ops import rows as trows
from test_torch_cuda import (LCA_PARAMS, hist_case, lca_case,
                             lca_lineages, pack_2bit)
from test_torch_rows import _layout, _reads, strain_db  # noqa: F401

torch.set_num_threads(2)
CLASSIFY_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "metacache_tpu_torch", "csrc",
    "classify.cu")
RANK_PAIRS = ((0, 20), (0, 0), (4, 4), (4, 19), (6, 20), (19, 20))


def _t(d):
    return {n: torch.from_numpy(a) for n, a in d.items()}


def _jax_lookup(tgt, merge_tax):
    """JAX's candidate-taxon lookup (metacache_tpu/ops/rows.py:171-173)."""
    ntax = merge_tax.shape[0]
    return jnp.where(tgt >= 0, merge_tax[jnp.clip(tgt, 0, ntax - 1)], 0)


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("merge_rank,highest", RANK_PAIRS)
def test_classify_candidates_matches_jax(k, merge_rank, highest):
    """classify_candidates_plain, and the wrapper on CPU tensors, equal
    JAX's classify_candidates at each hits_min and fraction."""
    d = lca_case(40 + k, 512, k)
    t = _t(d)
    for hits_min, frac in LCA_PARAMS:
        args = (hits_min, frac, highest, merge_rank)
        want = np.asarray(jpipe.classify_candidates(
            jnp.asarray(d["tgt"]), jnp.asarray(d["tax"]),
            jnp.asarray(d["hits"]), jnp.asarray(d["lin"]), *args))
        got = P.classify_candidates_plain(t["tgt"], t["tax"], t["hits"],
                                          t["lin"], *args)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(P.classify_candidates(
            t["tgt"], t["tax"], t["hits"], t["lin"], *args).numpy(), want)
        assert (want != 0).sum() > 50


@pytest.mark.parametrize("k", [1, 2, 4, 8])
@pytest.mark.parametrize("merge_rank,highest", [(0, 20), (4, 19)])
def test_classify_with_taxa_matches_jax(k, merge_rank, highest):
    """The lookup form, plain and through the wrapper on CPU tensors,
    equals JAX's lookup then classify_candidates: the taxa and the
    classes."""
    d = lca_case(80 + k, 512, k)
    t = _t(d)
    jt = jnp.asarray(d["tgt"])
    jtax = _jax_lookup(jt, jnp.asarray(d["merge_tax"]))
    np.testing.assert_array_equal(np.asarray(jtax), d["tax"])
    for hits_min, frac in LCA_PARAMS:
        args = (hits_min, frac, highest, merge_rank)
        want = np.asarray(jpipe.classify_candidates(
            jt, jtax, jnp.asarray(d["hits"]), jnp.asarray(d["lin"]), *args))
        for fn in (P.classify_with_taxa_plain, P.classify_with_taxa):
            tax, cls = fn(t["tgt"], t["hits"], t["merge_tax"], t["lin"],
                          *args)
            np.testing.assert_array_equal(tax.numpy(), np.asarray(jtax))
            np.testing.assert_array_equal(cls.numpy(), want)


def test_lca_case_covers_its_edges():
    """The generated candidates hold what the tests above claim: absent
    candidates at every position, target T - 1, taxon 0 of a present
    target, ties at the threshold (frac 0.5), and includes that the
    float32 rounding decides (frac 1.0: hits - 5 > 2^24 + 3 in integers,
    not in float32)."""
    k = 8
    d = lca_case(88, 512, k)
    absent = d["tgt"] < 0
    assert absent.any(axis=0).all() and absent[:, 0].sum() > 20
    assert (d["tgt"] == 1023).any()
    assert ((d["tgt"] >= 0) & (d["tax"] == 0)).any()
    h0 = d["hits"][:, :1].astype(np.int64)
    assert ((d["hits"][:, 1:] == (h0 - 5) // 2) & (h0 - 5 < 40)).any()
    over = d["hits"][:, 1:].astype(np.int64) > h0 - 5
    rounds = np.float32(d["hits"][:, 1:]) > np.float32(h0 - 5)
    assert (over & ~rounds).any() and (h0 - 5 > 2**24).any()


def _source_int(name):
    """An integer constant of csrc/classify.cu (``2 * kX`` read too)."""
    src = open(CLASSIFY_CU).read()
    m = re.search(rf"constexpr int {name} = (?:(\d+) \* )?(\w+);", src)
    mult, val = m.group(1), m.group(2)
    val = int(val) if val.isdigit() else _source_int(val)
    return val * (int(mult) if mult else 1)


def _store(lin, padded, rng):
    """-> (flat storage, row stride) of a (T, R) table: contiguous, or
    with its rows padded to a multiple of 4 ints whose padding holds
    garbage (the kernel reads the rows in place at their stride and
    must read none of it)."""
    t, r = lin.shape
    if not padded:
        return lin.ravel(), r
    rp = -(-r // 4) * 4
    full = rng.integers(-9, 10, (t, rp)).astype(np.int32)
    full[:, :r] = lin
    return full.ravel(), rp


def _lca_model(tgt, hits, tax, store, stride, nlin, r, hits_min, frac,
               highest, merge_rank):
    """classify_lca's algorithm (csrc/classify.cu::lca_kernel), read by
    read: a group of kGroup lanes, lane g holding ranks 4g .. 4g + 3; the
    candidates in turns of kTurn, each turn's loads all made before its
    walk (targets, hits and taxa, then every candidate's lineage chunk,
    the lane's own ints of the clamped row of ``store`` at ``stride``
    ints a row); the walk in
    order, stopped at the first candidate left out; agreement a bit a
    rank; r0 and the LCA rank the first set bits of the group's 32-bit
    masks, each lane's nibble shifted to 4g."""
    G, T = _source_int("kGroup"), _source_int("kTurn")
    b, k = tgt.shape
    lanes = np.arange(G)
    left = r - 4 * lanes
    ok = np.where(left >= 4, 15, np.where(left > 0, (1 << np.maximum(
        left, 0)) - 1, 0))
    q = np.arange(4)
    out = np.zeros(b, np.int32)
    for i in range(b):
        inc, valid0, thr = True, False, np.float32(0)
        lin0 = np.zeros((G, 4), np.int64)
        agree = np.zeros(G, np.int64)
        for base in range(0, k, T):
            m = min(k - base, T)
            t, h, x = (a[i, base:base + m] for a in (tgt, hits, tax))
            chunks = np.zeros((m, G, 4), np.int64)
            if inc:            # round two, before any decision
                rows = np.clip(np.maximum(t, 0), 0, nlin - 1)
                off = rows[:, None, None] * stride + 4 * lanes[None, :, None] \
                    + q[None, None, :]
                inside = q[None, :] < left[:, None]
                chunks = np.where(inside[None], store[np.where(
                    inside[None], off, 0)], 0)
            for j in range(m):
                if not inc:
                    break
                e, hj = x[j] != 0, int(h[j])
                if base + j == 0:
                    valid0 = e and hj >= hits_min
                    thr = np.float32(np.float32(hj - hits_min) * np.float32(
                        frac)) if hj > hits_min else np.float32(0)
                    inc = e
                    if inc:
                        lin0 = chunks[j]
                        agree = ((lin0 != 0) << q).sum(axis=1) & ok
                else:
                    inc = e and np.float32(hj) > thr
                    if inc:
                        agree &= ((chunks[j] == lin0) << q).sum(axis=1)
        rank = 4 * lanes[:, None] + q[None, :]
        nib0 = ((lin0 != 0) & (rank >= merge_rank)) << q
        e0 = int(((nib0.sum(axis=1) & ok) << (4 * lanes)).sum())
        ea = int((agree << (4 * lanes)).sum())
        r0 = (e0 & -e0).bit_length() - 1 if e0 else r
        el = ea & (0xFFFFFFFF << r0) & 0xFFFFFFFF if r0 < 32 else 0
        lca = (el & -el).bit_length() - 1 if el else r
        at = min(lca, r - 1)
        if valid0 and el and lca <= highest:
            out[i] = lin0[at >> 2, at & 3]
    return out


@pytest.mark.parametrize("k", [1, 2, 8, 40])
@pytest.mark.parametrize("r,padded", [(21, True), (21, False), (1, True),
                                      (32, False)])
def test_lca_model_matches_plain(k, r, padded):
    """The kernel's algorithm, modelled in numpy, equals the plain
    version: K = 40 in five turns of 8, R = 1, 21 and 32, rows read in
    place from a table with padded rows (garbage in the padding) or from
    a contiguous one."""
    d = lca_case(120 + k, 256, k, r=r)
    t = _t(d)
    store, stride = _store(d["lin"], padded, np.random.default_rng(k))
    for merge_rank, highest in RANK_PAIRS[::2] + ((r, r), (r - 1, r - 1)):
        for hits_min, frac in LCA_PARAMS:
            args = (hits_min, frac, min(highest, r - 1),
                    min(merge_rank, r))
            want = P.classify_candidates_plain(t["tgt"], t["tax"],
                                               t["hits"], t["lin"], *args)
            got = _lca_model(d["tgt"], d["hits"], d["tax"], store, stride,
                             len(d["lin"]), r, *args)
            np.testing.assert_array_equal(got, want.numpy())


def _lineage_view(lin, view):
    """The (T, R) table ``lin`` as a contiguous tensor, as the (T, R)
    view of rows padded to a multiple of 4 ints (garbage in the
    padding), or as the transpose of an (R, T) table (ranks not
    adjacent)."""
    t, r = lin.shape
    if view == "contiguous":
        return lin
    if view == "columns":
        return lin.t().contiguous().t()
    full = torch.full((t, -(-r // 4) * 4), -7, dtype=lin.dtype)
    full[:, :r] = lin
    return full[:, :r]


@pytest.mark.parametrize("r", [1, 21, 32])
@pytest.mark.parametrize("view", ["padded", "contiguous", "columns"])
def test_classify_candidates_ranks_match_jax(r, view):
    """At R = 1, 21 and 32, with the lineages given as a padded-stride
    view, a contiguous table and a view whose ranks are not adjacent:
    both forms, plain and through the wrappers on CPU tensors, equal
    JAX's classify_candidates (and its lookup), merge_rank past the last
    rank included."""
    d = lca_case(200 + r, 384, 8, r=r)
    t = _t(d)
    lin = _lineage_view(t["lin"], view)
    assert torch.equal(lin, t["lin"]) and lin.stride(0) == {
        "padded": -(-r // 4) * 4, "contiguous": r, "columns": 1}[view]
    jt = jnp.asarray(d["tgt"])
    jtax = _jax_lookup(jt, jnp.asarray(d["merge_tax"]))
    for merge_rank, highest in ((0, r - 1), (min(4, r - 1), r - 1), (r, r),
                                (0, 0)):
        for hits_min, frac in LCA_PARAMS:
            args = (hits_min, frac, highest, merge_rank)
            want = np.asarray(jpipe.classify_candidates(
                jt, jtax, jnp.asarray(d["hits"]), jnp.asarray(d["lin"]),
                *args))
            for fn in (P.classify_candidates_plain, P.classify_candidates):
                np.testing.assert_array_equal(fn(
                    t["tgt"], t["tax"], t["hits"], lin, *args).numpy(), want)
            tax, cls = P.classify_with_taxa(t["tgt"], t["hits"],
                                            t["merge_tax"], lin, *args)
            np.testing.assert_array_equal(tax.numpy(), np.asarray(jtax))
            np.testing.assert_array_equal(cls.numpy(), want)
    assert (want != 0).sum() > 30


@pytest.mark.parametrize("bad", ["ranks", "empty", "dtype", "shape"])
def test_lca_wrappers_refuse_bad_inputs(bad):
    """Both wrappers check shapes and types before either route."""
    t = _t(lca_case(5, 16, 2))
    lin, tax = t["lin"], t["tax"]
    if bad == "ranks":
        lin = torch.zeros((8, 33), dtype=torch.int32)
    elif bad == "empty":
        lin = lin[:0]
    elif bad == "dtype":
        tax = tax.to(torch.int64)
    else:
        tax = tax[:, :1]
    with pytest.raises(ValueError):
        P.classify_candidates(t["tgt"], tax, t["hits"], lin, 5, 0.5, 20, 0)
    if bad in ("ranks", "empty"):
        with pytest.raises(ValueError):
            P.classify_with_taxa(t["tgt"], t["hits"], t["merge_tax"], lin,
                                 5, 0.5, 20, 0)


def _jax_hist(cls, n, ids, ranks, over):
    if over is None:
        return np.asarray(_rank_hist_jit()(jnp.asarray(cls), n,
                                           jnp.asarray(ids),
                                           jnp.asarray(ranks)))
    return np.asarray(_rank_hist_masked_jit()(
        jnp.asarray(cls), n, jnp.asarray(over), jnp.asarray(ids),
        jnp.asarray(ranks)))


@pytest.mark.parametrize("m,n", [(4096, 4096), (4096, 3001), (8192, 1)])
@pytest.mark.parametrize("masked", [False, True])
def test_rank_histogram_matches_jax(m, n, masked):
    """rank_histogram_plain, and the wrapper on CPU tensors, equal JAX's
    rank histograms: n at and below the stack, over bits in the first
    and last words, taxa absent from the table, past its last id and
    below its first, and 0."""
    cls, ids, ranks, over = hist_case(m + n, m)
    over = over if masked else None
    want = _jax_hist(cls.reshape(2, -1), n, ids, ranks, over)
    tc, ti, tr = (torch.from_numpy(a) for a in (cls, ids, ranks))
    to = None if over is None else torch.from_numpy(over)
    for fn in (trunner.rank_histogram_plain, trunner.rank_histogram):
        got = fn(tc.reshape(2, -1), n, ti, tr, over_bits=to)
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)


def _lift(lt, n):
    """The count of the n sorted values below c, ``lt(i)`` telling
    value i < c: binary lifting from the largest power of two <= n, as
    the kernel's lockstep search does."""
    top = 1
    while top <= n // 2:
        top *= 2
    p, s = 0, top
    while s:
        if p + s <= n and lt(p + s - 1):
            p += s
        s >>= 1
    return p


def _hist_search(c, ids, ranks, shift, smem_taxa):
    """The kernel's search (hist_bins4): the lower bound of c in the
    whole table (shift < 0), or first among every 2^shift-th id (the
    pivots) and then in the 2^shift - 1 ids after the pivot found, each
    by binary lifting; -> (position, id, rank)."""
    nt = len(ids)
    if shift < 0:
        assert nt <= smem_taxa
        lo = _lift(lambda i: ids[i] < c, nt)
    else:
        piv = ids[::1 << shift]
        q = _lift(lambda i: piv[i] < c, len(piv))
        j = ((q - 1) << shift) if q else -1
        lim = min(q << shift, nt)
        s = 1 << (shift - 1) if shift else 0
        while s:
            if j >= 0 and j + s < lim and ids[j + s] < c:
                j += s
            s >>= 1
        lo = j + 1
    assert lo == np.searchsorted(ids, c)
    pos = min(lo, nt - 1)
    return pos, ids[pos], ranks[pos]


def _hist_model(store, head, m, n, ids, ranks, over, num_ranks=21,
                threads=None, max_blocks=None, smem_taxa=None,
                pivots=None):
    """rank_hist (csrc/classify.cu): the m taxa start
    ``head`` ints into a 16-byte-aligned ``store``; quad q holds reads
    4q - head .. 4q - head + 3; a grid of min(ceil(quads / threads),
    max_blocks) blocks takes ``threads`` quads a turn; a warp's 128 reads
    see at most 5 overflow words, one a lane, picked by shuffle; the
    search on the whole table (nt <= smem_taxa) or on pivots (at most
    ``pivots``); each block's bins, then their sums (the scratch's).
    Constants default to the source's."""
    threads = threads or _source_int("kHistThreads")
    max_blocks = max_blocks or _source_int("kMaxHistBlocks")
    smem_taxa = smem_taxa or _source_int("kSmemTaxa")
    pivots = pivots or _source_int("kPivots")
    nt = len(ids)
    shift = -1
    if nt > smem_taxa:
        shift = 0
        while ((nt - 1) >> shift) + 1 > pivots:
            shift += 1
    nq = (m + head + 3) >> 2
    grid = min(max(-(-((m + 6) // 4) // threads), 1), max_blocks)
    words = None if over is None else over.view(np.uint32)
    nbins = num_ranks + 2
    parts = np.zeros((grid, nbins), np.int64)
    for blk in range(grid):
        for q0 in range(blk * threads, nq, grid * threads):
            for q in range(q0, min(q0 + threads, nq)):
                wbase = (4 * (q - (q - q0) % 32) - head) >> 5
                for p in range(4 * q - head, 4 * q - head + 4):
                    if not 0 <= p < m:
                        continue
                    assert 0 <= (p >> 5) - wbase < 5
                    if p >= n or (words is not None and
                                  (int(words[p >> 5]) >> (p & 31)) & 1):
                        b = num_ranks + 1
                    else:
                        c = store[head + p]
                        _pos, i, rk = _hist_search(c, ids, ranks, shift,
                                                   smem_taxa)
                        b = rk if c != 0 and i == c else num_ranks
                    if 0 <= b < nbins:
                        parts[blk, b] += 1
    return parts.sum(axis=0)[:num_ranks + 1]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("head,m,nt,small", [
    (0, 3000, 300, False), (1, 3001, 300, True), (3, 1, 300, False),
    (2, 4099, 5000, False), (1, 2999, 20000, False), (3, 2001, 700, True)])
def test_rank_hist_model_matches_plain(masked, head, m, nt, small):
    """The kernel's algorithm, modelled in numpy, equals the plain
    version: stacks no multiple of 4 (or 32) starting 0-3 ints past the
    16-byte grid, one read, tables above the shared-memory cap (pivots
    every 2^s ids), and, with small blocks and caps (16 quads, 3 blocks,
    64 taxa, 32 pivots: s up to 5), many blocks in grid-stride turns
    combined."""
    n = m - m // 10
    cls, ids, ranks, over = hist_case(7 + head, m, nt)
    over = over if masked else None
    store = np.concatenate([np.full(head, 77, np.int32), cls])
    kw = dict(threads=16, max_blocks=3, smem_taxa=64, pivots=32) \
        if small else {}
    want = trunner.rank_histogram_plain(
        torch.from_numpy(cls), n, torch.from_numpy(ids),
        torch.from_numpy(ranks),
        over_bits=None if over is None else torch.from_numpy(over))
    np.testing.assert_array_equal(
        _hist_model(store, head, m, n, ids, ranks, over, **kw),
        want.numpy())


@pytest.mark.parametrize("case", ["one", "ragged", "offset", "pivots"])
@pytest.mark.parametrize("masked", [False, True])
def test_rank_histogram_edges_match_jax(case, masked):
    """rank_histogram_plain, and the wrapper on CPU tensors, equal JAX's
    _rank_hist_jit and _rank_hist_masked_jit at one read, at a stack no
    multiple of 4, on a view starting 1-3 ints past the 16-byte grid, and
    with more taxa than the kernel stages whole (kSmemTaxa)."""
    m, nt, off = {"one": (1, 300, 0), "ragged": (4099, 300, 0),
                  "offset": (4093, 300, 3),
                  "pivots": (4096, _source_int("kSmemTaxa") + 904, 1)}[case]
    cls, ids, ranks, over = hist_case(40 + m, m + off, nt)
    n = m - 7 if m > 7 else m
    tc = torch.from_numpy(cls)[off:]
    over = over if masked else None
    to = None if over is None else torch.from_numpy(over)
    # JAX's masked form takes 32 reads a word; reads past n count in no
    # bin returned, so the stack padded to a multiple of 32 is the same
    m32 = -(-m // 32) * 32
    want = _jax_hist(np.pad(cls[off:], (0, m32 - m)).reshape(1, -1), n, ids,
                     ranks, None if over is None else over[:m32 // 32])
    for fn in (trunner.rank_histogram_plain, trunner.rank_histogram):
        got = fn(tc.reshape(1, -1), n, torch.from_numpy(ids),
                 torch.from_numpy(ranks), over_bits=to)
        np.testing.assert_array_equal(got.numpy(), want)
    if over is None:
        assert want.sum() == n


def test_rank_histogram_refuses_bad_tables():
    cls, ids, ranks, over = (torch.from_numpy(a) for a in hist_case(3, 64))
    for args in ((cls, 64, ids[:0], ranks[:0]), (cls, 64, ids, ranks[:-1]),
                 (cls.to(torch.int64), 64, ids, ranks)):
        with pytest.raises(ValueError):
            trunner.rank_histogram(*args)
    with pytest.raises(ValueError):
        trunner.rank_histogram(cls, 64, ids, ranks, over_bits=over[:1])


def _step_tables(d, bits, merge_tax):
    ft = d["ft"]
    return tables_from_numpy(
        ft.unique_features, ft.offsets,
        ft.fused_rows(d["spf"], slot_bits=bits), d["brows"], d["bits"],
        d["lin"], merge_tax, d["spf"], bits, torch.device("cpu"))


@pytest.mark.parametrize("fused,fast_top2,kk,merge_rank", [
    (True, True, 2, 0), (False, True, 2, 0), (False, False, 2, 4),
    (False, False, 8, 4)])
def test_scan_step_tail_matches_jax(strain_db, fused, fast_top2, kk,
                                    merge_rank):
    """The port's scan step through the new dispatch (classify_with_taxa
    after B4's plain version or _fast_top2_result, classify_candidates
    after the taxon merge) equals JAX's query_step_rows_scan: the fused
    branch, the non-fused top-k and the non-fused merge by species."""
    d = strain_db
    bits = d["wbits"]
    K, B = 2, 16
    reads = _reads(d, K * B, 100, seed=31)
    c4 = np.zeros((K * B, 128), np.uint8)
    c4[:, :100] = reads
    packed = pack_2bit(c4).reshape(K, B, 1, 32)
    lens = np.full((K, B, 1), 100, np.uint8)
    mwir = np.full((K, B), 2, np.uint8)
    merge_tax = d["lin"][:, merge_rank].copy()
    hits_min, frac, highest = 5, 0.9, 19
    ft = d["ft"]
    want = np.asarray(jrows.query_step_rows_scan(
        jnp.asarray(packed), jnp.asarray(lens), jnp.asarray(mwir),
        jnp.asarray(ft.unique_features),
        jnp.asarray(ft.offsets.astype(np.int32)),
        jnp.asarray(ft.fused_rows(d["spf"], slot_bits=bits)),
        jnp.zeros((1,), jnp.int32), jnp.asarray(merge_tax),
        jnp.asarray(d["lin"]), jnp.int32(hits_min), jnp.float32(frac),
        jnp.int32(highest), jnp.int32(merge_rank), jnp.asarray(d["brows"]),
        k=16, sketchlen=16, slots_per_feature=d["spf"],
        windows_per_query=1, max_candidates=kk, prefix_bits=d["bits"],
        dense=_layout(bits), walk_elems=32, fast_top2=fast_top2,
        fused_candidates=fused, pack_bits=bits, infeed_packed=True))
    got = trows.query_step_rows_scan(
        torch.from_numpy(packed), torch.from_numpy(lens),
        torch.from_numpy(mwir), _step_tables(d, bits, merge_tax), hits_min,
        frac, highest, merge_rank, k=16, sketchlen=16, windows_per_query=1,
        max_candidates=kk, walk_elems=32, fast_top2=fast_top2,
        fused_candidates=fused, pack_bits=bits, infeed_packed=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > K * B // 2
