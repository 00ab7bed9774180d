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
from test_torch_cuda import LCA_PARAMS, hist_case, lca_case, pack_2bit
from test_torch_rows import _layout, _reads, strain_db  # noqa: F401

torch.set_num_threads(2)
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


def _lca_model(tgt, hits, tax, lin, hits_min, frac, highest, merge_rank):
    """classify_lca's algorithm, one read at a time (one warp a read):
    the walk over the candidates in order, which stops at the first one
    left out; candidate 0's lineage and the agreement a rank (a lane);
    r0 and the LCA rank as the first set bit of a mask (the ballots)."""
    b, k = tgt.shape
    t, r = lin.shape
    ranks = np.arange(r)
    out = np.zeros(b, np.int32)
    for i in range(b):
        inc, valid0, thr = True, False, np.float32(0)
        lin0 = np.zeros(r, np.int32)
        agree = np.zeros(r, bool)
        for j in range(k):
            e = tax[i, j] != 0
            h = int(hits[i, j])
            if j == 0:
                valid0 = e and h >= hits_min
                thr = np.float32(np.float32(h - hits_min) * np.float32(
                    frac)) if h > hits_min else np.float32(0)
                inc = e
            else:
                inc = e and np.float32(h) > thr
            if not inc:
                break
            lj = lin[min(max(int(tgt[i, j]), 0), t - 1)]
            if j == 0:
                lin0, agree = lj, lj != 0
            else:
                agree = agree & (lj == lin0)
        e0 = np.flatnonzero((lin0 != 0) & (ranks >= merge_rank))
        r0 = e0[0] if len(e0) else r
        el = np.flatnonzero(agree & (ranks >= r0))
        if valid0 and len(el) and el[0] <= highest:
            out[i] = lin0[el[0]]
    return out


@pytest.mark.parametrize("k", [1, 2, 8, 40])
def test_lca_model_matches_plain(k):
    """The kernel's algorithm, modelled in numpy, equals the plain
    version, K = 40 included (the kernel's two turns of 32)."""
    d = lca_case(120 + k, 256, k)
    t = _t(d)
    for merge_rank, highest in RANK_PAIRS[::2]:
        for hits_min, frac in LCA_PARAMS:
            args = (hits_min, frac, highest, merge_rank)
            want = P.classify_candidates_plain(t["tgt"], t["tax"],
                                               t["hits"], t["lin"], *args)
            got = _lca_model(d["tgt"], d["hits"], d["tax"], d["lin"], *args)
            np.testing.assert_array_equal(got, want.numpy())


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


def _hist_model(cls, n, ids, ranks, over, num_ranks=21):
    """rank_hist's algorithm: a lower-bound search a read, clamped to the
    last id, and bins of num_ranks + 2 of which the first num_ranks + 1
    are returned."""
    bins = np.zeros(num_ranks + 2, np.int64)
    for i, c in enumerate(cls):
        if i >= n or (over is not None and
                      (int(over.view(np.uint32)[i >> 5]) >> (i & 31)) & 1):
            bins[num_ranks + 1] += 1
            continue
        lo, hi = 0, len(ids)
        while lo < hi:
            mid = (lo + hi) >> 1
            if ids[mid] < c:
                lo = mid + 1
            else:
                hi = mid
        pos = min(lo, len(ids) - 1)
        b = ranks[pos] if c != 0 and ids[pos] == c else num_ranks
        if b < num_ranks + 2:
            bins[b] += 1
    return bins[:num_ranks + 1]


@pytest.mark.parametrize("masked", [False, True])
def test_rank_hist_model_matches_plain(masked):
    """The kernel's algorithm, modelled in numpy, equals the plain
    version on a stack whose size is no multiple of 32."""
    m, n = 3000, 2900
    cls, ids, ranks, over = hist_case(7, m)
    over = over if masked else None
    want = trunner.rank_histogram_plain(
        torch.from_numpy(cls), n, torch.from_numpy(ids),
        torch.from_numpy(ranks),
        over_bits=None if over is None else torch.from_numpy(over))
    np.testing.assert_array_equal(_hist_model(cls, n, ids, ranks, over),
                                  want.numpy())


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
