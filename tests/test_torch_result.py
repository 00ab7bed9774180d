"""metacache_tpu_torch's non-fused result path (ops/rows.py::rows_to_result
with fused_candidates=False: the row sort, the walk, dedup and rank-join
sweeps, _fast_top2_result, the best range per target, the taxon merge,
the final ranking and the per-hit lists) against metacache_tpu's own
rows_to_result with fused_candidates=False, as tests/test_rows_fast.py
calls it, on randomized slot rows from a numpy seed. All nine
QueryResult fields must be equal, tolerance 0 (integer outputs; the LCA
threshold is float32 on both sides)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from metacache_tpu.ops import rows as jrows
from metacache_tpu_torch.ops import candidates as C
from metacache_tpu_torch.ops import rows as trows

torch.set_num_threads(2)
I32_MAX = 2**31 - 1
NR = 21
SPECIES = 4
NTGT, NWIN = 40, 300
PB = (2 * (NWIN - 1)).bit_length()      # the database's window bits
FIELDS = ("cand_tgt", "cand_tax", "cand_hits", "cand_beg", "cand_end",
          "cls_tax", "hit_qid", "hit_tgt", "hit_win")


def _slots(rng, b, l, ntgt=NTGT, nwin=NWIN, fill=0.7):
    """(b, l) unsorted (tgt, win) rows with duplicate (tgt, win) runs, a
    few targets per row at neighbouring windows plus noise, I32_MAX
    padding at random places and some empty rows."""
    tgt = np.full((b, l), I32_MAX, np.int32)
    win = np.full((b, l), I32_MAX, np.int32)
    for i in range(b):
        if i % 7 == 3:
            continue                          # an empty row
        n = int(rng.integers(1, int(l * fill) + 1))
        base = rng.integers(0, ntgt, 4)
        w0 = int(rng.integers(0, nwin - 8))
        t = base[rng.integers(0, 4, n)]
        w = w0 + rng.integers(0, 8, n)
        noise = rng.random(n) < 0.25
        t[noise] = rng.integers(0, ntgt, int(noise.sum()))
        w[noise] = rng.integers(0, nwin, int(noise.sum()))
        at = rng.permutation(l)[:n]
        tgt[i, at] = t
        win[i, at] = w
    return tgt, win


def _lineages(ntgt, neg_species=False):
    """Sequence-level taxa -(t + 1), species 100 + t // 3 (negative for
    every fifth target with ``neg_species``, or 0 for every seventh),
    root 1."""
    lin = np.zeros((ntgt, NR), np.int32)
    t = np.arange(ntgt)
    lin[:, 0] = -t - 1
    lin[:, SPECIES] = t // 3 + 100
    if neg_species:
        lin[t % 5 == 0, SPECIES] = -(t[t % 5 == 0] // 3) - 500
    lin[t % 7 == 6, SPECIES] = 0
    lin[:, 6] = t // 9 + 50
    lin[:, 20] = 1
    return lin


def _merge_tax(lin, merge_rank):
    """The runner's merge taxon: the lowest nonzero rank >= merge_rank."""
    mt = np.zeros(len(lin), np.int32)
    for r in range(merge_rank, NR):
        fill = (mt == 0) & (lin[:, r] != 0)
        mt[fill] = lin[fill, r]
    return mt


def _pack(tgt, win, pb):
    pk = (tgt.astype(np.int64) << pb) | win
    return np.where(tgt == I32_MAX, I32_MAX, pk).astype(np.int32)


def _both(tgt, win, mwir, lin, merge_rank, *, pack_bits=0, fused=False,
          **kw):
    """-> (JAX's QueryResult with fused_candidates=False, the port's)."""
    mt = _merge_tax(lin, merge_rank)
    if pack_bits:
        tgt = win = _pack(tgt, win, pack_bits)
    args = (5, 0.5, 19, merge_rank)
    want = jrows.rows_to_result(
        jnp.asarray(tgt), jnp.asarray(win), jnp.asarray(mwir),
        jnp.asarray(mt), jnp.asarray(lin), jnp.int32(args[0]),
        jnp.float32(args[1]), jnp.int32(args[2]), jnp.int32(args[3]),
        fused_candidates=False, pack_bits=pack_bits, **kw)
    got = trows.rows_to_result(
        torch.from_numpy(tgt), torch.from_numpy(win),
        torch.from_numpy(mwir), torch.from_numpy(mt),
        torch.from_numpy(lin), *args, fused_candidates=fused,
        pack_bits=pack_bits, **kw)
    return want, got


def _assert_equal(want, got):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)


SWEEPS = {"rank-join": {}, "walk12": {"walk_elems": 12},
          "dedup4": {"dedup_walk": 4}}
# (fast_top2, max_candidates, merge_rank, emit_hits): the product pruned
# to five rows a sweep and packing; fast_top2 asserts merge_rank 0
VARIANTS = [(True, 2, 0, False), (True, 4, 0, True), (False, 8, 0, False),
            (False, 2, SPECIES, True), (False, 8, SPECIES, False)]
CASES = [(s, p, *v) for s in SWEEPS for p in (0, PB) for v in VARIANTS]


@pytest.mark.parametrize(
    "sweep,pack_bits,fast_top2,kk,merge_rank,emit_hits", CASES,
    ids=[f"{s}-pb{p}-{'fast' if f else 'sort'}-k{k}-m{m}-"
         f"{'hits' if e else 'nohits'}" for s, p, f, k, m, e in CASES])
def test_non_fused_result_matches_jax(sweep, pack_bits, fast_top2, kk,
                                      merge_rank, emit_hits):
    rng = np.random.default_rng(CASES.index(
        (sweep, pack_bits, fast_top2, kk, merge_rank, emit_hits)))
    b, l = 24, 160
    tgt, win = _slots(rng, b, l)
    mwir = rng.integers(2, 7, b).astype(np.int32)
    want, got = _both(tgt, win, mwir, _lineages(NTGT), merge_rank,
                      pack_bits=pack_bits, max_candidates=kk,
                      fast_top2=fast_top2, emit_hits=emit_hits,
                      **SWEEPS[sweep])
    _assert_equal(want, got)
    assert (got.cand_tgt[:, 0] >= 0).any() and (got.cand_hits >= 5).any()
    if emit_hits:
        assert got.hit_qid.shape == (b * l,)


@pytest.mark.parametrize("kk", [2, 4])
def test_fast_top2_wide_keys_match_jax(kk):
    """Rows wide enough that the group-isolated keys need int64 (L *
    next_pow2(L)^2 >= 2^31, JAX's ``wide``), after
    tests/test_rows_fast.py::test_fast_top2_wide_rows_i64, with
    hundreds of distinct targets a row."""
    rng = np.random.default_rng(7)
    b, l, ntgt = 4, 1536, 1200
    assert l * (1 << l.bit_length()) ** 2 >= 2**31
    tgt, win = _slots(rng, b, l, ntgt=ntgt, nwin=500, fill=0.9)
    tgt[:, :400] = rng.integers(0, ntgt, (b, 400))
    mwir = rng.integers(2, 6, b).astype(np.int32)
    want, got = _both(tgt, win, mwir, _lineages(ntgt), 0, max_candidates=kk,
                      fast_top2=True, emit_hits=True)
    _assert_equal(want, got)


@pytest.mark.parametrize("fast_top2", [False, True])
def test_empty_rows_match_jax(fast_top2):
    """Rows with no match slot: no candidate, unclassified, padding
    query ids."""
    b, l = 8, 64
    pad = np.full((b, l), I32_MAX, np.int32)
    want, got = _both(pad, pad.copy(), np.full(b, 3, np.int32),
                      _lineages(4), 0, max_candidates=3 if not fast_top2
                      else 2, fast_top2=fast_top2, emit_hits=True)
    _assert_equal(want, got)
    assert (got.cand_tgt == -1).all() and (got.cls_tax == 0).all()
    assert (got.hit_qid == b).all()


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_negative_taxa_under_merging_match_jax(sweep):
    """Taxon merging where merge taxa are negative (sequence-level ids,
    and species ids given below zero), so a -1 sentinel would collide:
    -lowest species with 3 candidates and -lowest sequence with 5."""
    rng = np.random.default_rng(99)
    tgt, win = _slots(rng, 16, 128)
    mwir = np.full(16, 4, np.int32)
    lin = _lineages(NTGT, neg_species=True)
    for merge_rank, kk in ((SPECIES, 3), (0, 5)):
        assert (_merge_tax(lin, merge_rank) < 0).any()
        want, got = _both(tgt, win, mwir, lin, merge_rank, max_candidates=kk,
                          emit_hits=False, **SWEEPS[sweep])
        _assert_equal(want, got)
        assert (got.cand_tax < 0).any()


@pytest.mark.parametrize("pack_bits", [PB, 0])
def test_rows_wider_than_one_block_fuse_and_match_jax(monkeypatch,
                                                       pack_bits):
    """A row wider than MAX_CAND_L2 (packed) or MAX_UNPACKED_L2 pairs,
    with flags that fuse: the route is JAX's (fuses() takes no width),
    the candidate kernel's wrapper runs (its wide form on the card, the
    plain version here), and the result equals JAX's non-fused one."""
    calls = []
    for name in ("candidates_packed", "candidates_unpacked"):
        real = getattr(trows, name)
        monkeypatch.setattr(trows, name, lambda *a, _n=name, _f=real, **k:
                            calls.append((_n, a[0].shape[1])) or _f(*a, **k))
    l = (C.MAX_CAND_L2 if pack_bits else C.MAX_UNPACKED_L2) + 64
    assert trows.fuses(True, True, 2, 0, 4, False)
    rng = np.random.default_rng(5)
    tgt, win = _slots(rng, 2, l, fill=0.3)
    mwir = np.full(2, 5, np.int32)
    want, got = _both(tgt, win, mwir, _lineages(NTGT), 0,
                      pack_bits=pack_bits, fused=True, max_candidates=2,
                      fast_top2=True, dedup_walk=4, emit_hits=False)
    _assert_equal(want, got)
    assert calls == [("candidates_packed" if pack_bits
                      else "candidates_unpacked", l)]


def test_taxon_merge_keys_do_not_wrap():
    """Taxon merging on a row of 40,000 slots (L2 = 65,536) with 36,000
    taxa, each its own group: JAX's int32 offsets g * L2 wrap past group
    32,767 and give the early groups a first insertion position below
    zero, which then wraps to near 2^31; the port's int64 ones keep
    every group's own. Two targets tie on 2 hits: target 1 (taxon group
    2, its slots early in the row) and target 35,000 (group 35,001, past
    the wrap). The reference ranks the tie by the first insertion
    position, target 1 first; JAX's wrapped keys rank it the other
    way."""
    ntgt, l = 36000, 40000
    lin = np.zeros((ntgt, NR), np.int32)
    t = np.arange(ntgt)
    lin[:, 0] = -t - 1
    lin[:, SPECIES] = 100 + t                  # one taxon a target
    lin[:, 20] = 1
    tgt = np.full((1, l), I32_MAX, np.int32)
    win = np.full((1, l), I32_MAX, np.int32)
    tgt[0, :ntgt] = t
    win[0, :ntgt] = 10
    tgt[0, ntgt:ntgt + 2] = (1, 35000)         # a second slot each
    win[0, ntgt:ntgt + 2] = 11
    mwir = np.full(1, 4, np.int32)
    want, got = _both(tgt, win, mwir, lin, SPECIES, max_candidates=2,
                      walk_elems=12, emit_hits=False)
    # the reference: hits 2 for both, ties by the first slot position
    # of the group (target 1's slots come first in (tgt, win) order)
    np.testing.assert_array_equal(got.cand_tgt.numpy(), [[1, 35000]])
    np.testing.assert_array_equal(got.cand_hits.numpy(), [[2, 2]])
    np.testing.assert_array_equal(got.cand_tax.numpy(),
                                  [[lin[1, SPECIES], lin[35000, SPECIES]]])
    np.testing.assert_array_equal(got.cand_beg.numpy(), [[10, 10]])
    np.testing.assert_array_equal(got.cand_end.numpy(), [[11, 11]])
    assert np.asarray(want.cand_tgt).tolist() == [[35000, 1]]
