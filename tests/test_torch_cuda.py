"""metacache_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, the device table builder on
the card against the same builder on the CPU, and the port's query of
the fixture against the reference goldens through the kernels, with
packed and with unpacked slots, through the two-tier layout with
escalation, the classed cells and the pair-packed rows probed by B9, on
paired-end reads and on a database of two parts, and on a winlen-255
database through B2 against the CPU run; a k = 18 database through the
64-bit sketch kernel against the reference's k18 goldens; a non-fused
batch split into launches by the free memory; the multi-part step on
random tables against the same step on the CPU; the CSR layout through
csr_decode against the goldens; dense_decode on the dense and two-tier
lane rows (u32 and u64 features) against its plain version; B8 on head
widths 3 to 65, on views off the 16-byte grid and in a CUDA graph right
after the kernel that writes its indices; B9 on every
bucket-index width (u32 and u64), classed_bucket and classed_decode
(full depth and head only; probes of every cell class and kind at even
and odd indices, counts that leave a warp part-filled, and the head
form's 4-byte path on unaligned cells) against their plain versions; the
step's tail, classify_lca (both forms; R = 1, 21 and 32, K up to 40,
lineage tables with padded, unpadded, unaligned and non-adjacent rows,
in a CUDA graph) and rank_hist (one launch a call; empty, ragged and
unaligned stacks, 2^20 taxa, forty calls in a row, two streams at once,
in CUDA graphs, two of them replayed at once), against their plain
versions; tolerance 0.

Needs an NVIDIA GPU (marker `cuda`; skipped without one). Imports no
JAX, so it also runs on a GPU host without JAX:
    python -m pytest -m cuda tests/test_torch_cuda.py
"""
import contextlib
import io
import os

import numpy as np
import pytest
import torch

from metacache_tpu_torch import kernels
from metacache_tpu_torch.cli.main import main
from metacache_tpu_torch.classify.runner import QueryRunner
from metacache_tpu_torch.ops import candidates as C
from metacache_tpu_torch.ops import probe_decode as D
from metacache_tpu_torch.ops import sketch as S

pytestmark = pytest.mark.cuda
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
I32_MAX = 2**31 - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _slots(rng, b, l, ntgt, nwin, wbits, dup=False):
    tgt = rng.integers(0, ntgt, (b, l))
    win = rng.integers(0, nwin, (b, l))
    if dup:
        d = rng.random((b, l)) < 0.5
        tgt = np.where(d, np.roll(tgt, 1, 1), tgt)
        win = np.where(d, np.roll(win, 1, 1), win)
    pk = (tgt << wbits) | win
    n = rng.integers(0, l + 1, (b, 1))
    return np.where(np.arange(l) < n, pk, I32_MAX).astype(np.int32)


# ---------------------------------------- random multi-part tables
def lineages(n):
    """Lineages of n targets: sequence-level taxa -1 .. -n, 8 targets a
    genus-level taxon (100, 101, ...), all under root."""
    lin = np.zeros((n, 21), np.int32)
    lin[:, 0] = -np.arange(n) - 1
    lin[:, 4] = np.arange(n) // 8 + 100
    lin[:, 20] = 1
    return lin


def feature_locations(rng, feats_of_read, deep, ntgt):
    """(feature, target, window) triples: each read's features point at
    its own target and window (the read's origin) plus a few random
    locations; ``deep`` reads' features get 8 more, so their buckets pass
    a head of 4."""
    fs, ts, ws = [], [], []
    seen = set()
    for r, feats in enumerate(feats_of_read):
        for f in np.unique(feats):
            if f == 0xFFFFFFFF or int(f) in seen:
                continue
            seen.add(int(f))
            extra = 8 if deep[r] else int(rng.integers(0, 3))
            fs += [f] * (1 + extra)
            ts += [r % ntgt] + rng.integers(0, ntgt, extra).tolist()
            ws += [r % 5 + 3] + rng.integers(0, 40, extra).tolist()
    return (np.asarray(fs, np.uint32), np.asarray(ts, np.uint32),
            np.asarray(ws, np.uint32))


def feature_table(f, t, w):
    from metacache_tpu_torch.ops.table import FeatureTable, pack_locations
    order = np.lexsort((w, t, f))
    return FeatureTable.build(f[order].copy(),
                              pack_locations(t[order], w[order]),
                              max_locations_per_feature=254)


def multipart_case(ntgt=24, b=32):
    """b reads of 100 bp (one shorter than k) and the locations of their
    features, dealt at random over 3 parts (a feature can sit in
    several); seed 11."""
    rng = np.random.default_rng(11)
    codes = np.full((b, 1, 127), 4, np.uint8)
    codes[:, 0, :100] = rng.integers(0, 4, (b, 100))
    lens = np.full((b, 1), 100, np.int32)
    lens[5, 0] = 12
    feats = S.sketch_windows_plain(torch.from_numpy(codes.reshape(b, 127)),
                                   torch.from_numpy(lens.reshape(b)), 16,
                                   16).numpy().view(np.uint32)
    f, t, w = feature_locations(rng, feats, rng.random(b) < 0.5, ntgt)
    return dict(codes=codes, lens=lens, locs=(f, t, w),
                part=rng.integers(0, 3, len(f)),
                wbits=(2 * int(w.max())).bit_length(), lin=lineages(ntgt))


def part_layouts(case, nparts, pack_bits):
    """The case's parts, dense or two-tier (head 4): 2 parts two-tier and
    dense, 3 parts dense, two-tier and two-tier; each part's slots stored
    packed where the query packs them, the last part's the other way (the
    probe converts them). -> per part (port tables on the CPU, host
    arrays: table, rows, overflow rows, bucket rows, bucket bits, stored
    slot bits, metacache_tpu's layout tag)."""
    from metacache_tpu_torch.db.state import tables_from_numpy
    from metacache_tpu_torch.ops.probe import make_bucket_index
    f, t, w = case["locs"]
    lin, wb = case["lin"], case["wbits"]
    kinds = ["two_tier", "dense"] if nparts == 2 else \
        ["dense", "two_tier", "two_tier"]
    out = []
    for p, kind in enumerate(kinds):
        sel = case["part"] % nparts == p
        ft = feature_table(f[sel], t[sel], w[sel])
        spf = ft.max_bucket_size
        assert spf > 4
        stored = wb if (pack_bits > 0) != (p == nparts - 1) else 0
        brows, bits = make_bucket_index(ft.unique_features)
        if kind == "dense":
            rows, ovf, hsl = ft.fused_rows(spf, slot_bits=stored), None, 0
            tag = f"pk{stored}" if stored else True
        else:
            rows, ovf = ft.fused_rows_two_tier(spf, 4, slot_bits=stored)
            hsl = 4
            tag = ("two_tier", 4, False, False, stored) if stored else \
                ("two_tier", 4)
        out.append((tables_from_numpy(
            ft.unique_features, ft.offsets, rows, brows, bits, lin,
            lin[:, 0].copy(), spf, stored, torch.device("cpu"),
            ovf_rows=ovf, head_slots=hsl),
            dict(ft=ft, rows=rows, ovf=ovf, brows=brows, bits=bits,
                 stored=stored, tag=tag)))
    return out


MULTIPART_ARGS = (5, 0.5, 19, 0)   # hits_min, hits_diff, highest, merge


def multipart_step(case, tables, pack_bits, max_candidates, dev):
    """The port's multi-part step on the case's reads: two candidates
    through the fused kernels, eight through the non-fused path with its
    per-hit lists."""
    from metacache_tpu_torch.ops.rows import query_step_rows_multipart
    b = case["codes"].shape[0]
    fused = max_candidates <= 4
    return query_step_rows_multipart(
        torch.from_numpy(case["codes"]).to(dev),
        torch.from_numpy(case["lens"]).to(dev),
        torch.full((b,), 2, dtype=torch.int32, device=dev),
        [t.to(dev) for t in tables], *MULTIPART_ARGS, k=16, sketchlen=16,
        windows_per_query=1, max_candidates=max_candidates, walk_elems=32,
        fast_top2=fused, emit_hits=not fused, pack_bits=pack_bits)


@pytest.mark.parametrize("nparts", [2, 3])
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("max_candidates", [2, 8])
def test_multipart_step_on_the_card_matches_cpu(cuda, nparts, packed,
                                                max_candidates):
    """The twin of tests/test_torch_pairs.py::
    test_multipart_step_matches_jax: the step on the card (B1, the
    parts' probes with B7 on two-tier packed rows, B4 or B5 on the
    concatenated rows, or the non-fused path) equals the same step on
    CPU tensors in all nine QueryResult fields."""
    case = multipart_case()
    pack_bits = case["wbits"] if packed else 0
    tables = [t for t, _h in part_layouts(case, nparts, pack_bits)]
    kernels.reset_counts()
    got = multipart_step(case, tables, pack_bits, max_candidates, cuda)
    torch.cuda.synchronize()
    want = multipart_step(case, tables, pack_bits, max_candidates,
                          torch.device("cpu"))
    for nm in want._fields:
        assert torch.equal(getattr(got, nm).cpu(), getattr(want, nm)), nm
    assert kernels.SKETCH.launches == 1
    # one two-tier part stores packed slots (B7), but with 2 parts and
    # unpacked slots
    assert kernels.FULL_DECODE.launches == int(packed or nparts == 3)
    fused = (kernels.CANDIDATES if packed else
             kernels.CANDIDATES_UNPACKED).launches
    assert fused == (1 if max_candidates <= 4 else 0)


@pytest.mark.parametrize("gold,args", [
    ("classified_pairfiles.txt", ["reads_pair1.fa", "reads_pair2.fa",
                                  "-pairfiles", "-precision",
                                  "-ground-truth", "-tophits"]),
    ("classified_pairseq.txt", ["reads_pairseq.fa", "-pairseq",
                                "-precision", "-ground-truth", "-tophits"]),
    ("insertsize.txt", ["reads_pair1.fa", "reads_pair2.fa", "-pairfiles",
                        "-insertsize", "1000", "-tophits"]),
    ("fmt_0.txt", ["reads_single.fa", "@parts"])])
def test_fixture_pairs_and_parts_on_the_card_match_golden(cuda, tmp_path,
                                                          monkeypatch, gold,
                                                          args):
    """The paired goldens through the card's kernels, and the single-end
    golden from a database of two parts (`build -parts 2`, host build;
    the multi-part step on the card)."""
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    parts = "@parts" in args
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"] + (["-parts", "2"] if parts else [])) \
        == 0
    args = [f"{DATA}/{a}" if a.startswith("reads_") else a for a in args
            if a != "@parts"]
    kernels.reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["query", db] + args) == 0
    assert kernels.SKETCH.launches > 0 and kernels.CANDIDATES.launches > 0
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")

    def strip(text):
        return [l for l in text.splitlines()
                if not any(d in l for d in drop)]
    with open(os.path.join(DATA, "golden", gold)) as f:
        assert strip(buf.getvalue()) == strip(f.read())


@pytest.mark.parametrize("case", ["random", "ambiguous", "short"])
def test_sketch_kernel_matches_plain(cuda, case):
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, (4096, 128), dtype=np.uint8)
    valid = np.full(4096, 127, np.int32)
    if case == "ambiguous":
        codes[rng.random(codes.shape) < 0.05] = 4
    elif case == "short":
        valid = rng.integers(0, 128, 4096).astype(np.int32)
    c = torch.from_numpy(codes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    for k, s in ((16, 16), (12, 8)):
        got = S.sketch_windows(c, v, k, s)
        torch.cuda.synchronize()
        assert torch.equal(got, S.sketch_windows_plain(c, v, k, s))


def _b1_inputs(rng, n, k):
    """(n, 128) windows with ambiguous codes, all-ambiguous, repeated and
    partly ambiguous windows, and valid lengths below k, at k, 100, 127,
    128 and random; and the same codes with every ambiguous one made 2,
    for the packed rows."""
    codes = rng.integers(0, 4, (n, 128), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[3::97, 20:60] = 4
    codes[4::101] = 4
    codes[5::89] = np.tile(np.array([0, 1, 2, 3], np.uint8), 32)
    valid = rng.integers(0, 129, n).astype(np.int32)
    valid[::7] = 127
    valid[1::11] = k - 1
    valid[2::13] = k
    valid[6::17] = 100
    valid[8::19] = 128
    return codes, valid, np.where(codes < 4, codes, 2).astype(np.uint8)


def pack_2bit(codes):
    """(N, W) codes 0..3 -> (N, W / 4) bytes, four a byte, low bits
    first (the runner's infeed); the port's tests share this one."""
    c = codes.astype(np.uint8)
    return np.ascontiguousarray(
        c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4) | (c[:, 3::4] << 6))


@pytest.mark.parametrize("k", [16, 12])
def test_sketch_kernel_inputs_match_plain(cuda, k):
    """B1 on (N, 128) codes and on packed rows of 32 and 28 bytes (the
    runner's rows cropped to 100 bp reads), which it reads itself,
    s = 8, 16 and 128, against its plain version (on the packed rows:
    the unpack and padding, then the plain version); one launch a
    call."""
    rng = np.random.default_rng(31 + k)
    for n in (8192, 4099):
        codes, valid, clean = _b1_inputs(rng, n, k)
        c = torch.from_numpy(codes).to(cuda)
        v = torch.from_numpy(valid).to(cuda)
        feeds = [torch.from_numpy(pack_2bit(clean[:, :w])).to(cuda)
                 for w in (128, 112)]
        for s in (16, 8, 128):
            before = kernels.SKETCH.launches
            got = S.sketch_windows(c, v, k, s)
            assert torch.equal(got, S.sketch_windows_plain(c, v, k, s))
            for pk in feeds:
                got = S.sketch_windows_packed(pk, v, k, s)
                assert torch.equal(got, S.sketch_windows_plain(
                    S.pad_windows(S.unpack_2bit(pk)), v, k, s))
            torch.cuda.synchronize()
            assert kernels.SKETCH.launches == before + 3


@pytest.mark.parametrize("k", [16, 12])
@pytest.mark.parametrize("w", [129, 255, 256, 511, 512, 600, 1000])
def test_long_sketch_kernel_matches_plain(cuda, w, k):
    """B2 on rows w bytes apart (unaligned from row 1 at odd w), and on
    rows read in place from an unaligned start, with ambiguous runs
    across chunk cuts, all-ambiguous and repeated windows, and valid
    lengths below k, at chunk bounds (113, 128, 130, 512), past w and
    random, s = 8, 16 and 128."""
    rng = np.random.default_rng(w + k)
    n = 4096
    codes = rng.integers(0, 4, (n, w), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[3::101, 100:180] = 4
    codes[4::103] = 4
    codes[5::107] = np.tile(np.array([0, 1, 2, 3], np.uint8), w)[:w]
    valid = rng.integers(0, w + 1, n).astype(np.int32)
    valid[::7] = w
    valid[1::11] = k - 1
    valid[2::13] = 113
    valid[6::17] = 130
    valid[8::19] = 250
    valid[9::23] = 128
    valid[10::29] = 512
    valid[12::31] = w + 40
    c = torch.from_numpy(codes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = kernels.SKETCH_LONG.launches
    for s in (16, 8, 128):
        got = S.sketch_windows(c, v, k, s)
        torch.cuda.synchronize()
        assert torch.equal(got, S.sketch_windows_long_plain(c, v, k, s))
    assert kernels.SKETCH_LONG.launches == before + 3
    # column slices: rows 2 w bytes apart, and rows w + 1 bytes apart
    # from an odd address, read in place
    wide = torch.cat([c, c], dim=1)[:, :w]
    odd = torch.cat([c[:, :1], c], dim=1)[:, 1:]
    assert odd.data_ptr() % 2 == 1 and odd.stride(0) == w + 1
    want = S.sketch_windows_long_plain(c, v, k, 16)
    assert torch.equal(S.sketch_windows(wide, v, k, 16), want)
    assert torch.equal(S.sketch_windows(odd, v, k, 16), want)


@pytest.mark.parametrize("k", [17, 18, 24, 31, 32])
@pytest.mark.parametrize("w", [96, 127, 128, 255, 511, 1024])
def test_sketch64_kernel_matches_plain(cuda, w, k):
    """The 64-bit sketch kernel (k > 16) against its plain version, bit
    for bit: coded rows of w with ambiguous codes and runs, repeated
    windows, windows whose every start is the same k-mer (duplicates
    across the 128-start chunks), valid lengths below k, at k, at the
    chunk boundary (128 + k - 2, 128 + k - 1 and 128 + k), past w and
    random, s = 1, 16, 8 and 128; rows read in place from an odd
    address; and at w <= 128 the packed rows of the same windows
    (ambiguous codes made 2), which it reads itself, at every width
    from 1 to w / 4 bytes, s = 1, 16 and 128."""
    rng = np.random.default_rng(w * 40 + k)
    n = 4099
    codes = rng.integers(0, 4, (n, w), dtype=np.uint8)
    codes[rng.random(codes.shape) < 0.01] = 4
    codes[3::101, 30:80] = 4
    codes[4::103] = 4
    codes[5::107] = np.tile(np.array([0, 1, 2, 3], np.uint8), w)[:w]
    codes[8::109] = 0
    codes[9::113] = 3
    valid = rng.integers(0, w + 1, n).astype(np.int32)
    valid[::7] = w
    valid[1::11] = k - 1
    valid[2::13] = k
    valid[6::17] = w + 40
    for i, vl in ((10, 128 + k - 2), (12, 128 + k - 1), (14, 128 + k)):
        valid[i::19] = min(vl, w)
    valid[8::109] = w
    c = torch.from_numpy(codes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = kernels.SKETCH64.launches
    for s in (1, 16, 8, 128):
        got = S.sketch_windows(c, v, k, s)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64
        assert torch.equal(got, S.sketch_windows64_plain(c, v, k, s))
    assert kernels.SKETCH64.launches == before + 4
    odd = torch.cat([c[:, :1], c], dim=1)[:, 1:]
    assert odd.data_ptr() % 2 == 1
    assert torch.equal(S.sketch_windows(odd, v, k, 16),
                       S.sketch_windows64_plain(c, v, k, 16))
    if w <= 128:
        clean = np.where(codes < 4, codes, 2).astype(np.uint8)
        for nb in range(1, w // 4 + 1):
            pk = torch.from_numpy(pack_2bit(clean[:, :4 * nb])).to(cuda)
            for s in (1, 16, 128):
                got = S.sketch_windows_packed(pk, v, k, s)
                assert torch.equal(got, S.sketch_windows64_plain(
                    S.unpack_2bit(pk), v, k, s)), (nb, s)


def _alternate(key, r):
    """(B, L) keys as the probe emits them for alt_runs = r: sorted runs
    of r lanes, odd runs reversed."""
    b, l = key.shape
    runs = np.sort(key.reshape(b, l // r, r), axis=2)
    runs[:, 1::2] = runs[:, 1::2, ::-1]
    return np.ascontiguousarray(runs.reshape(b, l))


def _edge_slots(rng, l):
    """B3 rows of all padding, of one key repeated, and of keys at
    INT32_MIN, -1 and I32_MAX - 1 among random ones."""
    lim = np.array([-2**31, -1, I32_MAX - 1, 0, I32_MAX], np.int64)
    return np.stack([
        np.full(l, I32_MAX), np.full(l, 12345),
        rng.choice(lim, l),
        np.where(rng.random(l) < 0.2, rng.choice(lim, l),
                 rng.integers(-2**31, 2**31, l)),
        rng.integers(-2**31, 2**31, l)]).astype(np.int32)


SORT_CASES = [(1 << e, r) for e in range(7, 16)
              for r in (0, 1, 64, 256, 1 << e) if r <= 1 << e]


@pytest.mark.parametrize("mode", ["walk", "dedup"])
@pytest.mark.parametrize("l2,presorted", SORT_CASES)
def test_sort_and_candidates_kernels_match_plain(cuda, mode, l2, presorted):
    """B3 at every width from 128 to 32,768 lanes and every presorted
    form (0, 1, runs of 64 and 256, the whole row), with edge rows; B4
    on the same rows in both forms, sorting them itself (fused) and
    after B3 (split), and on rows that arrive sorted, walk 10 or dedup 6
    with mwir 0-7, K = 1-4."""
    rng = np.random.default_rng(11 + l2 + presorted)
    b = 256
    pk = np.concatenate([_slots(rng, b, l2, 40, 300, 10,
                                dup=mode == "dedup"), _edge_slots(rng, l2)])
    if presorted > 1:
        pk = _alternate(pk, presorted)
    p = torch.from_numpy(pk).to(cuda)
    before = kernels.SORT.launches
    srt = C.sort_packed(p, presorted)
    torch.cuda.synchronize()
    assert kernels.SORT.launches == before + 1
    assert torch.equal(srt, C.sort_packed_plain(p))
    walk, dwalk = (10, 0) if mode == "walk" else (0, 6)
    mw = torch.from_numpy(rng.integers(0, 8, len(pk)).astype(np.int32)
                          ).to(cuda)
    for kk in (1, 2, 3, 4):
        want = C.candidates_sorted_plain(srt, mw, 10, walk, dwalk, kk)
        for kw in ({}, {"split": True}, {"sorted_input": True}):
            sorts = kernels.SORT.launches
            cands = kernels.CANDIDATES.launches
            got = torch.stack(C.candidates_packed(
                srt if kw.get("sorted_input") else p, mw, 10,
                walk_elems=walk, dedup_walk=dwalk, max_candidates=kk,
                presorted=presorted, **kw), 2)
            torch.cuda.synchronize()
            assert torch.equal(got, want), kw
            assert kernels.SORT.launches == sorts + ("split" in kw)
            assert kernels.CANDIDATES.launches == cands + 1


WIDE_CASES = [(l2, r) for l2 in (1 << 16, 1 << 17, 1 << 18, 1 << 19)
              for r in (0, 256, l2)]


def _border_runs(tgt, win, l2):
    """Rows 0 and 1 of (tgt, win) (before any sort) made to cross tile
    borders once sorted: l2 / 2 + 4,000 lanes of one slot in row 0 (more
    than a tile of 32,768 packed slots or 16,384 pairs, beside 100 lanes
    of its target's neighbouring windows), and in row 1 one target at 6
    windows of l2 / 12 lanes each, which dedup 6 counts back over
    several tiles."""
    run, per = l2 // 2 + 4000, l2 // 12
    tgt[0, :run], win[0, :run] = 7, 5
    tgt[0, run:run + 100], win[0, run:run + 100] = 7, np.arange(100) % 9
    tgt[1, :6 * per], win[1, :6 * per] = 11, np.repeat(np.arange(6), per)
    return tgt, win


@pytest.mark.parametrize("mode", ["walk10", "dedup6"])
@pytest.mark.parametrize("l2,presorted", WIDE_CASES)
def test_wide_candidates_kernel_matches_plain(cuda, mode, l2, presorted):
    """B4's wide form on rows past one block: 65,536, 131,072 and 262,144
    lanes (the cluster route, 2, 4 and 8 tiles) and 524,288 (16 tiles,
    the merge passes), unsorted, in alternating runs of 256 and sorted
    (presorted = L2), walk 10 or dedup 6 with mwir 0-7, K = 1-4, with a
    run of one slot and one target's runs across tile borders; one
    launch a call."""
    rng = np.random.default_rng(17 + l2 + presorted)
    tgt = rng.integers(0, 3000, (8, l2))
    win = rng.integers(0, 900, (8, l2))
    if mode == "dedup6":
        d = rng.random((8, l2)) < 0.5
        tgt = np.where(d, np.roll(tgt, 1, 1), tgt)
        win = np.where(d, np.roll(win, 1, 1), win)
    tgt, win = _border_runs(tgt, win, l2)
    pk = (tgt << 11) | win
    n = rng.integers(0, l2 + 1, (8, 1))
    n[:2] = l2
    pk = np.where(np.arange(l2) < n, pk, I32_MAX).astype(np.int32)
    if presorted == l2:
        pk = np.sort(pk, axis=1)
    elif presorted:
        pk = _alternate(pk, presorted)
    p = torch.from_numpy(pk).to(cuda)
    walk, dwalk = (10, 0) if mode == "walk10" else (0, 6)
    mw = torch.from_numpy(rng.integers(0, 8, len(pk)).astype(np.int32)
                          ).to(cuda)
    for kk in (1, 2, 3, 4):
        want = C.candidates_sorted_plain(C.sort_packed_plain(p), mw, 11,
                                         walk, dwalk, kk)
        before = kernels.CANDIDATES_WIDE.launches
        got = torch.stack(C.candidates_packed(
            p, mw, 11, walk_elems=walk, dedup_walk=dwalk, max_candidates=kk,
            presorted=0 if presorted == l2 else presorted,
            sorted_input=presorted == l2), 2)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert kernels.CANDIDATES_WIDE.launches == before + 1


@pytest.mark.parametrize("l2,pairs", [(1 << 16, False), (1 << 18, False),
                                      (1 << 19, False), (1 << 15, True),
                                      (1 << 17, True), (1 << 18, True)])
def test_wide_route_allocates_by_shape(cuda, l2, pairs):
    """The wide form's route by shape: rows of up to 8 tiles take one
    cluster launch and the wrapper allocates nothing but the result
    (work space 0), wider rows the merge passes and their work space;
    the card can hold a cluster of 8 blocks of the cluster kernel."""
    route = C.wide_route(l2, pairs)
    assert route == ("cluster" if l2 <= (1 << 17 if pairs else 1 << 18)
                     else "passes")
    work = kernels.wide_work_bytes(4, l2, pairs, 2)
    assert (work == 0) == (route == "cluster")
    info = kernels.wide_cluster_info(pairs, 8)
    assert info["max_active_clusters"] > 0, info
    x = torch.full((4, l2), I32_MAX, dtype=torch.int32, device=cuda)
    x[:, :1000] = 5
    mw = torch.full((4,), 2, dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if pairs:
        got = C.candidates_unpacked(x, x, mw, dedup_walk=6)
    else:
        got = C.candidates_packed(x, mw, 11, dedup_walk=6)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    assert int(got[1][0, 0]) == 1000 and int(got[0][0, 1]) == -1
    assert (grew <= 512) if route == "cluster" else grew >= work


def test_wide_candidates_kernel_int64_keys(cuda):
    """Rows of 2^20 slots where one target holds 3,000 slots in range,
    so that hits * L2 passes 2^31: the wide forms' int64 keys equal the
    plain versions'."""
    l2 = 1 << 20
    rng = np.random.default_rng(23)
    tgt = rng.integers(0, 500, (2, l2))
    win = rng.integers(0, 900, (2, l2))
    tgt[:, :3000], win[:, :3000] = 7, rng.integers(40, 42, (2, 3000))
    pk = torch.from_numpy(((tgt << 11) | win).astype(np.int32)).to(cuda)
    mw = torch.full((2,), 4, dtype=torch.int32, device=cuda)
    want = C.candidates_sorted_plain(C.sort_packed_plain(pk), mw, 11, 0, 6, 2)
    got = torch.stack(C.candidates_packed(pk, mw, 11, dedup_walk=6,
                                          max_candidates=2), 2)
    assert torch.equal(got, want) and int(want[0, 0, 1]) >= 3000
    t = torch.from_numpy(tgt.astype(np.int32)).to(cuda)
    w = torch.from_numpy(win.astype(np.int32)).to(cuda)
    want = C.candidates_unpacked_plain(t, w, mw, 0, 6, 2)
    got = torch.stack(C.candidates_unpacked(t, w, mw, 0, 6, 2), 2)
    assert torch.equal(got, want) and int(want[0, 0, 1]) >= 3000


@pytest.mark.parametrize("l2,pairs", [(1 << 17, False), (1 << 19, False),
                                      (1 << 16, True), (1 << 18, True)])
def test_wide_form_takes_unaligned_rows(cuda, l2, pairs):
    """Rows that start 4 bytes past 16-byte alignment (views into a
    larger tensor) on both routes: the cluster kernel loads them one by
    one, and the result equals the plain version's."""
    rng = np.random.default_rng(29 + l2)
    b = 4

    def view(a):
        flat = torch.empty(b * l2 + 1, dtype=torch.int32, device=cuda)
        flat[1:] = torch.from_numpy(a.astype(np.int32)).to(cuda).view(-1)
        x = flat[1:].view(b, l2)
        assert x.data_ptr() % 16 == 4
        return x

    mw = torch.full((b,), 3, dtype=torch.int32, device=cuda)
    if pairs:
        t, w = (view(a) for a in _pair_rows(rng, b, l2))
        want = C.candidates_unpacked_plain(t, w, mw, 0, 6, 2)
        got = torch.stack(C.candidates_unpacked(t, w, mw, 0, 6, 2), 2)
    else:
        pk = view(_slots(rng, b, l2, 3000, 900, 11, dup=True))
        want = C.candidates_sorted_plain(C.sort_packed_plain(pk), mw, 11, 0,
                                         6, 2)
        got = torch.stack(C.candidates_packed(pk, mw, 11, dedup_walk=6,
                                              max_candidates=2), 2)
    assert torch.equal(got, want)


def _pair_rows(rng, b, l):
    """(tgt, win) rows past the packing bound (9217 targets, windows up
    to 71427), with windows near 0 and near I32_MAX, few targets at close
    windows (target boundaries inside a walk window), duplicate slots,
    and (I32_MAX, I32_MAX) padding at the end."""
    kind = (np.arange(b) % 4)[:, None]
    tgt = np.where(kind == 3, rng.integers(0, 6, (b, l)),
                   rng.integers(9000, 9217, (b, l)))
    win = np.select([kind == 1, kind == 2, kind == 3],
                    [rng.integers(0, 40, (b, l)),
                     I32_MAX - rng.integers(0, 40, (b, l)),
                     rng.integers(0, 10, (b, l))],
                    rng.integers(71300, 71428, (b, l)))
    d = rng.random((b, l)) < 0.3
    tgt = np.where(d, np.roll(tgt, 1, 1), tgt)
    win = np.where(d, np.roll(win, 1, 1), win)
    keep = np.arange(l) < rng.integers(0, l + 1, (b, 1))
    keep[1] = True
    return np.where(keep, tgt, I32_MAX), np.where(keep, win, I32_MAX)


UNPACKED_CASES = [(l2, r) for l2 in (128, 1024, 4096, 16384)
                  for r in (0, 1, 64, 256, l2) if r <= l2]


@pytest.mark.parametrize("mode", ["walk10", "walk32", "walk48", "dedup6"])
@pytest.mark.parametrize("l2,presorted", UNPACKED_CASES)
def test_unpacked_candidates_kernel_matches_plain(cuda, mode, l2, presorted):
    """B5 at the narrowest, a middle, the main path's and the widest row,
    each presorted form (0, 1, runs of 64 and 256, the whole row), walk
    10 (mwir 1-6), walk 32 and 48 and dedup 6 (mwir 0, 1, 2 and 7),
    K = 1-4."""
    rng = np.random.default_rng(13 + l2 + presorted)
    b = 256
    tgt, win = _pair_rows(rng, b, l2)
    if presorted > 1:
        key = _alternate(tgt << 32 | win, presorted)
        tgt, win = key >> 32, key & 0xFFFFFFFF
    t = torch.from_numpy(tgt.astype(np.int32)).to(cuda)
    w = torch.from_numpy(win.astype(np.int32)).to(cuda)
    walk, dwalk = (int(mode[4:]), 0) if mode.startswith("walk") else (0, 6)
    mwir = (rng.integers(1, 7, b) if walk == 10
            else rng.choice(np.array([0, 1, 2, 7]), b))
    mw = torch.from_numpy(mwir.astype(np.int32)).to(cuda)
    for kk in (1, 2, 3, 4):
        got = torch.stack(C.candidates_unpacked(
            t, w, mw, walk, dwalk, kk, presorted), 2)
        want = C.candidates_unpacked_plain(t, w, mw, walk, dwalk, kk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["walk32", "dedup6"])
@pytest.mark.parametrize("l2,presorted", [(1 << 15, 0), (1 << 15, 256),
                                          (1 << 16, 256), (1 << 16, 1 << 16),
                                          (1 << 17, 256), (1 << 18, 256)])
def test_wide_unpacked_candidates_kernel_matches_plain(cuda, mode, l2,
                                                       presorted):
    """B5's wide form on rows past one block: 32,768, 65,536 and 131,072
    pairs (the cluster route, 2, 4 and 8 tiles) and 262,144 (16 tiles,
    the merge passes), unsorted, in alternating runs of 256 and sorted
    (presorted = L2), walk 32 or dedup 6 with mwir 0, 1, 2 and 7,
    K = 1-4, with a run of one slot and one target's runs across tile
    borders; one launch a call."""
    rng = np.random.default_rng(19 + l2 + presorted)
    tgt, win = _border_runs(*_pair_rows(rng, 8, l2), l2)
    if presorted:
        key = _alternate(tgt << 32 | win, presorted)
        tgt, win = key >> 32, key & 0xFFFFFFFF
    t = torch.from_numpy(tgt.astype(np.int32)).to(cuda)
    w = torch.from_numpy(win.astype(np.int32)).to(cuda)
    walk, dwalk = (32, 0) if mode == "walk32" else (0, 6)
    mw = torch.from_numpy(rng.choice(np.array([0, 1, 2, 7]), 8).astype(
        np.int32)).to(cuda)
    for kk in (1, 2, 3, 4):
        before = kernels.CANDIDATES_UNPACKED_WIDE.launches
        got = torch.stack(C.candidates_unpacked(
            t, w, mw, walk, dwalk, kk, presorted), 2)
        want = C.candidates_unpacked_plain(t, w, mw, walk, dwalk, kk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert kernels.CANDIDATES_UNPACKED_WIDE.launches == before + 1


@pytest.mark.parametrize("packing,split", [(None, None), (None, "0"),
                                           (None, "1"), ("0", None)])
def test_fixture_query_on_the_card_matches_golden(cuda, tmp_path,
                                                  monkeypatch, packing,
                                                  split):
    """The golden through B1 and B4 (packed slots; B4 sorts the rows
    itself, under MC_SPLIT_CAND=1 after B3), or through B1 and B5 under
    MC_PACK_SLOTS=0: so both routes give the same lines."""
    from metacache_tpu_torch.ops.rows import split_candidates
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    if split is None:
        monkeypatch.delenv("MC_SPLIT_CAND", raising=False)
    else:
        monkeypatch.setenv("MC_SPLIT_CAND", split)
    if packing is None:
        monkeypatch.delenv("MC_PACK_SLOTS", raising=False)
        path = ("sketch", "sort", "candidates") if split_candidates() \
            else ("sketch", "candidates")
    else:
        monkeypatch.setenv("MC_PACK_SLOTS", packing)
        path = ("sketch", "candidates_unpacked")
    db = str(tmp_path / "db")
    kernels.reset_counts()
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["query", db, f"{DATA}/reads_single.fa"]) == 0
    assert min(kernels.ALL[k].launches for k in path) > 0
    assert kernels.SORT.launches == 0 or "sort" in path
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")

    def strip(text):
        return [l for l in text.splitlines()
                if not any(d in l for d in drop)]
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        assert strip(buf.getvalue()) == strip(f.read())


def _card_query(db, args):
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(["query", db] + args) == 0
    return [l for l in buf.getvalue().splitlines()
            if not any(d in l for d in drop)]


def _golden(name):
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    with open(os.path.join(DATA, "golden", name)) as f:
        return [l for l in f.read().splitlines()
                if not any(d in l for d in drop)]


def test_fixture_k18_on_the_card_matches_golden(cuda, tmp_path,
                                                monkeypatch):
    """A k = 18 database (64-bit features) built and queried on the card:
    the 64-bit sketch kernel on coded windows, on the summary path's
    packed rows and in the build; the reference's k18 goldens, and the
    -no-map summary equal to the per-read one."""
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    db = str(tmp_path / "db18")
    kernels.reset_counts()
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy", "-kmerlen", "18"]) == 0
    assert kernels.SKETCH64.launches > 0 and kernels.SKETCH.launches == 0
    for gold, args in (
            ("k18_single.txt", ["reads_single.fa", "-mapped-only",
                                "-precision", "-ground-truth", "-tophits"]),
            ("k18_long.txt", ["reads_long.fa", "-precision",
                              "-ground-truth", "-tophits"]),
            ("k18_pairfiles.txt", ["reads_pair1.fa", "reads_pair2.fa",
                                   "-pairfiles", "-precision",
                                   "-tophits"])):
        args = [f"{DATA}/{a}" if a.startswith("reads_") else a for a in args]
        assert _card_query(db, args) == _golden(gold), gold

    def stats(lines):
        i = next(j for j, l in enumerate(lines) if "queries:" in l)
        return lines[i:]
    before = kernels.SKETCH64.launches
    summary = _card_query(db, [f"{DATA}/reads_single.fa", "-no-map"])
    assert kernels.SKETCH64.launches > before
    assert stats(summary) == stats(_card_query(
        db, [f"{DATA}/reads_single.fa"]))


def _split_on_the_card(tmp_path, monkeypatch, flags):
    """The fixture's reads with ``flags`` (the non-fused result path) in
    one launch, then with free memory for 8 rows a launch: -> (the lines
    of both, the second query's launches)."""
    from metacache_tpu_torch.classify import runner as R
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    launches = []
    real = R.QueryRunner._launch_rows

    def spy(self, *a, **k):
        before = self.row_launches
        out = real(self, *a, **k)
        launches.append(self.row_launches - before)
        return out
    monkeypatch.setattr(R.QueryRunner, "_launch_rows", spy)
    args = [f"{DATA}/reads_single.fa"] + flags
    whole = _card_query(db, args)
    assert launches == [1]
    # 8 rows a launch: the fixture's rows of 32 slots sweep by the rank
    # join
    row_b = R.nonfused_row_bytes(32, "rank-join", "-allhits" in flags)
    monkeypatch.setattr(R, "free_bytes", lambda device: 8 * row_b)
    launches.clear()
    return whole, _card_query(db, args), launches


def test_nonfused_batch_split_on_the_card(cuda, tmp_path, monkeypatch):
    """A -lowest species batch (the non-fused result path) with free
    memory for 8 rows a launch, on the card: at least 2 launches, the
    lines of the batch in one launch."""
    whole, split, launches = _split_on_the_card(tmp_path, monkeypatch,
                                                ["-lowest", "species"])
    assert split == whole == _golden("fmt_14.txt")
    assert launches[0] >= 2


def test_nonfused_allhits_split_on_the_card(cuda, tmp_path, monkeypatch):
    """-allhits -tophits in launches of at most 8 rows on the card, each
    launch's per-hit lists moved to the host as it ends: at least 2
    launches, the lines (every hit included) of one launch."""
    whole, split, launches = _split_on_the_card(tmp_path, monkeypatch,
                                                ["-allhits", "-tophits"])
    assert split == whole and launches[0] >= 2


@pytest.mark.parametrize("setting", [None, "sort", "extract"])
def test_fixture_query_sketch_modes_match_golden(cuda, tmp_path,
                                                 monkeypatch, setting):
    """test_fixture_query_on_the_card_matches_golden's default route
    under MC_SKETCH_MODE unset, "sort" and "extract" (JAX's two forms,
    which change nothing in the port) gives the golden lines."""
    if setting is None:
        monkeypatch.delenv("MC_SKETCH_MODE", raising=False)
    else:
        monkeypatch.setenv("MC_SKETCH_MODE", setting)
    test_fixture_query_on_the_card_matches_golden(cuda, tmp_path,
                                                  monkeypatch, None, None)


def test_winlen_255_on_the_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """`build -winlen 255` and its per-read and -no-map queries of 250 bp
    reads on the card (B2 at W = 255 and 256) equal the same run on the
    CPU (B2's plain version)."""
    from metacache_tpu_torch.db.database import Database
    rng = np.random.default_rng(17)
    seqs = [l.strip() for l in open(f"{DATA}/genomes.fa")
            if not l.startswith(">")]
    genome = "".join(seqs)
    reads = tmp_path / "r.fa"
    with open(reads, "w") as f:
        for i in range(2000):
            p = int(rng.integers(0, len(genome) - 250))
            f.write(f">q{i}\n{genome[p:p + 250]}\n")
    drop = ("# time:", "# speed:", "threads", DATA, str(tmp_path))
    out = {}
    for dev in ("cuda", "cpu"):
        if dev == "cpu":
            monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")
        else:
            monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
        db = str(tmp_path / f"db_{dev}")
        kernels.reset_counts()
        assert main(["build", db, f"{DATA}/genomes.fa", "-winlen", "255",
                     "-taxonomy", f"{DATA}/taxonomy"]) == 0
        built = kernels.SKETCH_LONG.launches
        texts = []
        for args in ([], ["-no-map"]):
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert main(["query", db, str(reads)] + args) == 0
            texts.append([l for l in buf.getvalue().splitlines()
                          if not any(d in l for d in drop)])
        out[dev] = (Database.load(db).parts[0].locations, texts,
                    built, kernels.SKETCH_LONG.launches - built,
                    kernels.SKETCH.launches)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1]
    # build and queries through B2 only on the card, no kernel on the CPU
    assert min(out["cuda"][2:4]) > 0
    assert out["cuda"][4] == 0
    assert out["cpu"][2:] == (0, 0, 0)


def _two_tier_case(rng, nf=4000, n=4096, hsl=61, spf=254):
    """Head rows with counts 1..spf (the layout of
    tests/test_probe_pallas.py), overflow rows, and probes with misses,
    sentinels and indices past the table."""
    feats = (np.sort(rng.choice(2**31 - 2, nf, replace=False)) + 1)
    cnts = rng.integers(1, spf + 1, nf)
    head = np.zeros((nf, 64), np.int32)
    head[:, 0] = feats
    head[:, 1] = cnts
    novf = int((cnts > hsl).sum())
    head[cnts > hsl, 2] = np.arange(1, novf + 1)
    head[:, 3:] = rng.integers(0, 2**30, (nf, 61))
    ovf = np.zeros((novf + 1, 200), np.int32)
    ovf[1:, :spf - hsl] = rng.integers(0, 2**30, (novf, spf - hsl))
    idx = rng.integers(0, nf, n)
    flat = feats[idx]
    miss = rng.random(n) < 0.3
    flat[miss] = rng.integers(1, 2**31 - 1, int(miss.sum()))
    flat[::97] = -1
    idx[::101] = nf + 5
    return [torch.from_numpy(a.astype(np.int32)) for a in
            (head, ovf, idx, flat)]


@pytest.mark.parametrize("f", [16, 1])
@pytest.mark.parametrize("rl", [64, 256])
def test_head_decode_kernel_matches_plain(cuda, rl, f):
    head, _ovf, idx, flat = (t.to(cuda) for t in
                             _two_tier_case(np.random.default_rng(21)))
    pk, cnt = D.head_decode(head, idx, flat, 61, rl, f)
    want_pk, want_cnt = D.head_decode_plain(head, idx, flat, 61, rl, f)
    torch.cuda.synchronize()
    assert torch.equal(pk, want_pk) and torch.equal(cnt, want_cnt)
    assert bool((cnt > 61).any()) and bool((cnt == 0).any())


@pytest.mark.parametrize("f", [16, 1])
@pytest.mark.parametrize("rl", [64, 128, 256])
def test_head_decode_kernel_layouts_match_plain(cuda, rl, f):
    """B6 on n % 32 != 0 probes, through its 16-byte path and, on a head
    view that is not 16-byte aligned and on heads 63 lanes wide, through
    its 4-byte path; hsl 61 and 30."""
    head, _ovf, idx, flat = (t.to(cuda) for t in _two_tier_case(
        np.random.default_rng(23 + rl), n=4096 + 17))
    flat_head = torch.cat([head.new_zeros(1), head.reshape(-1)])
    shifted = flat_head[1:].view(head.shape)
    assert shifted.data_ptr() % 16 == 4
    for h, hsl in ((head, 61), (shifted, 61), (head[:, :63], 60),
                   (head, 30)):
        before = kernels.HEAD_DECODE.launches
        pk, cnt = D.head_decode(h, idx, flat, hsl, rl, f)
        want_pk, want_cnt = D.head_decode_plain(h, idx, flat, hsl, rl, f)
        torch.cuda.synchronize()
        assert kernels.HEAD_DECODE.launches == before + 1
        assert torch.equal(pk, want_pk) and torch.equal(cnt, want_cnt)


@pytest.mark.parametrize("f", [16, 1])
@pytest.mark.parametrize("rl", [256, 512])
def test_full_decode_kernel_matches_plain(cuda, rl, f):
    head, ovf, idx, flat = (t.to(cuda) for t in
                            _two_tier_case(np.random.default_rng(22)))
    got = D.full_decode(head, ovf, idx, flat, 61, 254, rl, f)
    want = D.full_decode_plain(head, ovf, idx, flat, 61, 254, rl, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def _csr_case(rng, nf=3000, n=4096 + 17, deep=300):
    """A CSR of nf features with 0..deep locations each (targets below
    2^16, windows below 2^15), and probes: row ids with some past the
    table, found flags with misses."""
    cnt = rng.integers(0, deep + 1, nf)
    offs = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    ltgt = rng.integers(0, 1 << 16, int(offs[-1])).astype(np.int32)
    lwin = rng.integers(0, 1 << 15, int(offs[-1])).astype(np.int32)
    idx = rng.integers(0, nf, n).astype(np.int32)
    idx[::101] = nf + 5
    found = rng.random(n) < 0.8
    return [torch.from_numpy(a) for a in (idx, found, offs, ltgt, lwin)]


@pytest.mark.parametrize("pack_bits", [15, 0])
@pytest.mark.parametrize("rl,f", [(254, 1), (256, 16), (512, 32)])
def test_csr_decode_kernel_matches_plain(cuda, rl, f, pack_bits):
    """csr_decode in both output forms (pk, or tgt and win), with the
    alternating runs off (rl = c, f = 1) and on (odd features' runs
    reversed), buckets deeper than c = 254."""
    args = [t.to(cuda) for t in _csr_case(np.random.default_rng(rl + f))]
    before = kernels.CSR_DECODE.launches
    got = D.csr_decode(*args, 254, rl, f, pack_bits)
    want = D.csr_decode_plain(*args, 254, rl, f, pack_bits)
    torch.cuda.synchronize()
    assert kernels.CSR_DECODE.launches == before + 1
    assert len(got) == len(want) == (1 if pack_bits else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0] == I32_MAX).any()) and bool((got[0] != I32_MAX).any())


def test_csr_decode_kernel_on_an_empty_part(cuda):
    """No feature and no location (an empty u64 part): every lane pads."""
    idx = torch.zeros(40, dtype=torch.int32, device=cuda)
    found = torch.ones(40, dtype=torch.bool, device=cuda)
    offs = torch.zeros(1, dtype=torch.int64, device=cuda)
    loc = torch.zeros(0, dtype=torch.int32, device=cuda)
    for pb in (15, 0):
        for out in D.csr_decode(idx, found, offs, loc, loc, 3, 4, 2, pb):
            assert bool((out == I32_MAX).all())


# ------------------------------------------ dense_decode's row layouts
# name -> (c, head slots (0: dense), u64 features, slots stored as one pk
# lane (else tgt lanes then win lanes), 64-lane rows pair-packed, a power
# of two >= c for the alternating runs)
DENSE_LAYOUTS = {
    "pk_dense": (100, 0, False, True, False, 128),
    "pk_dense_paired": (50, 0, False, True, True, 64),
    "lanes_dense": (30, 0, False, False, False, 32),
    "lanes_two_tier": (40, 10, False, False, False, 64),
    "u64_dense": (60, 0, True, True, False, 64),
    "u64_two_tier": (100, 20, True, True, False, 128),
}
DENSE_SLOT_BITS = 18


def dense_pack_cases():
    """(layout, pack_bits) pairs: a stored pk re-encoded to its own
    width, another width and (tgt, win); stored lanes to (tgt, win) and
    packed."""
    return [(name, pb) for name, lay in DENSE_LAYOUTS.items()
            for pb in ((DENSE_SLOT_BITS, DENSE_SLOT_BITS + 2, 0) if lay[3]
                       else (0, DENSE_SLOT_BITS + 2))]


def dense_case(layout, f, seed=5, nf=500, n=384):
    """Rows of ``layout`` (DENSE_LAYOUTS) over nf distinct features and
    n probes of their rows, n / f reads of f features. Counts 0..c, with
    count 0, count = c and counts past c among them; slot lanes past the
    count hold garbage; two-tier heads past the head point at overflow
    rows (one past the overflow table); one row holds the sentinel. Probes: hits, misses,
    the sentinel (also at the sentinel's row), row indices past the
    table (odd ones on pair-packed rows, where JAX clamps the 128-lane
    row and then takes a half, so both clamps meet only there) and, for
    u64 features, the row's low 32 bits with other high bits. -> dict of
    numpy arrays: rows (F, W) int32 (pair-packed: W = 64), ovf or None,
    feats (n / f, f) uint32 or uint64, idx (n,) int32, and the shape."""
    c, hsl, wide, pk, paired, alt = DENSE_LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    sb = DENSE_SLOT_BITS
    nl = 1 if pk else 2
    nm = 2 if wide else 1
    hs = hsl or c
    w = 64 if paired else nm + (2 if hsl else 1) + nl * hs + 3
    assert nm + (2 if hsl else 1) + nl * hs <= w
    dt = np.uint64 if wide else np.uint32
    top = 2**64 - 2 if wide else 2**32 - 2
    feats = np.unique(rng.integers(1, top, nf + 50, dtype=dt))[:nf]
    feats = rng.permutation(feats)
    feats[7] = np.iinfo(dt).max                   # the sentinel's row
    cnt = rng.integers(0, c + 1, nf)
    cnt[:20] = 0
    cnt[20:40] = c
    cnt[40:50] = c + 7
    tgt = rng.integers(0, 1 << (29 - sb), (nf, w))
    win = rng.integers(0, 1 << sb, (nf, w))
    rows = ((tgt << sb) | win) if pk else np.where(rng.random((nf, w)) < 0.5,
                                                   tgt, win)
    rows = rows.astype(np.int64).astype(np.int32)
    fv = feats.view(np.int64 if wide else np.int32)
    if wide:
        rows[:, 0] = (fv & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
        rows[:, 1] = (fv >> 32).astype(np.int32)
    else:
        rows[:, 0] = fv
    rows[:, nm] = cnt
    ovf = None
    if hsl:
        deep = np.flatnonzero(cnt > hsl)
        rows[:, nm + 1] = 0
        rows[deep, nm + 1] = np.arange(1, len(deep) + 1)
        rows[deep[0], nm + 1] = len(deep) + 9     # past the overflow rows
        ow = nl * (c - hsl) + 5
        ot = rng.integers(0, 1 << (29 - sb), (len(deep) + 1, ow))
        owin = rng.integers(0, 1 << sb, (len(deep) + 1, ow))
        ovf = (((ot << sb) | owin) if pk else
               np.where(rng.random(ot.shape) < 0.5, ot, owin)).astype(
                   np.int64).astype(np.int32)
    idx = rng.integers(0, nf, n)
    flat = feats[idx]
    u = rng.random(n)
    miss = u < 0.15
    flat[miss] = rng.integers(1, top, int(miss.sum()), dtype=dt)
    flat[(u >= 0.15) & (u < 0.2)] = np.iinfo(dt).max
    flat[3] = np.iinfo(dt).max
    idx[3] = 7
    past = (u >= 0.2) & (u < 0.3)
    k = rng.integers(0, 40, int(past.sum()))
    idx[past] = nf + (2 * k + 1 if paired else k)
    flat[past] = np.where(k % 2 == 0, feats[nf - 1], flat[past])
    if wide:
        hi = (u >= 0.3) & (u < 0.4)
        flat[hi] ^= np.uint64(1) << rng.integers(32, 64, int(hi.sum()),
                                                 dtype=np.uint64)
    return dict(rows=rows, ovf=ovf, feats=flat.reshape(-1, f),
                idx=idx.astype(np.int32), c=c, hsl=hsl, wide=wide, pk=pk,
                paired=paired, alt=alt, sb=sb if pk else 0)


def dense_tables(case, dev):
    """The port's DeviceTables over ``dense_case``'s rows on ``dev``."""
    from metacache_tpu_torch.db.state import DeviceTables
    d = case
    ovf = None if d["ovf"] is None else torch.from_numpy(d["ovf"]).to(dev)
    return DeviceTables(
        torch.from_numpy(d["rows"]).to(dev),
        torch.zeros((1, 64), dtype=torch.int32, device=dev),
        torch.zeros((1, 21), dtype=torch.int32, device=dev),
        torch.zeros(1, dtype=torch.int32, device=dev),
        num_features=d["rows"].shape[0], bucket_bits=1, spf=d["c"],
        slot_bits=d["sb"], ovf_rows=ovf, head_slots=d["hsl"],
        packed=d["paired"], wide=d["wide"])


def dense_feats(case, dev) -> torch.Tensor:
    """``dense_case``'s features as the port's int32 or int64 bit
    patterns."""
    x = case["feats"]
    return torch.from_numpy(x.view(np.int64 if case["wide"] else np.int32)
                            ).to(dev)


@pytest.mark.parametrize("f", [1, 16])
@pytest.mark.parametrize("alt", [False, True])
@pytest.mark.parametrize("layout,pack_bits", dense_pack_cases())
def test_dense_decode_kernel_matches_plain(cuda, layout, pack_bits, alt, f):
    """dense_decode on each row layout and output encoding, alternating
    runs off (rl = c, f = 1) and on, against its plain version on the
    same CUDA tensors; and probe_rows on the card, through the kernel,
    against probe_rows on CPU tensors."""
    from metacache_tpu_torch.ops import rows as trows
    d = dense_case(layout, f)
    c, hsl = d["c"], d["hsl"]
    rl, fr = (d["alt"], f) if alt else (c, 1)
    t = dense_tables(d, cuda)
    flat = dense_feats(d, cuda).reshape(-1)
    idx = torch.from_numpy(d["idx"]).to(cuda)
    args = (t.fused_rows, t.ovf_rows if hsl else None, idx, flat, hsl, c,
            rl, fr, d["sb"], pack_bits)
    before = kernels.DENSE_DECODE.launches
    got = D.dense_decode(*args)
    want = D.dense_decode_plain(*args)
    torch.cuda.synchronize()
    assert kernels.DENSE_DECODE.launches == before + 1
    assert len(got) == len(want) == (1 if pack_bits else 2)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0] == I32_MAX).any()) and bool((got[0] != I32_MAX).any())
    alt_runs = d["alt"] if alt else 0
    on_card = trows.probe_rows(dense_feats(d, cuda), t, alt_runs=alt_runs,
                               pack_bits=pack_bits, idx_pre=idx)
    on_cpu = trows.probe_rows(dense_feats(d, "cpu"),
                              dense_tables(d, "cpu"), alt_runs=alt_runs,
                              pack_bits=pack_bits, idx_pre=idx.cpu())
    assert kernels.DENSE_DECODE.launches == before + 2
    for g, w in zip(on_card, on_cpu):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("k", ["16", "18"])
def test_fixture_csr_on_the_card_matches_golden(cuda, tmp_path, monkeypatch,
                                                k):
    """The fixture's database staged as CSR (MC_DEVICE_LAYOUT=0 and the
    budget of the CSR bytes at k = 16, MC_DEVICE_LAYOUT=0 at k = 18)
    through csr_decode, per read (and at k = 16 as a summary): the
    goldens."""
    from metacache_tpu_torch.classify import runner as R
    from metacache_tpu_torch.db.database import Database
    from metacache_tpu_torch.ops.probe import make_bucket_index
    from metacache_tpu_torch.ops.table import csr_bytes
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy", "-kmerlen", k]) == 0
    monkeypatch.setenv("MC_DEVICE_LAYOUT", "0")
    if k == "16":
        p = Database.load(db).parts[0]
        need = csr_bytes(p, make_bucket_index(p.unique_features)[0].nbytes)
        monkeypatch.setattr(R, "hbm_budget_bytes", lambda device: need)
    gold, args = ("fmt_0.txt", []) if k == "16" else \
        ("k18_single.txt", ["-mapped-only", "-precision", "-ground-truth",
                            "-tophits"])
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")

    def run(extra):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["query", db, f"{DATA}/reads_single.fa"] + args +
                        extra) == 0
        return [l for l in buf.getvalue().splitlines()
                if not any(d in l for d in drop)]
    with open(os.path.join(DATA, "golden", gold)) as f:
        want = [l for l in f.read().splitlines()
                if not any(d in l for d in drop)]
    kernels.reset_counts()
    assert run([]) == want
    assert kernels.CSR_DECODE.launches > 0
    if k == "16":
        i = next(j for j, l in enumerate(want) if "queries:" in l)
        assert run(["-no-map"])[-len(want[i:]):] == want[i:]


def test_fixture_two_tier_on_the_card_matches_golden(cuda, tmp_path,
                                                     monkeypatch):
    """MC_DENSE_LIMIT=1 stages the fixture two-tier (head 1 of 2 slots):
    the per-read golden through B7, and the -no-map summary through
    phase 1 (B6) and the redo, escalation forced on by lowering its slot
    threshold."""
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    monkeypatch.delenv("MC_PACK_SLOTS", raising=False)
    monkeypatch.setenv("MC_DENSE_LIMIT", "1")
    monkeypatch.setenv("MC_CLASSED", "0")     # else the classed cells
    monkeypatch.setattr(QueryRunner, "FUSED_MIN_SLOTS", 0)
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")

    def query(args):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(["query", db, f"{DATA}/reads_single.fa"] + args) == 0
        return [l for l in buf.getvalue().splitlines()
                if not any(d in l for d in drop)]
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        gold = [l for l in f.read().splitlines()
                if not any(d in l for d in drop)]
    kernels.reset_counts()
    assert query([]) == gold
    assert kernels.FULL_DECODE.launches > 0
    kernels.reset_counts()
    summary = query(["-no-map"])
    i = next(j for j, l in enumerate(gold) if "queries:" in l)
    assert summary[-len(gold[i:]):] == gold[i:]
    assert kernels.HEAD_DECODE.launches > 0


def test_oidx_decode_kernel_matches_plain(cuda):
    head, ovf, idx, flat = (t.to(cuda) for t in
                            _two_tier_case(np.random.default_rng(23)))
    got = D.oidx_decode(head, idx, flat)
    want = D.oidx_decode_plain(head, idx, flat)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and bool((got > 0).any())
    full = D.full_decode(head, ovf, idx, flat, 61, 254, 256, 16, got)
    assert torch.equal(full, D.full_decode_plain(head, ovf, idx, flat, 61,
                                                 254, 256, 16))


def _oidx_views(cuda, layout, n):
    """B8's inputs on the card in one of its layouts -> (head, idx,
    flat): the 64-lane rows; heads 63, 3 and 65 lanes wide; idx and flat
    views 1 and 3 ints past the 16-byte grid."""
    head, _ovf, _idx, _flat = (t.to(cuda) for t in _two_tier_case(
        np.random.default_rng(41 + n), n=n + 3))
    idx, flat = _idx[:n], _flat[:n]
    if layout in ("w63", "w3", "w65"):
        w = int(layout[1:])
        head = torch.cat([head, head[:, 3:4]], dim=1)[:, :w].contiguous()
    elif layout == "views":
        idx = torch.empty(n + 4, dtype=torch.int32, device=cuda)[1:n + 1]
        flat = torch.empty(n + 4, dtype=torch.int32, device=cuda)[3:n + 3]
        idx.copy_(_idx[:n])
        flat.copy_(_flat[:n])
        assert n == 0 or (idx.data_ptr() % 16 == 4 and
                          flat.data_ptr() % 16 == 12)
    return head, idx, flat


@pytest.mark.parametrize("n", [0, 1, 3, 5, 4099, 4096 + 17, 131072 + 2])
@pytest.mark.parametrize("layout", ["w64", "w63", "w3", "w65", "views"])
def test_oidx_decode_layouts_match_plain(cuda, layout, n):
    """B8 bit-equal to its plain version on the 64-lane rows and on
    widths 63, 3 and 65, on idx and flat views off the 16-byte grid, on
    counts that fill no whole block and on none; one launch a call with
    probes, none without."""
    head, idx, flat = _oidx_views(cuda, layout, n)
    before = kernels.OIDX_DECODE.launches
    got = D.oidx_decode(head, idx, flat)
    want = D.oidx_decode_plain(head, idx, flat)
    torch.cuda.synchronize()
    assert kernels.OIDX_DECODE.launches == before + (n > 0)
    assert got.shape == (n,) and torch.equal(got, want)
    if n > 1000:
        assert bool((got > 0).any()) and bool((got == 0).any())


def test_oidx_decode_in_a_cuda_graph(cuda):
    """B8, a programmatic dependent launch, captured in one CUDA graph
    right after the kernel that rewrites its indices on every replay:
    the next rows (no feature found) on odd replays, the rows of the
    features on even ones, so an index read before that kernel ends
    gives another result. Each replay equals the plain version on that
    replay's indices."""
    head, _ovf, base, _ = (t.to(cuda) for t in _two_tier_case(
        np.random.default_rng(47), n=1 << 20))
    nf = head.shape[0]
    base = torch.clamp(base, 0, nf - 1)
    flat = head[base.long(), 0].clone()
    parity = torch.zeros((), dtype=torch.int32, device=cuda)
    idx = torch.empty_like(base)
    D.oidx_decode(head, base, flat)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        parity.bitwise_xor_(1)
        torch.remainder(base + parity, nf, out=idx)
        oidx = D.oidx_decode(head, idx, flat)
    for replay in range(1, 7):
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(idx, torch.remainder(base + replay % 2, nf))
        want = D.oidx_decode_plain(head, idx, flat)
        assert torch.equal(oidx, want)
        assert bool(want.any()) == (replay % 2 == 0)


@pytest.mark.parametrize("rl", [256, 512])
def test_full_decode_takes_over_oidx_decode_on_the_card(cuda, rl):
    """B8 folded into B7 on the card: B7 without oidx equals B8 then B7
    and the plain version, bit for bit, on pair-packed heads."""
    head, ovf, idx, flat = (t.to(cuda) for t in
                            _two_tier_case(np.random.default_rng(29)))
    alone = D.full_decode(head, ovf, idx, flat, 61, 254, rl, 16)
    chained = D.full_decode(head, ovf, idx, flat, 61, 254, rl, 16,
                            D.oidx_decode(head, idx, flat))
    torch.cuda.synchronize()
    assert torch.equal(alone, chained)
    assert torch.equal(alone.cpu(), D.full_decode_plain(
        head.cpu(), ovf.cpu(), idx.cpu(), flat.cpu(), 61, 254, rl, 16))


def _device_table(dev, budget=1 << 40, n=60_000):
    from metacache_tpu_torch.ops import table_device as T
    rng = np.random.default_rng(31)
    pool = rng.integers(0, 2**32, 4000, dtype=np.uint64)
    f = pool[np.minimum(rng.zipf(1.3, n), 4000) - 1].astype(np.uint32)
    f[::50] = 0xFFFFFFFF
    t = np.repeat(np.arange(n // 500, dtype=np.int32), 500)
    w = np.tile(np.arange(500, dtype=np.int32), n // 500)
    arrs = [torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                             else a).to(dev) for a in (f, t, w)]
    return T.build_device_table_chunked(
        [tuple(x[i:i + 7000] for x in arrs) for i in range(0, n, 7000)],
        cap=254, budget_bytes=budget, gbits=2)


def test_bucket_decode_kernel_matches_plain(cuda):
    dt = _device_table(cuda)
    rng = np.random.default_rng(24)
    flat = dt.uniq[torch.from_numpy(rng.integers(0, dt.nf, 8192)).to(cuda)]
    miss = torch.from_numpy(rng.random(8192) < 0.3).to(cuda)
    flat = torch.where(miss, flat ^ 0x5A5A5, flat)
    flat[::97] = -1
    idx, found = D.bucket_decode(dt.brows, flat, dt.bbits)
    widx, wfound = D.bucket_decode_plain(dt.brows, flat, dt.bbits)
    torch.cuda.synchronize()
    assert torch.equal(idx, widx) and torch.equal(found, wfound)
    assert bool(found.any()) and not bool(found.all())


# ------------------------------------- the bucket probe (B9) and classed
# widths of a bucket-row index: "pair" = 64-lane rows pair-packed two a
# 128-lane row (the device builder's), else the host's 64, 65 or 1 + 2^k
BUCKET_WIDTHS = ("pair", 64, 65, 129)


def bucket_case(width, wide=False, seed=3, nf=3000, n=4096 + 17, bits=10):
    """A bucket-row index of 2^bits logical rows [start, features (u64:
    their low 32 bits)..., -1 pads] of ``width`` lanes over about nf
    random features: bucket 5 at full span (every lane holds a feature),
    the last bucket (the sentinel's) partly filled; and n probes:
    present features, features of the full and of the last bucket,
    misses in real buckets (a low bit flipped), random values and
    sentinels. -> dict(brows (2^bits, W) int32, or (2^(bits-1), 128) for
    "pair", bits, flat (n,) uint32 or uint64, nf)."""
    rng = np.random.default_rng(seed)
    lanes = 64 if width == "pair" else width
    dt = np.uint64 if wide else np.uint32
    tb = 64 if wide else 32
    shift = dt(tb - bits)
    top = 2**64 - 2 if wide else 2**32 - 2
    feats = rng.integers(0, top, nf, dtype=dt)
    low = rng.choice(2**min(31, tb - bits), lanes + 2,
                     replace=False).astype(dt)
    full = (dt(5) << shift) | low[:lanes - 1]
    last = (dt((1 << bits) - 1) << shift) | low[lanes - 1:lanes + 2]
    feats = np.unique(np.concatenate([feats[(feats >> shift) != 5], full,
                                      last]))
    feats = feats[feats != np.iinfo(dt).max]
    h = (feats >> shift).astype(np.int64)
    if wide:        # distinct low 32 bits within a bucket
        lo = feats & dt(0xFFFFFFFF)
        o = np.lexsort((lo, h))
        dup = np.zeros(len(feats), bool)
        dup[o[1:]] = (h[o][1:] == h[o][:-1]) & (lo[o][1:] == lo[o][:-1])
        feats, h = feats[~dup], h[~dup]
    starts = np.searchsorted(h, np.arange(1 << bits))
    col = np.arange(len(feats)) - starts[h]
    assert col.max() == lanes - 2 and (col[h == 5] >= 0).sum() == lanes - 1
    rows = np.full((1 << bits, lanes), -1, np.int32)
    rows[:, 0] = starts
    rows[h, 1 + col] = (feats & dt(0xFFFFFFFF)).astype(np.uint32).view(
        np.int32)
    if width == "pair":
        rows = rows.reshape(-1, 128)
    flat = feats[rng.integers(0, len(feats), n)]
    u = rng.random(n)
    flat[u < 0.15] = full[rng.integers(0, lanes - 1, int((u < 0.15).sum()))]
    sel = (u >= 0.15) & (u < 0.2)
    flat[sel] = last[rng.integers(0, 3, int(sel.sum()))]
    sel = (u >= 0.2) & (u < 0.4)
    flat[sel] ^= dt(0x10)
    sel = (u >= 0.4) & (u < 0.5)
    flat[sel] = rng.integers(0, top, int(sel.sum()), dtype=dt)
    flat[(u >= 0.5) & (u < 0.52)] = np.iinfo(dt).max
    flat[:3] = np.iinfo(dt).max
    return dict(brows=rows, bits=bits, flat=flat, nf=len(feats))


def bucket_flat(case) -> torch.Tensor:
    """bucket_case's probes as the port's int32 / int64 bit patterns."""
    f = case["flat"]
    return torch.from_numpy(f.view(np.int64 if f.dtype == np.uint64
                                   else np.int32).copy())


# depths of the classed case's features: each side of the class ladder's
# 13, 29 and 61 slots, and past the 61-slot head of class C
CLASSED_DEPTHS = (1, 2, 12, 13, 14, 28, 29, 30, 60, 61, 62, 80, 100)


def classed_csr(seed=17, nf=900, ntgt=60, maxwin=200):
    """A CSR of nf random u32 features with CLASSED_DEPTHS locations each
    (every depth at least 5 times), ascending (tgt, win) a feature."""
    rng = np.random.default_rng(seed)
    feats = np.unique(rng.integers(0, 2**32 - 1, nf, dtype=np.uint64)
                      .astype(np.uint32))
    depth = np.asarray(CLASSED_DEPTHS)[rng.integers(0, len(CLASSED_DEPTHS),
                                                    len(feats))]
    depth[:5 * len(CLASSED_DEPTHS)] = np.repeat(CLASSED_DEPTHS, 5)
    offs = np.concatenate([[0], np.cumsum(depth)]).astype(np.int64)
    tw = rng.integers(0, ntgt * maxwin, int(offs[-1]))
    for i in range(len(feats)):
        tw[offs[i]:offs[i + 1]].sort()
    return feats, offs, (tw // maxwin).astype(np.int32), \
        (tw % maxwin).astype(np.int32)


def classed_layout(csr, dev):
    """The port's size-classed staging of ``csr`` (MC_CLASSED=1, dense
    rows refused) on ``dev``."""
    from metacache_tpu_torch.ops import table_device as T
    old = os.environ.get("MC_CLASSED")
    os.environ["MC_CLASSED"] = "1"
    try:
        return T.device_layout_from_csr(*csr, device=dev, cap=254,
                                        budget_bytes=4 << 20,
                                        allow_dense=False)
    finally:
        if old is None:
            del os.environ["MC_CLASSED"]
        else:
            os.environ["MC_CLASSED"] = old


def classed_probes(feats, bits, seed=19, n=4096 + 17):
    """n probes of a classed layout: stored features, misses that share a
    stored feature's bucket (its low 32 - bits bits changed) or its low
    bits (another bucket), random values and sentinels; uint32."""
    rng = np.random.default_rng(seed)
    flat = feats[rng.integers(0, len(feats), n)].copy()
    u = rng.random(n)
    kb = np.uint32(32 - bits)
    sel = u < 0.15
    flat[sel] ^= np.uint32(1) << rng.integers(0, 32 - bits, int(sel.sum()),
                                              dtype=np.uint32)
    sel = (u >= 0.15) & (u < 0.25)
    flat[sel] ^= np.uint32(1) << (kb + rng.integers(0, bits, int(sel.sum()),
                                                    dtype=np.uint32))
    sel = (u >= 0.25) & (u < 0.35)
    flat[sel] = rng.integers(0, 2**32, int(sel.sum()), dtype=np.uint64)
    flat[(u >= 0.35) & (u < 0.37)] = np.uint32(0xFFFFFFFF)
    flat[:3] = np.uint32(0xFFFFFFFF)
    return flat


def classed_garbage(cells, n, seed=23):
    """Cell addresses of every class at every 16-lane offset of the cells
    and features equal to the addressed lane 0 (hits) or not: the
    decode's arithmetic on any input. -> (pidx, flat) int32 numpy."""
    rng = np.random.default_rng(seed)
    a16 = rng.integers(0, cells.shape[0] * 8, n)
    pidx = ((a16 << 2) | rng.integers(0, 4, n)).astype(np.int32)
    win = cells.reshape(-1, 16)[a16]
    flat = np.where(rng.random(n) < 0.7, win[:, 0],
                    rng.integers(-2**31, 2**31, n)).astype(np.int32)
    flat[::50] = -1
    return pidx, flat


# probe kinds of classed_kind_probes
CLASSED_KINDS = ("found", "missed", "sentinel", "garbage")


def classed_kind_probes(lay, cls, parity, kind, n=45, seed=29):
    """n probes (a count no multiple of 32, 16, 8 or 4: the kernels'
    warps and steps end part-filled) of the CPU staging ``lay``, the kind
    at every even (parity 0) or odd index (the decode's odd probes at f =
    16), sentinels at cell address 0 between them: stored features of
    class ``cls`` cells (found), the same with their lowest bit flipped
    (missed: the bucket's entries miss, the cell's feature differs),
    sentinels at those cells' addresses, or random features and garbage
    cell addresses of class ``cls`` (every third at the half's last
    16-lane offset, where class C's slots run past the half). -> (flat,
    pidx) int32 numpy: the bucket probe's input and the decode's."""
    rng = np.random.default_rng(seed + 7 * cls + 3 * parity)
    flat = np.full(n, -1, np.int32)
    pidx = np.zeros(n, np.int32)
    at = np.arange(parity, n, 2)
    if kind == "garbage":
        a16 = rng.integers(0, lay.head.shape[0] * 8, len(at))
        a16[::3] |= 3
        pidx[at] = (a16 << 2) | cls
        win = lay.head.numpy().reshape(-1, 16)[a16]
        flat[at] = np.where(rng.random(len(at)) < 0.6, win[:, 0],
                            rng.integers(-2**31, 2**31, len(at)))
        return flat, pidx
    feats = torch.from_numpy(lay.uniq.numpy()[:900].copy())
    feats = feats[feats != -1]
    pi, found = D.classed_bucket_plain(lay.brows, feats, lay.bbits)
    mine = np.flatnonzero(found.numpy() & ((pi.numpy() & 3) == cls))
    assert len(mine) > 0, cls
    pick = mine[rng.integers(0, len(mine), len(at))]
    pidx[at] = pi.numpy()[pick]
    flat[at] = {"found": feats.numpy()[pick],
                "missed": feats.numpy()[pick] ^ 1,
                "sentinel": -1}[kind]
    return flat, pidx


@pytest.mark.parametrize("hi", [False, True])
@pytest.mark.parametrize("wide", [False, True])
@pytest.mark.parametrize("width", BUCKET_WIDTHS)
def test_bucket_decode_kernel_widths_match_plain(cuda, width, wide, hi):
    """B9 on every index width, u32 and u64 features, with and without
    the clamp, against its plain version on the same CUDA tensors."""
    d = bucket_case(width, wide)
    brows = torch.from_numpy(d["brows"]).to(cuda)
    flat = bucket_flat(d).to(cuda)
    h = d["nf"] - 1 if hi else None
    before = kernels.BUCKET_DECODE.launches
    got = D.bucket_decode(brows, flat, d["bits"], h)
    want = D.bucket_decode_plain(brows, flat, d["bits"], h)
    torch.cuda.synchronize()
    assert kernels.BUCKET_DECODE.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any()) and not bool(got[1].all())


def test_classed_bucket_kernel_matches_plain(cuda):
    """classed_bucket against its plain version on the staged classed
    index, stored features, misses and sentinels."""
    lay = classed_layout(classed_csr(), torch.device("cpu"))
    flat = torch.from_numpy(classed_probes(lay.uniq.numpy().view(np.uint32),
                                           lay.bbits).view(np.int32))
    brows, flat = lay.brows.to(cuda), flat.to(cuda)
    before = kernels.CLASSED_BUCKET.launches
    got = D.classed_bucket(brows, flat, lay.bbits)
    want = D.classed_bucket_plain(brows, flat, lay.bbits)
    torch.cuda.synchronize()
    assert kernels.CLASSED_BUCKET.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool(got[1].any()) and not bool(got[1].all())


@pytest.mark.parametrize("probes", ["staged", "garbage"])
@pytest.mark.parametrize("mode", ["head", "pass", "rebase", "unpack"])
@pytest.mark.parametrize("alt,f", [(0, 1), (128, 16), (256, 16)])
def test_classed_decode_kernel_matches_plain(cuda, alt, f, mode, probes):
    """classed_decode, full depth in each output encoding and head only,
    alternating runs off and on, against its plain version on the same
    CUDA tensors: on the staged cells' own probes, and on addresses of
    every class and offset."""
    lay = classed_layout(classed_csr(), torch.device("cpu"))
    hsl, c, sb = lay.head_slots, lay.spf, lay.slot_bits
    if probes == "staged":
        flat = torch.from_numpy(classed_probes(
            lay.uniq.numpy().view(np.uint32), lay.bbits).view(np.int32))
        pidx = D.classed_bucket(lay.brows, flat, lay.bbits)[0]
    else:
        p, fl = classed_garbage(lay.head.numpy(), 4096 + 17)
        pidx, flat = torch.from_numpy(p), torch.from_numpy(fl)
    head = mode == "head"
    pb = {"head": sb, "pass": sb, "rebase": sb + 2, "unpack": 0}[mode]
    rl = alt or (hsl if head else c)
    args = (lay.head.to(cuda), lay.ovf.to(cuda), pidx.to(cuda),
            flat.to(cuda), hsl, c, rl, f if alt else 1, sb, pb, head)
    before = kernels.CLASSED_DECODE.launches
    got = D.classed_decode(*args)
    want = D.classed_decode_plain(*args)
    torch.cuda.synchronize()
    assert kernels.CLASSED_DECODE.launches == before + 1
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0] == I32_MAX).any()) and \
        bool((got[0] != I32_MAX).any())


@pytest.mark.parametrize("kind", CLASSED_KINDS)
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("cls", [0, 1, 2])
def test_classed_bucket_kernel_kinds_match_plain(cuda, cls, parity, kind):
    """classed_bucket against its plain version on 45 probes of one kind
    and class: the warp's last steps part-filled."""
    lay = classed_layout(classed_csr(), torch.device("cpu"))
    flat = torch.from_numpy(classed_kind_probes(lay, cls, parity, kind)[0])
    brows, flat = lay.brows.to(cuda), flat.to(cuda)
    got = D.classed_bucket(brows, flat, lay.bbits)
    want = D.classed_bucket_plain(brows, flat, lay.bbits)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kind != "garbage":        # garbage holds some stored features
        assert bool(got[1].any()) == (kind == "found")


@pytest.mark.parametrize("mode", ["head", "pass", "rebase", "unpack"])
@pytest.mark.parametrize("kind", CLASSED_KINDS)
@pytest.mark.parametrize("parity", [0, 1])
@pytest.mark.parametrize("cls", [0, 1, 2])
def test_classed_decode_kernel_kinds_match_plain(cuda, cls, parity, kind,
                                                 mode):
    """classed_decode (head form at rl 64, full form at rl 256, f 16)
    against its plain version on 45 probes of one kind and class at even
    or odd indices."""
    lay = classed_layout(classed_csr(), torch.device("cpu"))
    hsl, c, sb = lay.head_slots, lay.spf, lay.slot_bits
    flat, pidx = (torch.from_numpy(a).to(cuda) for a in
                  classed_kind_probes(lay, cls, parity, kind))
    head = mode == "head"
    pb = {"head": sb, "pass": sb, "rebase": sb + 2, "unpack": 0}[mode]
    args = (lay.head.to(cuda), lay.ovf.to(cuda), pidx, flat, hsl, c,
            64 if head else 256, 16, sb, pb, head)
    got = D.classed_decode(*args)
    want = D.classed_decode_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert bool((got[0] != I32_MAX).any()) == (kind in ("found",
                                                         "garbage"))


@pytest.mark.parametrize("head,rl", [(True, 61), (True, 64), (True, 128),
                                     (False, 256)])
def test_classed_decode_kernel_unaligned_matches_plain(cuda, head, rl):
    """classed_decode on a cells view offset by one int32 (not 16-byte
    aligned: the head form's 4-byte path) and, at rl 61, on outputs of a
    width no multiple of 4, against its plain version on the staged
    probes and garbage addresses."""
    lay = classed_layout(classed_csr(), torch.device("cpu"))
    hsl, c, sb = lay.head_slots, lay.spf, lay.slot_bits
    flat = torch.from_numpy(classed_probes(
        lay.uniq.numpy().view(np.uint32), lay.bbits).view(np.int32))
    pidx = D.classed_bucket(lay.brows, flat, lay.bbits)[0]
    gp, gf = classed_garbage(lay.head.numpy(), 4096 + 17)
    pidx = torch.cat([pidx, torch.from_numpy(gp)])
    flat = torch.cat([flat, torch.from_numpy(gf)])
    buf = torch.zeros(lay.head.numel() + 1, dtype=torch.int32, device=cuda)
    cells = buf[1:].view(-1, 128)
    cells.copy_(lay.head.to(cuda))
    assert cells.data_ptr() % 16 != 0
    args = (cells, lay.ovf.to(cuda), pidx.to(cuda), flat.to(cuda), hsl, c,
            rl, 16, sb, sb, head)
    got = D.classed_decode(*args)
    want = D.classed_decode_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("alt", [0, 128])
def test_classed_probe_rows_on_the_card_match_cpu(cuda, alt):
    """probe_rows and probe_rows_head on the classed cells, on the card
    (classed_bucket, classed_decode) against the same on CPU tensors."""
    from metacache_tpu_torch.db.state import tables_from_device
    from metacache_tpu_torch.ops import rows as trows
    csr = classed_csr()
    lin = np.zeros((60, 21), np.int32)
    tabs = [tables_from_device(classed_layout(csr, d), lin,
                               lin[:, 0].copy())
            for d in (cuda, torch.device("cpu"))]
    flat = classed_probes(csr[0], tabs[1].bucket_bits).view(np.int32)
    q = torch.from_numpy(flat[:4096].reshape(-1, 16).copy())
    sb = tabs[1].slot_bits
    kernels.reset_counts()
    for head in (False, True):
        kw = dict(alt_runs=alt or (64 if head else 0), pack_bits=sb)
        fn = trows.probe_rows_head if head else trows.probe_rows
        on_card, on_cpu = (fn(q.to(t.bucket_rows.device), t, **kw)
                           for t in tabs)
        for g, w in zip(on_card, on_cpu):
            assert torch.equal(g.cpu(), w)
    assert kernels.CLASSED_BUCKET.launches == 2
    assert kernels.CLASSED_DECODE.launches == 2


@pytest.mark.parametrize("case", ["dense", "two_tier", "classed"])
def test_device_builder_on_the_card_matches_cpu(cuda, monkeypatch, case):
    """The builder's arrays from the same stream on the card and on the
    CPU; the CSR staging and export likewise."""
    from metacache_tpu_torch.ops import table_device as T
    monkeypatch.setenv("MC_CLASSED", "1" if case == "classed" else "0")
    budget = 1 << 40 if case == "dense" else 2 << 20
    got, want = (_device_table(d, budget) for d in (cuda, torch.device("cpu")))
    assert (got.dense, got.classed) == (case == "dense", case == "classed")
    for name in ("uniq", "offsets", "head", "ovf", "brows"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    uniq, offs, locs = T.export_csr(got)
    for a, b in zip((uniq, offs, locs), T.export_csr(want)):
        np.testing.assert_array_equal(a, b)
    tgt = (locs >> np.uint64(32)).astype(np.uint32)
    win = (locs & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    staged = [T.device_layout_from_csr(uniq, offs, tgt, win, device=d,
                                       budget_bytes=budget, gbits=1)
              for d in (cuda, torch.device("cpu"))]
    for name in ("uniq", "offsets", "head", "ovf", "brows"):
        assert torch.equal(getattr(staged[0], name).cpu(),
                           getattr(staged[1], name)), name


@pytest.mark.parametrize("staging", ["classed", "probe-kernels"])
def test_fixture_stagings_on_the_card_match_golden(cuda, tmp_path,
                                                   monkeypatch, staging):
    """The fixture query through the classed cells, and through
    pair-packed rows with B9 on (MC_PROBE_PALLAS=1)."""
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    env = {"classed": {"MC_DENSE_LIMIT": "1", "MC_CLASSED": "1"},
           "probe-kernels": {"MC_PROBE_PALLAS": "1", "MC_PACK_ROWS": "1"}}
    for k, v in env[staging].items():
        monkeypatch.setenv(k, v)
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")
    buf = io.StringIO()
    kernels.reset_counts()
    with contextlib.redirect_stdout(buf):
        assert main(["query", db, f"{DATA}/reads_single.fa"]) == 0
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        gold = [l for l in f.read().splitlines()
                if not any(d in l for d in drop)]
    assert [l for l in buf.getvalue().splitlines()
            if not any(d in l for d in drop)] == gold
    if staging == "probe-kernels":
        assert kernels.BUCKET_DECODE.launches > 0


# ------------------------------------------- grids of devices (A14)
def _deep_shard_case(seed=13, every=3, b=256):
    """Reads and a table built from their own sketches: every
    ``every``-th feature 100 locations deep (> the 61-slot head), the
    others 5 (tests/test_torch_rows_mesh.py::deep_table)."""
    from metacache_tpu_torch.ops.table import FeatureTable, pack_locations
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (b, 1, 128), dtype=np.uint8)
    lens = np.full((b, 1), 100, np.int32)
    feats = S.sketch_windows(torch.from_numpy(codes.reshape(b, 128)),
                             torch.from_numpy(lens.reshape(b)), 16,
                             16).numpy().view(np.uint32)
    uf = np.unique(feats.reshape(-1))
    uf = uf[uf != 0xFFFFFFFF]
    depth = np.where(np.arange(len(uf)) % every == 0, 100, 5)
    f = np.repeat(uf, depth)
    j = np.concatenate([np.arange(d) for d in depth])
    i = np.repeat(np.arange(len(uf)), depth)
    t, w = ((i + j) % 48).astype(np.int32), (j % 40).astype(np.int32)
    order = np.lexsort((w, t, f))
    ft = FeatureTable.build(f[order].copy(), pack_locations(t[order],
                                                            w[order]),
                            max_locations_per_feature=254)
    return ft, codes, lens, lineages(48)


@pytest.fixture(params=["repeated", "distinct"])
def cards(request, cuda):
    """Four grid positions: cuda:0 repeated, or four distinct cards
    (skipped on a host with fewer)."""
    if request.param == "repeated":
        return [torch.device("cuda", 0)] * 4
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four cards")
    return [torch.device("cuda", i) for i in range(4)]


def _sharded(ft, lin, grid, layout):
    from metacache_tpu_torch.parallel.rows_mesh import shard_row_table
    return shard_row_table(ft, grid.shape[1], 254, layout=layout,
                           grid=grid, lineages=lin,
                           merge_tax=lin[:, 0].copy())


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
@pytest.mark.parametrize("layout", ["dense", "two_tier"])
@pytest.mark.parametrize("fused", [False, True])
def test_sharded_step_on_the_card_matches_cpu(cards, shape, layout, fused):
    """The sharded step on a grid of cards against the same step on a
    grid of the CPU, in all nine QueryResult fields: B1, B7 on two-tier
    shards, B4 (packed) or B5 (pairs) on the exchanged rows of P blocks
    of alternating 256-lane runs."""
    from metacache_tpu_torch.parallel import rows_mesh as RM
    from metacache_tpu_torch.parallel.mesh import make_mesh
    ft, codes, lens, lin = _deep_shard_case()
    mwir = np.full(len(codes), 2, np.int32)
    flags = dict(walk_elems=32, fast_top2=True, fused_candidates=True) \
        if fused else dict(fused_candidates=False, emit_hits=True)
    out = []
    kernels.reset_counts()
    for devs in (cards, [torch.device("cpu")] * 4):
        st = _sharded(ft, lin, make_mesh(*shape, devs), layout)
        assert bool(st.slot_bits) == (layout == "two_tier")
        out.append(RM.merge_blocks(RM.sharded_query_step_rows(
            torch.from_numpy(codes), torch.from_numpy(lens),
            torch.from_numpy(mwir), st, 1, 0.5, 19, 0, k=16, sketchlen=16,
            max_candidates=2, **flags), torch.device("cpu")))
    for name, a, b in zip(out[0]._fields, out[0], out[1]):
        assert torch.equal(a, b), name
    assert kernels.SKETCH.launches == 4
    if layout == "two_tier":
        assert kernels.FULL_DECODE.launches == 4
    if fused:
        kern = kernels.CANDIDATES if layout == "two_tier" else \
            kernels.CANDIDATES_UNPACKED
        assert kern.launches == 4


def test_sharded_head_step_on_the_card_matches_cpu(cards):
    """Escalation phase 1 over two-tier shards: B6 on every position,
    the over flags OR-ed through the exchange, B4 on the head slots;
    the card equals the CPU, and some reads escalate, some do not."""
    from metacache_tpu_torch.parallel import rows_mesh as RM
    from metacache_tpu_torch.parallel.mesh import make_mesh
    ft, codes, lens, lin = _deep_shard_case(21, every=37)
    mwir = np.full(len(codes), 2, np.int32)
    out = []
    kernels.reset_counts()
    for devs in (cards, [torch.device("cpu")] * 4):
        st = _sharded(ft, lin, make_mesh(2, 2, devs), "two_tier")
        blocks, over = RM.sharded_query_step_rows_head(
            torch.from_numpy(codes), torch.from_numpy(lens),
            torch.from_numpy(mwir), st, 1, 0.5, 19, 0, k=16, sketchlen=16,
            max_candidates=2, walk_elems=32, fast_top2=True)
        out.append((RM.merge_blocks(blocks, torch.device("cpu")).cls_tax,
                    torch.cat([o.cpu() for o in over])))
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert out[0][1].any() and not out[0][1].all()
    assert kernels.HEAD_DECODE.launches == 4
    assert kernels.CANDIDATES.launches == 4


@pytest.mark.parametrize("extra", [["-table-shards", "4"],
                                   ["-table-shards", "2", "-replicate", "2"],
                                   ["-replicate", "2"]])
def test_grid_queries_on_the_card_match_golden(cards, tmp_path, monkeypatch,
                                               extra):
    """-table-shards (two-tier shards; the summary escalated through B6,
    the redo through B7) and -replicate over four grid positions of
    cards: the per-read golden and the golden summary."""
    from metacache_tpu_torch.classify.runner import QueryRunner as QR
    from metacache_tpu_torch.cli.main import (Args, parse_query_options,
                                              run_query)
    from metacache_tpu_torch.db.database import Database
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("MC_SHARD_LAYOUT", "two_tier")
    db = str(tmp_path / "db")
    assert main(["build", db, f"{DATA}/genomes.fa", "-taxonomy",
                 f"{DATA}/taxonomy"]) == 0
    tdb = Database.load(db)
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")

    def query(args):
        opt, _, _ = parse_query_options(Args(args + extra))
        runner = QR(tdb, opt, devices=cards)
        assert runner._row_quantum == 4 if "-table-shards" in extra and \
            "-replicate" not in extra else runner._row_quantum in (2, 4)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert run_query(tdb, [f"{DATA}/reads_single.fa"], opt,
                             runner=runner) == 0
        return [l for l in buf.getvalue().splitlines()
                if not any(d in l for d in drop)]
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        gold = [l for l in f.read().splitlines()
                if not any(d in l for d in drop)]
    kernels.reset_counts()
    assert query([]) == gold
    assert kernels.SKETCH.launches > 0
    kernels.reset_counts()
    summary = query(["-no-map"])
    i = next(j for j, l in enumerate(gold) if "queries:" in l)
    assert summary[-len(gold[i:]):] == gold[i:]
    if "-table-shards" in extra:
        assert kernels.HEAD_DECODE.launches > 0


@pytest.mark.parametrize("split", [False, True])
def test_replicas_hit_lists_on_the_card(cuda, monkeypatch, split):
    """-replicate 2 over cuda:0 repeated on a -allhits batch: where each
    replica's rows take several launches, the merged result keeps the
    per-hit lists on the host, where those launches sent them, and the
    per-row fields on the card; in one launch a replica everything stays
    on the card. The values equal one launch's either way."""
    from metacache_tpu_torch.classify import runner as R
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    from metacache_tpu_torch.db.build import BuildOptions, build_database
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    tdb = build_database(BuildOptions(
        infiles=[f"{DATA}/genomes.fa"], taxonomy_dir=f"{DATA}/taxonomy"))
    opt, _, _ = parse_query_options(Args(["-allhits", "-replicate", "2"]))
    rng = np.random.default_rng(15)
    n, wl = 64, tdb.sketching.winlen
    wins = rng.integers(0, 4, (n, 1, wl), dtype=np.uint8)
    valid = np.full((n, 1), wl, np.int32)
    mwir = np.full(n, 2, np.int32)
    out = []
    for small in (False, split):
        if small:
            slots = tdb.sketching.sketchlen * tdb.parts[0].max_bucket_size
            row_b = R.nonfused_row_bytes(slots, "rank-join", True)
            monkeypatch.setattr(R, "free_bytes", lambda device: 8 * row_b)
        runner = R.QueryRunner(tdb, opt, devices=[torch.device("cuda", 0)] * 2)
        out.append(runner._launch_rows(wins, valid, mwir, 1,
                                       opt.classify.max_candidates))
    res = out[1]
    assert all(x.device.type == "cuda" for x in res[:6])
    assert all(x.device.type == ("cpu" if split else "cuda")
               for x in res[6:])
    for name, a, b in zip(res._fields, out[0], res):
        assert torch.equal(a.cpu(), b.cpu()), name


def test_multihost_dryrun_on_the_card(cuda):
    """Two dryrun processes joined by gloo, each on two grid positions of
    the cards (cuda:0 repeated on one card), check their rows against
    the single-device step on the card."""
    import socket
    import subprocess
    import sys
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.dirname(DATA))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("MC_TORCH_DEVICE", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metacache_tpu_torch.parallel.multihost_dryrun",
         "--coordinator", f"localhost:{port}", "--nprocs", "2", "--pid",
         str(pid), "--local-devices", "2"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-2000:]
        assert f"MULTIHOST_OK pid={pid} procs=2" in out, out + err[-2000:]
        assert "classified=8" in out


# ------------------- the pipelined scan, the fused escalation, the infeed
def _strain_reads(tmp_path, n, seed=21):
    """2 x 32 strain genomes of 20 kbp (0.3% substitutions) as FASTA,
    and n reads of 100 bp drawn from them (2 substitutions each) as 2-bit
    packed rows of 32 bytes (the runner's infeed) and as FASTA. -> (the
    genome file, the read file, the packed rows (n, 32))."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    genomes = []
    for _b in range(2):
        base = rng.integers(0, 4, 20000, dtype=np.uint8)
        for s in range(32):
            g = base.copy()
            if s:
                pos = rng.integers(0, 20000, 60)
                g[pos] = rng.integers(0, 4, 60)
            genomes.append(g)
    gfa = tmp_path / "g.fa"
    with open(gfa, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">s%d\n" % i + acgt[g].tobytes() + b"\n")
    gs = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, 20000 - 100, n)
    reads = np.stack(genomes)[gs[:, None], pos[:, None] + np.arange(100)]
    reads[np.arange(n)[:, None], rng.integers(0, 100, (n, 2))] = \
        rng.integers(0, 4, (n, 2), dtype=np.uint8)
    rfa = tmp_path / "r.fa"
    with open(rfa, "wb") as f:
        text = acgt[reads]
        for i in range(n):
            f.write(b">r%d\n" % i + text[i].tobytes() + b"\n")
    c4 = np.zeros((n, 128), np.uint8)
    c4[:, :100] = reads
    return str(gfa), str(rfa), pack_2bit(c4)


def test_streamed_scan_and_fused_dispatch_match_plain_order(cuda, tmp_path):
    """At the runner's full stack (32 x 8192 reads), on two-tier rows
    (head 4) of a strain database: the prefetched scan and head scan
    (stage 1 on a side stream) and the fused dispatch (a redo slice of
    4096 flagged reads a batch on the side stream beside phase 1) equal
    the plain order on the same CUDA tensors, twice over (the second
    pass reuses the allocator's blocks that the first freed across
    streams)."""
    from metacache_tpu_torch.db.build import BuildOptions, build_database
    from metacache_tpu_torch.db.state import tables_from_numpy
    from metacache_tpu_torch.device import SideStream
    from metacache_tpu_torch.ops import rows as R
    from metacache_tpu_torch.ops.probe import make_bucket_index
    K, B, B2 = 32, 8192, 4096
    gfa, _rfa, packed = _strain_reads(tmp_path, K * B)
    ft = build_database(BuildOptions(infiles=[gfa])).parts[0]
    spf = min(ft.max_bucket_size, 254)
    wbits = (2 * int((ft.locations & np.uint64(0xFFFFFFFF)).max())) \
        .bit_length()
    head, ovf = ft.fused_rows_two_tier(spf, 4, slot_bits=wbits)
    brows, bits = make_bucket_index(ft.unique_features)
    lin = lineages(64)
    t = tables_from_numpy(ft.unique_features, ft.offsets, head, brows, bits,
                          lin, lin[:, 0].copy(), spf, wbits, cuda,
                          ovf_rows=ovf, head_slots=4)
    stack = (torch.from_numpy(packed.reshape(K, B, 1, 32)).to(cuda),
             torch.full((K, B, 1), 100, dtype=torch.uint8, device=cuda),
             torch.full((K, B), 2, dtype=torch.uint8, device=cuda))
    args = (5, 0.5, 19, 0)
    kw = dict(k=16, sketchlen=16, max_candidates=2, walk_elems=32,
              fast_top2=True, pack_bits=wbits, infeed_packed=True)
    side = SideStream(cuda)
    plain = R.query_step_rows_scan(*stack, t, *args, windows_per_query=1,
                                   **kw)
    head_plain = R.query_step_rows_scan_head(*stack, t, *args, **kw)
    bits_ = head_plain[1].cpu().numpy().reshape(-1)
    flagged = np.nonzero(((bits_[:, None] >> np.arange(32)) & 1)
                         .astype(bool).reshape(-1))[0]
    assert 0 < len(flagged) < K * B
    sel = torch.from_numpy(np.resize(flagged, K * B2)).to(cuda)
    rf = head_plain[2].reshape(-1, 16)[sel].reshape(K, B2, 16)
    ri = head_plain[3].reshape(-1, 16)[sel].reshape(K, B2, 16)
    rm = torch.full((K, B2), 2, dtype=torch.int32, device=cuda)
    rkw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
               pack_bits=wbits)
    redo_plain = R.query_step_rows_redo_scan(rf, ri, rm, t, *args, **rkw)
    for _ in range(2):
        got = R.query_step_rows_scan(*stack, t, *args, windows_per_query=1,
                                     prefetch=True, side=side, **kw)
        heads = R.query_step_rows_scan_head(*stack, t, *args, prefetch=True,
                                            side=side, **kw)
        fused = R.query_step_rows_scan_head_fused(
            *stack, rf, ri, rm, t, *args, side=side, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, plain)
        for g, p in zip(heads, head_plain):
            assert torch.equal(g, p)
        for g, p in zip(fused, (*head_plain, redo_plain)):
            assert torch.equal(g, p)
    assert (plain != 0).sum() > K * B // 2


def test_infeed_ring_on_the_card(cuda):
    """Infeed through 4 pinned buffers: 6 stacks of different contents,
    each read by the current stream only after a long sleep there, so
    that the copy stream runs ahead and reuses the ring's buffers: every
    stack arrives whole."""
    from metacache_tpu_torch.device import Infeed
    feed = Infeed(cuda, 4)
    rng = np.random.default_rng(3)
    sums, want = [], []
    for i in range(6):
        rows = rng.integers(0, 256, (8192 * 32, 32), dtype=np.uint8)
        lens = rng.integers(0, 128, 8192 * 32).astype(np.int32)
        torch.cuda._sleep(20_000_000)
        w, v = feed.put(rows[:, :8 + 4 * i], lens)
        sums.append((w.to(torch.int64).sum(), v.to(torch.int64).sum()))
        want.append((int(rows[:, :8 + 4 * i].astype(np.int64).sum()),
                     int(lens.astype(np.int64).sum())))
    torch.cuda.synchronize()
    assert [(int(a), int(b)) for a, b in sums] == want


def test_pinned_ring_summary_matches_plain_loop(cuda, tmp_path, monkeypatch):
    """The runner's summary of DEPTH + 2 stacks of 8192 reads of different
    contents (MC_SCAN_K=1), which reach the card through its ring of
    DEPTH + 1 pinned buffers and the prefetched scan, gives the rank
    histogram of the plain loop: each stack's scan step on pageable
    copies, without prefetch, and the rank histogram of its classes."""
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import (map_queries_to_targets,
                                                     rank_histogram)
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    from metacache_tpu_torch.db.database import Database
    from metacache_tpu_torch.ops import rows as R
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    monkeypatch.setenv("MC_SCAN_K", "1")
    n = (QueryRunner.DEPTH + 2) * 8192
    gfa, rfa, packed = _strain_reads(tmp_path, n, seed=22)
    db = str(tmp_path / "db")
    assert main(["build", db, gfa]) == 0
    opt, _, _ = parse_query_options(Args(["-no-map"]))
    runner = QueryRunner(Database.load(db), opt)
    res = ClassificationResults(io.StringIO(), io.StringIO(), io.StringIO())
    map_queries_to_targets([rfa], runner.db, opt, res, runner)
    torch.cuda.synchronize()
    hist = 0
    sk = runner.sketching
    for s in range(n // 8192):
        rows = packed[s * 8192:(s + 1) * 8192, :28]
        cls = R.query_step_rows_scan(
            torch.from_numpy(rows.reshape(1, 8192, 1, 28)).to(cuda),
            torch.full((1, 8192, 1), 100, dtype=torch.uint8, device=cuda),
            torch.full((1, 8192), 2, dtype=torch.uint8, device=cuda),
            runner.tables, runner.hits_min, opt.classify.hits_diff_fraction,
            runner.highest_rank, runner.merge_rank, k=sk.kmerlen,
            sketchlen=sk.sketchlen, windows_per_query=1,
            max_candidates=opt.classify.max_candidates,
            pack_bits=runner._pack_bits, infeed_packed=True,
            fast_top2=runner._fast_top2, walk_elems=32)
        hist = hist + rank_histogram(cls, 8192, *runner._hist_dev).cpu()
    assert res.statistics.total() == n
    assert np.array_equal(res.statistics.assigned_, hist.numpy())


# ------------------------------- the step's tail: classify_lca, rank_hist
NUM_RANKS = 21
LCA_PARAMS = ((5, 0.5), (5, 1.0), (0, 0.9))   # (hits_min, hits_diff_frac)


def lca_lineages(rng, t, r=NUM_RANKS):
    """(t, r) int32 lineages: sequence-level taxa -1 .. -t at rank 0; at
    r = 21 species of 4 targets (rank 4), genera of 16 (rank 6), families
    of 64 (rank 10), domain and root (ranks 19, 20); at other r, rank j
    of 2^(j % 7) targets and root at the last rank; about a tenth of the
    ranks cleared (rank 0 in one target of 50), so that lineages have
    gaps below and above their first set rank at or above merge_rank."""
    ids = np.arange(t)
    lin = np.zeros((t, r), np.int32)
    if r == NUM_RANKS:
        lin[:, 4] = 1000 + ids // 4
        lin[:, 6] = 100000 + ids // 16
        lin[:, 10] = 200000 + ids // 64
        lin[:, 19] = 2
    else:
        for j in range(1, r):
            lin[:, j] = 1000 * (j + 1) + ids // 2 ** (j % 7)
    lin[:, r - 1] = 1
    lin[:, 0] = -ids - 1
    gaps = rng.random((t, r)) < 0.1
    gaps[:, 0] = rng.random(t) < 0.02
    lin[gaps] = 0
    return lin


def lca_case(seed, b, k, t=1024, r=NUM_RANKS):
    """Candidates of b reads, k a read, over t targets, for the hits_min
    and fractions of LCA_PARAMS: -> dict(tgt, hits, tax, merge_tax,
    lin), numpy int32. A read's targets lie within 12 of one another
    (its species, genus or family agree), target t - 1 in every 17th
    read; about 15% of the candidates are absent (target -1, taxon 0),
    at every position, the first included, and 5% of the targets have
    taxon 0 (merge_tax); hits descend; every 5th read has ties at the
    threshold (hits0 = 5 + 2h, the others h or h + 1: at frac 0.5 the
    threshold is h), every 7th has hits0 - 5 near 2^24 + 3 and the
    others near 2^24 + 4, where the float32 threshold's rounding decides
    the include."""
    rng = np.random.default_rng(seed)
    lin = lca_lineages(rng, t, r)
    merge_tax = lin[:, 0].copy()
    merge_tax[rng.random(t) < 0.05] = 0
    base = rng.integers(0, t, (b, 1))
    tgt = np.clip(base + rng.integers(-12, 13, (b, k)), 0, t - 1)
    tgt[::17, rng.integers(0, k)] = t - 1
    hits = -np.sort(-rng.integers(0, 40, (b, k)), axis=1)
    h = rng.integers(1, 15, (b, 1))
    tie = np.where(rng.random((b, k)) < 0.5, h, h + 1)
    tie[:, 0] = 5 + 2 * h[:, 0]
    hits[::5] = tie[::5]
    big = 2**24 + rng.integers(2, 7, (b, k))
    big[:, 0] = 5 + 2**24 + 3
    hits[::7] = big[::7]
    absent = rng.random((b, k)) < 0.15
    tgt = np.where(absent, -1, tgt)
    tax = np.where(tgt >= 0, merge_tax[np.maximum(tgt, 0)], 0)
    return {n: np.ascontiguousarray(a, dtype=np.int32) for n, a in (
        ("tgt", tgt), ("hits", hits), ("tax", tax),
        ("merge_tax", merge_tax), ("lin", lin))}


def hist_case(seed, m, nt=300):
    """A stack of m classified taxa and the taxonomy's tables: ->
    (cls, taxid_sorted, rank_of, over_bits), numpy int32. nt ascending
    ids (some negative), ranks 0-21; cls: 60% ids of the table, the rest
    absent ids between them, ids past the last and below the first, and
    0; over bits at random (10%), words 0 and the last all set."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(np.arange(-500, max(50000, 4 * nt)), nt,
                             replace=False))
    rank_of = rng.integers(0, NUM_RANKS + 1, nt)
    cls = rng.integers(ids[0] - 10, ids[-1] + 10, m)
    own = rng.random(m) < 0.6
    cls[own] = ids[rng.integers(0, nt, int(own.sum()))]
    cls[rng.random(m) < 0.1] = 0
    cls[:3] = np.array((ids[-1] + 1, ids[0] - 1, 2**31 - 1))[:m]
    over = rng.random(-(-m // 32) * 32) < 0.1
    over[:32] = True
    over[-32:] = True
    words = (over.reshape(-1, 32).astype(np.int64) <<
             np.arange(32)).sum(axis=1)
    return (cls.astype(np.int32), ids.astype(np.int32),
            rank_of.astype(np.int32),
            words.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("b,k", [(512, 1), (512, 2), (512, 4), (512, 8),
                                 (512, 40), (8192, 2), (8192, 8)])
@pytest.mark.parametrize("hits_min,frac", LCA_PARAMS)
def test_classify_lca_kernel_matches_plain(cuda, b, k, hits_min, frac):
    """classify_lca, both forms, against the plain versions on the same
    CUDA tensors, merge_rank and highest_rank across the ranks; K = 40
    takes two turns of 32 candidates; one launch a call."""
    from metacache_tpu_torch.ops import pipeline as P
    d = {n: torch.from_numpy(a).to(cuda)
         for n, a in lca_case(b * 31 + k, b, k).items()}
    for merge_rank, highest in ((0, 20), (4, 4), (4, 19), (6, 20),
                                (19, 20), (0, 0)):
        args = (hits_min, frac, highest, merge_rank)
        before = kernels.CLASSIFY_LCA.launches
        got = P.classify_candidates(d["tgt"], d["tax"], d["hits"], d["lin"],
                                    *args)
        tax, cls = P.classify_with_taxa(d["tgt"], d["hits"], d["merge_tax"],
                                        d["lin"], *args)
        assert kernels.CLASSIFY_LCA.launches == before + 2
        want = P.classify_candidates_plain(d["tgt"], d["tax"], d["hits"],
                                           d["lin"], *args)
        wtax, wcls = P.classify_with_taxa_plain(
            d["tgt"], d["hits"], d["merge_tax"], d["lin"], *args)
        assert torch.equal(got, want)
        assert torch.equal(tax, wtax) and torch.equal(cls, wcls)
        assert torch.equal(cls, want)


def test_classify_lca_refuses_what_it_cannot_take(cuda):
    """Ranks past a warp, an empty table and tensors on two devices
    raise; nothing falls back to the plain version."""
    from metacache_tpu_torch.ops import pipeline as P
    d = {n: torch.from_numpy(a).to(cuda)
         for n, a in lca_case(3, 64, 2).items()}
    wide = torch.zeros((8, 33), dtype=torch.int32, device=cuda)
    for bad in (wide, d["lin"][:0], d["lin"].cpu()):
        with pytest.raises(ValueError):
            P.classify_candidates(d["tgt"], d["tax"], d["hits"], bad, 5,
                                  0.5, 20, 0)


@pytest.mark.parametrize("m,n", [(1000, 1000), (8192 * 2, 9000),
                                 (262144, 262144), (262144, 200000)])
@pytest.mark.parametrize("masked", [False, True])
def test_rank_hist_kernel_matches_plain(cuda, m, n, masked):
    """rank_hist against rank_histogram_plain on the same CUDA tensors:
    a stack of up to 262,144 reads, with and without overflow bits, n at
    and below the stack; one launch a call."""
    from metacache_tpu_torch.classify.runner import (rank_histogram,
                                                     rank_histogram_plain)
    cls, ids, ranks, over = (torch.from_numpy(a).to(cuda)
                             for a in hist_case(m, m))
    over = over if masked else None
    before = kernels.RANK_HIST.launches
    got = rank_histogram(cls, n, ids, ranks, over_bits=over)
    assert kernels.RANK_HIST.launches == before + 1
    want = rank_histogram_plain(cls, n, ids, ranks, over_bits=over)
    assert got.dtype == torch.int64 and torch.equal(got, want)
    assert int(got.sum()) == min(n, m) - (
        0 if over is None else int(((over.cpu().numpy().view(np.uint32)[
            :, None] >> np.arange(32)) & 1).reshape(-1)[:min(n, m)].sum()))


def _lineage_layout(lin, layout):
    """The (T, R) table ``lin`` (int32 CUDA) as a view of rows padded to
    a multiple of 4 ints, contiguous, 4 bytes off the 16-byte grid, or
    with its ranks not adjacent (the transpose of an (R, T) table, which
    the wrapper copies); the padding holds garbage."""
    t, r = lin.shape
    rp = -(-r // 4) * 4
    if layout == "contiguous":
        return lin
    if layout == "columns":
        return lin.t().contiguous().t()
    big = torch.full((t, rp + 4), 7, dtype=torch.int32, device=lin.device)
    first = 1 if layout == "unaligned" else 0
    big[:, first:first + r] = lin
    return big[:, first:first + r] if layout == "unaligned" else \
        big[:, :rp][:, :r]


@pytest.mark.parametrize("r", [1, 21, 32])
@pytest.mark.parametrize("k", [1, 2, 8, 40])
@pytest.mark.parametrize("layout", ["padded", "contiguous", "unaligned",
                                    "columns"])
def test_classify_lca_ranks_and_layouts(cuda, r, k, layout):
    """classify_lca, both forms, against the plain versions at R = 1, 21
    and 32 ranks, K up to 40 (five turns of 8), 1,000 reads (a part-filled
    block), on lineage tables read in place at their row stride (copied
    only where the ranks are not adjacent); one launch a call."""
    from metacache_tpu_torch.ops import pipeline as P
    d = {n: torch.from_numpy(a).to(cuda)
         for n, a in lca_case(r * 100 + k, 1000, k, r=r).items()}
    lin = _lineage_layout(d["lin"], layout)
    assert torch.equal(lin, d["lin"])
    for merge_rank, highest in ((0, r - 1), (min(4, r - 1), r - 1), (r, r),
                                (0, 0)):
        for hits_min, frac in LCA_PARAMS:
            args = (hits_min, frac, highest, merge_rank)
            before = kernels.CLASSIFY_LCA.launches
            got = P.classify_candidates(d["tgt"], d["tax"], d["hits"], lin,
                                        *args)
            tax, cls = P.classify_with_taxa(d["tgt"], d["hits"],
                                            d["merge_tax"], lin, *args)
            assert kernels.CLASSIFY_LCA.launches == before + 2
            want = P.classify_candidates_plain(d["tgt"], d["tax"],
                                               d["hits"], d["lin"], *args)
            assert torch.equal(got, want) and torch.equal(cls, want)
            assert torch.equal(tax, d["tax"])


def test_classify_lca_in_a_cuda_graph(cuda):
    """classify_lca, a programmatic dependent launch, inside a CUDA graph
    after a kernel that writes its candidates: each replay equals the
    plain version on the inputs of that replay."""
    from metacache_tpu_torch.ops import pipeline as P
    d = {n: torch.from_numpy(a).to(cuda)
         for n, a in lca_case(77, 8192, 2).items()}
    lin = _lineage_layout(d["lin"], "padded")
    src = d["hits"].clone()
    hits = torch.empty_like(src)
    args = (5, 1.0, 19, 0)
    P.classify_with_taxa(d["tgt"], src, d["merge_tax"], lin, *args)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        torch.add(src, 1, out=hits)
        tax, cls = P.classify_with_taxa(d["tgt"], hits, d["merge_tax"], lin,
                                        *args)
    for step in range(4):
        src.copy_(d["hits"] + 3 * step)
        g.replay()
        torch.cuda.synchronize()
        want = P.classify_with_taxa_plain(d["tgt"], src + 1, d["merge_tax"],
                                          d["lin"], *args)
        assert torch.equal(tax, want[0]) and torch.equal(cls, want[1])


def _hist_on(cuda, seed, m, nt=300, off=0):
    cls, ids, ranks, over = hist_case(seed, m + off, nt)
    t = [torch.from_numpy(a).to(cuda) for a in (cls, ids, ranks, over)]
    return t[0][off:], t[1], t[2], t[3]


@pytest.mark.parametrize("m,off,nt", [
    (0, 0, 300), (1, 0, 300), (1, 3, 300), (5, 1, 300), (4099, 2, 300),
    (262147, 3, 1023), (262144, 1, 5000), (70000, 0, 300000)])
@pytest.mark.parametrize("masked", [False, True])
def test_rank_hist_edges_match_plain(cuda, m, off, nt, masked):
    """rank_hist against rank_histogram_plain: empty, one read, ragged
    sizes, views starting 1-3 ints past the 16-byte grid, tables above
    the shared-memory cap (pivots); one launch a call, every bin
    written."""
    from metacache_tpu_torch.classify import runner as R
    cls, ids, ranks, over = _hist_on(cuda, m + nt, m, nt, off)
    over = over if masked else None
    n = max(m - 100, m // 2)
    before = kernels.RANK_HIST.launches
    got = R.rank_histogram(cls, n, ids, ranks, over_bits=over)
    assert kernels.RANK_HIST.launches == before + 1
    want = R.rank_histogram_plain(cls, n, ids, ranks, over_bits=over)
    assert got.dtype == torch.int64 and torch.equal(got, want)


@pytest.mark.parametrize("masked", [False, True])
def test_rank_hist_of_a_large_taxonomy(cuda, masked):
    """nt = 2^20 taxa from a seed (the search's last levels in device
    memory) on a 262,144-read stack, against the plain version."""
    from metacache_tpu_torch.classify import runner as R
    cls, ids, ranks, over = _hist_on(cuda, 20, 262144, 1 << 20)
    over = over if masked else None
    got = R.rank_histogram(cls, 200000, ids, ranks, over_bits=over)
    want = R.rank_histogram_plain(cls, 200000, ids, ranks, over_bits=over)
    assert torch.equal(got, want) and int(want[:NUM_RANKS].sum()) > 50000


def test_rank_hist_many_calls_in_a_row(cuda):
    """Forty calls in a row on one stream, stacks of changing size (so
    changing grids), none synchronised, each launched right after the
    one before as its programmatic dependent: each equals its plain
    version, so no launch leaves sums or a ticket behind for the next."""
    from metacache_tpu_torch.classify import runner as R
    cases = [_hist_on(cuda, 300 + i, m, off=i % 4)
             for i, m in enumerate((262144, 17, 5000, 131075, 1, 65536))]
    outs = []
    for i in range(40):
        cls, ids, ranks, over = cases[i % len(cases)]
        outs.append(R.rank_histogram(cls, cls.numel() - i, ids, ranks,
                                     over_bits=over if i % 3 else None))
    wants = []
    for i in range(40):
        cls, ids, ranks, over = cases[i % len(cases)]
        wants.append(R.rank_histogram_plain(
            cls, cls.numel() - i, ids, ranks,
            over_bits=over if i % 3 else None))
    torch.cuda.synchronize()
    for got, want in zip(outs, wants):
        assert torch.equal(got, want)


def test_rank_hist_on_two_streams_at_once(cuda):
    """Two streams launch rank_hist at the same time, twenty calls each
    on their own stacks: each result equals its plain version (a scratch
    a stream)."""
    from metacache_tpu_torch.classify import runner as R
    a = _hist_on(cuda, 41, 262144, 1023)
    b = _hist_on(cuda, 42, 262147, 1023, off=1)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    torch.cuda.synchronize()
    outs = {0: [], 1: []}
    for i in range(20):
        for s, (cls, ids, ranks, over) in enumerate((a, b)):
            with torch.cuda.stream(streams[s]):
                outs[s].append(R.rank_histogram(cls, 250000 - i, ids, ranks,
                                                over_bits=over))
    torch.cuda.synchronize()
    for s, (cls, ids, ranks, over) in enumerate((a, b)):
        for i, got in enumerate(outs[s]):
            assert torch.equal(got, R.rank_histogram_plain(
                cls, 250000 - i, ids, ranks, over_bits=over))
    keys = {(cuda.index or 0, st.cuda_stream) for st in streams}
    assert len({R._hist_scratch[k] for k in keys}) == 2


def test_rank_hist_in_a_cuda_graph(cuda):
    """rank_hist captured in a CUDA graph (the capture takes a scratch of
    its own, zeroed before the capture): every replay equals the plain
    version of that replay's stack."""
    from metacache_tpu_torch.classify import runner as R
    cls, ids, ranks, over = _hist_on(cuda, 50, 262144, 1023)
    R.rank_histogram(cls, 1000, ids, ranks)
    stack = cls.clone()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        got = R.rank_histogram(stack, 250000, ids, ranks, over_bits=over)
    for step in range(3):
        stack.copy_(torch.roll(cls, 4099 * step))
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, R.rank_histogram_plain(
            stack, 250000, ids, ranks, over_bits=over))


def test_rank_hist_graphs_replayed_at_once(cuda):
    """Two graphs captured on the same capture stream (torch.cuda.graph's
    default), each with rank_hist, replayed at the same time on two
    streams, ten times: each replay equals the plain version of its own
    stack, so the two captures share no scratch."""
    from metacache_tpu_torch.classify import runner as R
    cases = [_hist_on(cuda, 70 + i, 262144 + 3 * i, 1023, off=i)
             for i in range(2)]
    stacks = [c[0].clone() for c in cases]
    R.rank_histogram(stacks[0], 1000, cases[0][1], cases[0][2])
    torch.cuda.synchronize()
    graphs, outs = [], []
    for (cls, ids, ranks, over), stack in zip(cases, stacks):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            outs.append(R.rank_histogram(stack, 250000, ids, ranks,
                                         over_bits=over))
        graphs.append(g)
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for step in range(10):
        for (cls, *_), stack in zip(cases, stacks):
            stack.copy_(torch.roll(cls, 4099 * step))
        torch.cuda.synchronize()
        for g, st in zip(graphs, streams):
            with torch.cuda.stream(st):
                g.replay()
        torch.cuda.synchronize()
        for (cls, ids, ranks, over), stack, got in zip(cases, stacks, outs):
            assert torch.equal(got, R.rank_histogram_plain(
                stack, 250000, ids, ranks, over_bits=over))


def test_rank_histogram_is_one_kernel(cuda):
    """A rank_histogram call on CUDA tensors launches exactly one kernel,
    rank_hist's, in a torch.profiler trace: no fill of the output or of
    any scratch."""
    from torch.profiler import ProfilerActivity, profile
    from metacache_tpu_torch.classify import runner as R
    cls, ids, ranks, over = _hist_on(cuda, 60, 262144, 1023)
    R.rank_histogram(cls, 250000, ids, ranks, over_bits=over)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        got = R.rank_histogram(cls, 250000, ids, ranks, over_bits=over)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(dev) == 1 and "rank_hist" in dev[0].name, \
        [e.name for e in dev]
    assert torch.equal(got, R.rank_histogram_plain(cls, 250000, ids, ranks,
                                                   over_bits=over))


def test_launch_floor_runs(cuda):
    """The empty kernel of each of the tail's grids and of B8's launches
    and counts no kernel's launch."""
    ks = (kernels.CLASSIFY_LCA, kernels.RANK_HIST, kernels.OIDX_DECODE)
    before = [k.launches for k in ks]
    for kind, n in ((0, 8192), (0, 1), (1, 262144), (1, 0), (2, 131072),
                    (2, 0)):
        kernels.launch_floor(kind, n)
    torch.cuda.synchronize()
    assert [k.launches for k in ks] == before
