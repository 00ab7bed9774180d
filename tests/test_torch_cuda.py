"""metacache_tpu_torch's CUDA kernels on the card: each against its plain
PyTorch version on the same CUDA tensors, the device table builder on
the card against the same builder on the CPU, and the port's query of
the fixture against the reference goldens through the kernels, with
packed and with unpacked slots, through the two-tier layout with
escalation, the classed cells and the pair-packed rows probed by B9, and
on a winlen-255 database through B2 against the CPU run; tolerance 0.

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
