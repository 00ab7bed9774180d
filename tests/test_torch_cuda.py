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


@pytest.mark.parametrize("k", [16, 12])
@pytest.mark.parametrize("w", [255, 256, 511])
def test_long_sketch_kernel_matches_plain(cuda, w, k):
    """B2 on rows w bytes apart (unaligned from row 1 at 255 and 511),
    with ambiguous runs across chunk cuts, all-ambiguous and repeated
    windows, and valid lengths below k, at chunk bounds and random."""
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
    c = torch.from_numpy(codes).to(cuda)
    v = torch.from_numpy(valid).to(cuda)
    before = kernels.SKETCH_LONG.launches
    for s in (16, 8):
        got = S.sketch_windows(c, v, k, s)
        torch.cuda.synchronize()
        assert torch.equal(got, S.sketch_windows_long_plain(c, v, k, s))
    assert kernels.SKETCH_LONG.launches == before + 2
    # a column slice: rows 2 w bytes apart, read in place
    wide = torch.cat([c, c], dim=1)[:, :w]
    assert torch.equal(S.sketch_windows(wide, v, k, 16),
                       S.sketch_windows_long_plain(c, v, k, 16))


@pytest.mark.parametrize("mode", ["walk", "dedup"])
@pytest.mark.parametrize("presorted", [0, 64])
def test_sort_and_candidates_kernels_match_plain(cuda, mode, presorted):
    rng = np.random.default_rng(11)
    pk = _slots(rng, 256, 1024, 40, 300, 10, dup=mode == "dedup")
    if presorted:
        runs = np.sort(pk.reshape(256, -1, presorted), axis=2)
        runs[:, 1::2] = runs[:, 1::2, ::-1]
        pk = np.ascontiguousarray(runs.reshape(256, 1024))
    p = torch.from_numpy(pk).to(cuda)
    srt = C.sort_packed(p, presorted)
    assert torch.equal(srt, C.sort_packed_plain(p))
    walk, dwalk = (10, 0) if mode == "walk" else (0, 6)
    mw = torch.full((256,), 3, dtype=torch.int32, device=cuda)
    for kk in (2, 4):
        got = torch.stack(C.candidates_packed(
            srt, mw, 10, walk_elems=walk, dedup_walk=dwalk,
            max_candidates=kk, sorted_input=True), 2)
        want = C.candidates_sorted_plain(srt, mw, 10, walk, dwalk, kk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("mode", ["walk", "dedup"])
@pytest.mark.parametrize("presorted", [0, 64])
def test_unpacked_candidates_kernel_matches_plain(cuda, mode, presorted):
    """B5 on (tgt, win) rows past the packing bound (9217 targets,
    windows up to 71427), K = 1-4."""
    rng = np.random.default_rng(13)
    b, l = 256, 1024
    tgt = rng.integers(9000, 9217, (b, l))
    win = rng.integers(71300, 71428, (b, l))
    if mode == "dedup":
        d = rng.random((b, l)) < 0.5
        tgt = np.where(d, np.roll(tgt, 1, 1), tgt)
        win = np.where(d, np.roll(win, 1, 1), win)
    n = rng.integers(0, l + 1, (b, 1))
    keep = np.arange(l) < n
    tgt = np.where(keep, tgt, I32_MAX)
    win = np.where(keep, win, I32_MAX)
    if presorted:
        key = (tgt << 32 | win).reshape(b, -1, presorted)
        key = np.sort(key, axis=2)
        key[:, 1::2] = key[:, 1::2, ::-1]
        key = key.reshape(b, l)
        tgt, win = key >> 32, key & 0xFFFFFFFF
    t = torch.from_numpy(tgt.astype(np.int32)).to(cuda)
    w = torch.from_numpy(win.astype(np.int32)).to(cuda)
    walk, dwalk = (10, 0) if mode == "walk" else (0, 6)
    mw = torch.from_numpy(rng.integers(1, 7, b).astype(np.int32)).to(cuda)
    for kk in (1, 2, 3, 4):
        got = torch.stack(C.candidates_unpacked(
            t, w, mw, walk, dwalk, kk, presorted), 2)
        want = C.candidates_unpacked_plain(t, w, mw, walk, dwalk, kk)
        torch.cuda.synchronize()
        assert torch.equal(got, want)


@pytest.mark.parametrize("packing", [None, "0"])
def test_fixture_query_on_the_card_matches_golden(cuda, tmp_path,
                                                  monkeypatch, packing):
    """The golden through B1, B3 and B4 (packed slots), or through B1 and
    B5 under MC_PACK_SLOTS=0."""
    monkeypatch.delenv("MC_TORCH_DEVICE", raising=False)
    if packing is None:
        monkeypatch.delenv("MC_PACK_SLOTS", raising=False)
        path = ("sketch", "sort", "candidates")
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
    drop = ("# time:", "# speed:", "threads", DATA, "/tmp")

    def strip(text):
        return [l for l in text.splitlines()
                if not any(d in l for d in drop)]
    with open(os.path.join(DATA, "golden", "fmt_0.txt")) as f:
        assert strip(buf.getvalue()) == strip(f.read())


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
