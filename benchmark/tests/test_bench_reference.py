"""The plain reference against metacache_tpu_torch on the CPU, its
parts against plain Python, and the comparison that decides `correct`
against a control and against faults planted in the timed path."""
import numpy as np
import pytest
import torch

import harness
from bench_tiny import CELLS, tiny_bench
from reference import metacache as ref

SK = {"kmerlen": 16, "sketchlen": 16, "winlen": 127, "winstride": 112}
CL = {"hits_min": 0, "hits_diff_fraction": 1.0, "max_candidates": 2,
      "lowest_rank": "sequence", "highest_rank": "domain",
      "insert_size_max": 0}


@pytest.fixture
def cpu_program(monkeypatch):
    monkeypatch.setenv("MC_TORCH_DEVICE", "cpu")


def run(tmp_path, cell, seed=2**31 + 11, seconds=0.2):
    bench = tiny_bench(str(tmp_path))
    return harness.run_cell(bench, cell, seed, seconds, False, "cpu",
                            tmp_root=str(tmp_path))


# ------------------------------------------------ against the program
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [5, 2**31 + 11])
def test_reference_equals_the_program(tmp_path, cpu_program, cell, seed):
    r = run(tmp_path, cell, seed)
    assert r["correct"] and r["failed"] == 0, r["checks"]
    assert r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert ("lines_differing" in r["checks"]) == cell.endswith("tophits")
    assert ("sample_lines_differing" in r["checks"]) == \
        cell.endswith("summary")


# ------------------------------------------------------------ control
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(tmp_path, cell):
    """The reference with 16-bit features in the program's place reads
    above the limit of one of the cell's numbers."""
    import control
    bench = tiny_bench(str(tmp_path))
    r = control.readings(bench, cell, 2**31 + 11, "cpu")
    assert max(r.values()) > 0, r
    assert control.readings(bench, cell, 2**31 + 11, "cpu", bits=32) == \
        {k: 0 for k in r}


# ------------------------------------------------------------- faults
def _unchanged(orig):
    def f(*a, **k):
        tax, cls = orig(*a, **k)
        return tax, torch.zeros_like(cls)
    return f


def _half(orig):
    def f(*a, **k):
        tax, cls = orig(*a, **k)
        cls = cls.clone()
        cls[1::2] = 0                     # every other read: half of them
        return tax, cls
    return f


def _altered(orig):
    def f(*a, **k):
        tax, cls = orig(*a, **k)
        cls = cls.clone()
        i = torch.nonzero(cls)[:1, 0]
        cls[i] = 0
        return tax, cls
    return f


def _rolled(orig):
    def f(*a, **k):
        tax, cls = orig(*a, **k)
        cls = cls.clone()
        i = torch.nonzero(cls)[:, 0]      # each classified read the next
        cls[i] = torch.roll(cls[i], 1)    # classified read's taxon
        return tax, cls
    return f


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _half, _altered],
                         ids=["state_unchanged", "half_the_batch",
                              "answer_altered"])
def test_faults_fail(tmp_path, cpu_program, monkeypatch, cell, fault):
    """The classification step of the timed path returning what it was
    given (nothing classified), leaving half of each batch out, or
    altering one answer where it is made: `correct` comes out false. The
    exchange between chips does not exist in a one-chip cell."""
    import metacache_tpu_torch.ops.rows as rows
    monkeypatch.setattr(rows, "classify_with_taxa",
                        fault(rows.classify_with_taxa))
    r = run(tmp_path, cell)
    assert not r["correct"]
    assert r["failed"] == r["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_taxa_moved_between_reads_fail(tmp_path, cpu_program, monkeypatch,
                                       cell):
    """Each read given another read's taxon leaves the counts by rank as
    they were; the summary mix's sample lines, and the mapping mix's
    lines, see it, and `correct` comes out false."""
    import metacache_tpu_torch.ops.rows as rows
    monkeypatch.setattr(rows, "classify_with_taxa",
                        _rolled(rows.classify_with_taxa))
    r = run(tmp_path, cell)
    assert not r["correct"]
    assert r["checks"]["rank_count_gap"]["value"] == 0
    name = "lines_differing" if cell.endswith("tophits") else \
        "sample_lines_differing"
    assert r["checks"][name]["value"] > 0


# ------------------------------------------------- parts of the reference
def naive_sketch(codes, sk):
    """Windows' sketches of one sequence in plain Python."""
    k, s, w, st = sk["kmerlen"], sk["sketchlen"], sk["winlen"], \
        sk["winstride"]
    out, start = [], 0
    while True:
        win = codes[start:start + w]
        if len(win) < k:
            break
        feats = set()
        for i in range(len(win) - k + 1):
            km = win[i:i + k]
            if max(km) >= 4:
                continue
            v = 0
            for c in km:
                v = (v << 2) | int(c)
            rc = 0
            for c in km[::-1]:
                rc = (rc << 2) | (3 - int(c))
            x = min(v, rc)
            x = (((x >> 16) ^ x) * 0x45D9F3B) & 0xFFFFFFFF
            x = (((x >> 16) ^ x) * 0x45D9F3B) & 0xFFFFFFFF
            feats.add((x >> 16) ^ x)
        out.append(sorted(feats)[:s])
        if start + w >= len(codes):
            break
        start += st
    return out


@pytest.mark.parametrize("length", [15, 16, 100, 127, 128, 239, 240, 1000])
def test_sketch_equals_plain_python(length):
    rng = np.random.default_rng(length)
    codes = rng.integers(0, 4, length, dtype=np.uint8)
    if length > 50:
        codes[37] = 4                     # an ambiguous character
    f, seq, wid = ref.sketch(torch.from_numpy(codes),
                             np.array([0, length]), SK)
    want = naive_sketch(codes, SK)
    assert len(f) == len(want) and list(wid) == list(range(len(want)))
    for row, w in zip(f.tolist(), want):
        assert [v for v in row if v != ref.SENT] == w


def test_table_keeps_first_locations_up_to_the_cap():
    base = np.random.default_rng(0).integers(0, 4, 400, dtype=np.uint8)
    genomes = [base.copy() for _ in range(7)]
    t = ref.build_table(genomes, SK, 5, "cpu")
    counts = (t.offs[1:] - t.offs[:-1]).tolist()
    assert max(counts) == 5
    for i in range(len(counts)):
        lo, hi = int(t.offs[i]), int(t.offs[i + 1])
        locs = list(zip(t.tgt[lo:hi].tolist(), t.win[lo:hi].tolist()))
        assert locs == sorted(locs) and locs[0][0] == 0
        assert max(tg for tg, _w in locs) <= 4


def naive_candidates(locs, mwir, kk):
    """Best contiguous window range of each target, then the top kk
    (upstream's sweep, written as loops)."""
    locs = sorted(locs)
    best = {}
    for j, (tg, w) in enumerate(locs):
        n = sum(1 for t2, w2 in locs[:j + 1] if t2 == tg and w - w2 < mwir)
        best[tg] = max(best.get(tg, 0), n)
    top = sorted(best.items(), key=lambda x: (-x[1], x[0]))[:kk]
    return top


def test_candidates_equal_plain_python():
    rng = np.random.default_rng(3)
    genomes = [rng.integers(0, 4, 3000, dtype=np.uint8) for _ in range(3)]
    genomes += [genomes[0].copy(), genomes[1].copy()]
    for g in genomes[3:]:
        g[rng.integers(0, 3000, 60)] = rng.integers(0, 4, 60)
    t = ref.build_table(genomes, SK, 254, "cpu")
    lens = rng.integers(50, 900, 40)
    gsel = rng.integers(0, 5, 40)
    pos = [rng.integers(0, 3000 - n) for n in lens]
    codes = np.concatenate([genomes[g][p:p + n]
                            for g, p, n in zip(gsel, pos, lens)])
    offs = np.concatenate([[0], np.cumsum(lens)])
    tgt, hits, per_read, _nf = ref.candidates(
        t, torch.from_numpy(codes), offs, SK, CL, chunk_locations=300)
    f, wseq, _w = ref.sketch(torch.from_numpy(codes), offs, SK)
    for r in range(40):
        locs = []
        for row in f[torch.from_numpy(wseq == r)].tolist():
            for v in row:
                i = np.searchsorted(t.uniq.numpy(), v)
                if v != ref.SENT and i < len(t.uniq) and t.uniq[i] == v:
                    lo, hi = int(t.offs[i]), int(t.offs[i + 1])
                    locs += list(zip(t.tgt[lo:hi].tolist(),
                                     t.win[lo:hi].tolist()))
        assert per_read[r] == len(locs)
        want = naive_candidates(locs, 2 + int(lens[r]) // 112, 2)
        got = [(int(a), int(b)) for a, b in zip(tgt[r], hits[r]) if a >= 0]
        assert got == want, r


def test_classify_ranked_lca():
    # targets 0, 1 in species 10 (genus 20); target 2 in species 11 (genus
    # 20); target 3 in species 12 (genus 21); all in domain 2
    nodes = {1: (1, "no rank", "root"), 2: (1, "superkingdom", "B"),
             20: (2, "genus", "g20"), 21: (2, "genus", "g21"),
             10: (20, "species", "s10"), 11: (20, "species", "s11"),
             12: (21, "species", "s12")}
    lin = torch.from_numpy(ref.lineage_table(np.array([10, 10, 11, 12]),
                                             nodes))
    tgt = torch.tensor([[0, 1], [0, 2], [0, 3], [0, 3], [2, -1], [1, 0],
                        [-1, -1]])
    hits = torch.tensor([[9, 9], [9, 9], [9, 9], [9, 4], [4, 0], [16, 11],
                         [0, 0]])
    ranks, taxa = ref.classify(tgt, hits, lin, CL, 16)
    # row 3: 4 hits are not above 9 - 5; row 5: 11 not above 16 - 5
    assert ranks.tolist() == [4, 6, 19, 0, ref.RANK_NONE, 0, ref.RANK_NONE]
    assert taxa.tolist() == [10, 20, 2, -1, 0, -2, 0]


# --------------------------------------------------------------- on card
@pytest.mark.cuda
def test_reference_on_card_equals_cpu(cuda):
    rng = np.random.default_rng(9)
    genomes = [rng.integers(0, 4, 20000, dtype=np.uint8) for _ in range(6)]
    codes = np.concatenate([g[:3000] for g in genomes])
    offs = np.arange(0, len(codes) + 1, 150)
    out = []
    for dev in ("cpu", cuda):
        t = ref.build_table(genomes, SK, 254, dev)
        tg, h, n, nf = ref.candidates(t, torch.from_numpy(codes).to(dev),
                                      offs, SK, CL)
        out.append((tg.cpu(), h.cpu(), n.cpu(), nf))
    assert all(torch.equal(a, b) for a, b in zip(out[0][:3], out[1][:3]))
    assert out[0][3] == out[1][3]
