#!/usr/bin/env python3
"""Smoke run of metacache_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each against its plain PyTorch version on the card, then drives
the port's query paths through its entry points, each at a scale its
users run:

- packed slots, dense rows: `build` of the RefSeq-skew database (64
  unique + 12 x 52-strain + 1 x 256-strain genomes of 1 Mbp, 944 Mbp,
  buckets at the 254 cap), whose (target, window) slots pack into int32,
  and `query` through kernels B1, B3 and B4;
- unpacked slots: `build` of a many-target database (one 8 Mbp genome
  plus 36 species x 256 strains of 50 kbp, 9217 targets, 469 Mbp), whose
  slots do not pack into int32, and `query` through B1 and B5; once more
  with MC_DENSE_LIMIT=1, which stages it two-tier;
- packed slots, two-tier rows: `build` of the 1456 Mbp database (the
  RefSeq-skew generator with 576 unique genomes), whose dense rows exceed
  the card's budget, and `query` with escalation: a head-only phase
  through B1, B6, B3 and B4, and a full-depth redo of the reads that
  touched a deeper bucket through B7, B3 and B4; once more with
  MC_ESCALATE=0 (B7 on every batch), which must give the same result.

Each path queries 2^20 100 bp reads on the summary path, 65,536 reads
on the per-read path, and one batch of the scan step compared with the
plain path on CPU tensors of the same tables.

Run from the repository root with no arguments:  python3 chip_smoke.py
It exits non-zero without a CUDA device. Its last stdout line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# the port must never import JAX or the JAX package
sys.modules["jax"] = None
sys.modules["metacache_tpu"] = None

import numpy as np  # noqa: E402
import torch  # noqa: E402

from metacache_tpu_torch.db.database import Database  # noqa: E402

I32_MAX = 2**31 - 1
READ_LEN = 100
GENOME_LEN = 1_000_000
SCAN_BATCH = 8192      # reads per summary batch on the card (runner.py)
# the least time of a kernel: the larger of its bytes over the card's
# memory rate and its integer operations over the 32-bit rate outside
# the tensor cores (H100 SXM, NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
CARD = ""


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def say(phase: str, **kv):
    print(f"[{phase}] card={CARD!r} " +
          " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def device_ms(fn, reps: int = 4) -> float:
    """Mean device milliseconds per call: the time of the kernels
    themselves in a torch.profiler trace of ``reps`` calls after a
    warm-up, without the gaps between launches."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / 1e3 / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max().item()) \
        if a.numel() else 0


def check_equal(name: str, a, b) -> int:
    err = max_abs_err(a, b)
    if err != 0:
        raise AssertionError(f"{name}: kernel != plain version "
                             f"(max abs err {err})")
    return err


def bound(nbytes: float, nops: float):
    """-> (least ms, "bytes" or "operations"). ``nbytes`` counts each
    input byte read once and each output byte written once; ``nops`` is
    the least integer work of the function on these inputs (the models
    in the parity phase), not the work of the kernel's algorithm."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = nops / INT32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def sort_ops(rows: int, l2: int, run: int, word_ops: int) -> float:
    """Merging sorted runs of ``run`` lanes into rows of l2: one compare
    and one move per lane and merge level, ``word_ops`` 32-bit
    operations each."""
    return rows * l2 * max(1, (l2 // run).bit_length() - 1) * 2 * word_ops


# ---------------------------------------------------------------- data
def sketch_inputs(rng, n: int):
    """(n, 128) windows with ambiguous codes, short and exact-k windows,
    valid = 127, and repeated content (duplicate hashes)."""
    codes = rng.integers(0, 4, (n, 128), dtype=np.uint8)
    valid = np.full(n, 127, np.int32)
    amb = rng.random((n, 128)) < 0.01
    codes[amb] = 4
    codes[3::97, 20:60] = 4
    codes[5::89] = np.tile(np.array([0, 1, 2, 3], np.uint8), 32)
    valid[7::13] = rng.integers(0, 16, len(valid[7::13]))   # < k
    valid[11::17] = 16                                      # one k-mer
    valid[2::19] = rng.integers(16, 128, len(valid[2::19]))
    codes[:, 127] = 4
    return codes, valid


def slot_pairs(rng, b: int, l: int, ntgt: int = 9217, nwin: int = 71428):
    """(b, l) unsorted (tgt, win) rows shaped like unpacked deep-bucket
    reads: most slots in one 256-strain group at two neighbouring
    windows, the rest noise, targets and windows past the packing
    bound; (I32_MAX, I32_MAX) padding at the end of each row."""
    base = rng.integers(0, ntgt - 256, (b, 1))
    win = rng.integers(0, nwin - 1, (b, 1))
    noise = rng.random((b, l)) < 0.3
    tgt = np.where(noise, rng.integers(0, ntgt, (b, l)),
                   base + rng.integers(0, 256, (b, l)))
    w = np.where(noise, rng.integers(0, nwin, (b, l)),
                 win + rng.integers(0, 2, (b, l)))
    n = rng.integers(0, l + 1, (b, 1))
    keep = np.arange(l)[None, :] < n
    return (np.where(keep, tgt, I32_MAX).astype(np.int32),
            np.where(keep, w, I32_MAX).astype(np.int32))


def alternating_pairs(rng, b: int, f: int, r: int):
    """(b, f * r) (tgt, win) rows as the probe emits them for
    alt_runs = r: each feature's run sorted, padding last, odd runs
    reversed."""
    t, w = slot_pairs(rng, b * f, r)
    key = np.sort((t.astype(np.int64) << 32) | w, axis=1).reshape(b, f, r)
    key[:, 1::2] = key[:, 1::2, ::-1]
    key = key.reshape(b, f * r)
    return (np.ascontiguousarray(key >> 32).astype(np.int32),
            np.ascontiguousarray(key & 0xFFFFFFFF).astype(np.int32))


def slot_rows(rng, b: int, l: int, wbits: int = 15):
    """(b, l) sorted packed slots shaped like deep-bucket reads: most
    slots fall in one strain group at two neighbouring windows, the rest
    are noise; I32_MAX padding at the end of each row."""
    base = rng.integers(0, 900, (b, 1))
    win = rng.integers(0, 8000, (b, 1))
    grp = base + rng.integers(0, 52, (b, l))
    gw = win + rng.integers(0, 2, (b, l))
    noise = rng.random((b, l)) < 0.3
    tgt = np.where(noise, rng.integers(0, 944, (b, l)), grp)
    w = np.where(noise, rng.integers(0, 8929, (b, l)), gw)
    pk = (tgt.astype(np.int64) << wbits) | w
    n = rng.integers(0, l + 1, (b, 1))
    pk = np.where(np.arange(l)[None, :] < n, pk, I32_MAX)
    return np.sort(pk, axis=1).astype(np.int32)


def alternating_runs(rng, b: int, f: int, r: int, wbits: int = 15):
    """(b, f * r) slots as the probe emits them for alt_runs = r: each
    feature's run sorted, padded with I32_MAX, odd runs reversed."""
    pk = slot_rows(rng, b * f, r, wbits).reshape(b, f, r)
    pk[:, 1::2] = pk[:, 1::2, ::-1]
    return np.ascontiguousarray(pk.reshape(b, f * r))


# copied from bench.py:44-63 (the strain genome generator)
def make_strain_genomes(rng, specs, glen):
    genomes = []
    species = []
    sp = 0
    for bases, strains, mut in specs:
        for b in range(bases):
            base = rng.integers(0, 4, glen, dtype=np.uint8)
            for s in range(strains):
                g = base if s == 0 else base.copy()
                if s and mut:
                    nmut = int(glen * mut)
                    pos = rng.integers(0, glen, nmut)
                    g[pos] = rng.integers(0, 4, nmut, dtype=np.uint8)
                genomes.append(g)
                species.append(sp)
            sp += 1
    return genomes, np.asarray(species, np.int32)


ACGT = np.frombuffer(b"ACGT", np.uint8)


def write_reference(tmp, genomes, species):
    fa = os.path.join(tmp, "genomes.fa")
    with open(fa, "wb") as f:
        for i, g in enumerate(genomes):
            f.write(b">GEN%05d.1 taxid|%d| strain genome\n"
                    % (i, 1000 + int(species[i])))
            f.write(ACGT[g].tobytes() + b"\n")
    tax = os.path.join(tmp, "taxonomy")
    os.makedirs(tax)
    nsp = int(species.max()) + 1
    with open(os.path.join(tax, "nodes.dmp"), "w") as f:
        f.write("1\t|\t1\t|\tno rank\t|\n2\t|\t1\t|\tsuperkingdom\t|\n")
        for s in range(nsp):
            f.write(f"{1000 + s}\t|\t2\t|\tspecies\t|\n")
    with open(os.path.join(tax, "names.dmp"), "w") as f:
        f.write("1\t|\troot\t|\t\t|\tscientific name\t|\n")
        f.write("2\t|\tBacteria\t|\t\t|\tscientific name\t|\n")
        for s in range(nsp):
            f.write(f"{1000 + s}\t|\tspecies {s}\t|\t\t|\t"
                    "scientific name\t|\n")
    open(os.path.join(tax, "merged.dmp"), "w").close()
    return fa, tax


def sample_reads(rng, genomes, n: int):
    """n reads of READ_LEN from uniformly drawn genomes (of any lengths)
    and positions, with Poisson(1) substitutions (the draw of
    bench.py:149-159)."""
    glen = np.array([len(g) for g in genomes])
    gsel = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, glen[gsel] - READ_LEN)
    reads = np.empty((n, READ_LEN), np.uint8)
    for g in np.unique(gsel):
        sel = np.nonzero(gsel == g)[0]
        reads[sel] = genomes[g][pos[sel, None] + np.arange(READ_LEN)]
    nm = rng.poisson(READ_LEN / 100, n)
    rows = np.repeat(np.arange(n), nm)
    reads[rows, rng.integers(0, READ_LEN, len(rows))] = \
        rng.integers(0, 4, len(rows), dtype=np.uint8)
    return reads


def write_reads(path, reads):
    with open(path, "wb") as f:
        lines = ACGT[reads]
        for i in range(len(reads)):
            f.write(b">r%d\n" % i + lines[i].tobytes() + b"\n")


# -------------------------------------------------------------- phases
def phase_kernels():
    from metacache_tpu_torch import kernels, native
    t0 = time.time()
    path = kernels.build(verbose=True)
    say("build-kernels", seconds=round(time.time() - t0, 3),
        library=os.path.relpath(path))
    t0 = time.time()
    if native.get_lib() is None:
        raise AssertionError("native reader library did not build or load")
    say("build-native-reader", seconds=round(time.time() - t0, 3),
        library=os.path.relpath(native.library_path()))


def _record(results, name, *, err, ms, plain_ms, nbytes, nops, shape,
            library_ms=None):
    b_ms, by = bound(nbytes, nops)
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                         shape=shape)
    return b_ms, by


def phase_parity(results):
    """Each kernel against its plain version at the main path's shapes,
    tolerance 0 (integer outputs). The launches made here are not the
    main path's: the counts are zeroed before each query."""
    from metacache_tpu_torch.ops import candidates as C
    from metacache_tpu_torch.ops import sketch as S
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)

    n = 65536
    codes, valid = sketch_inputs(rng, n)
    c = torch.from_numpy(codes).to(dev)
    v = torch.from_numpy(valid).to(dev)
    got = S.sketch_windows(c, v, 16, 16)
    want = S.sketch_windows_plain(c, v, 16, 16)
    err = check_equal("B1 sketch", got, want)
    ms = cuda_ms(lambda: S.sketch_windows(c, v, 16, 16))
    pms = cuda_ms(lambda: S.sketch_windows_plain(c, v, 16, 16))
    # per k-mer position: 2-bit update, reverse complement, canonical
    # min and hash (~20 ops), plus ~2 to keep the s smallest
    kpos = int(np.maximum(valid.astype(np.int64) - 15, 0).sum())
    b_ms, by = _record(results, "sketch", err=err, ms=ms, plain_ms=pms,
                       nbytes=codes.nbytes + valid.nbytes + n * 16 * 4,
                       nops=22 * kpos,
                       shape="(65536, 128) windows, k=16, s=16")
    say("parity-B1", windows=n, tolerance=0, max_abs_err=err, ms=ms,
        plain_ms=pms, bound_ms=b_ms, bound_by=by)

    b, l2, r = 8192, 4096, 256
    alt = torch.from_numpy(alternating_runs(rng, b, 16, r)).to(dev)
    rnd = torch.from_numpy(
        rng.permuted(slot_rows(rng, b, l2), axis=1)).to(dev)
    errs = []
    for name, pk, pre in (("presorted256", alt, r), ("unsorted", rnd, 0)):
        got = C.sort_packed(pk, pre)
        errs.append(check_equal(f"B3 sort {name}", got,
                                C.sort_packed_plain(pk, pre)))
    ms = cuda_ms(lambda: C.sort_packed(alt, r))
    pms = cuda_ms(lambda: C.sort_packed_plain(alt, r))
    lib = cuda_ms(lambda: torch.sort(alt, dim=1))
    b_ms, by = _record(results, "sort", err=max(errs), ms=ms, plain_ms=pms,
                       library_ms=lib, nbytes=2 * alt.numel() * 4,
                       nops=sort_ops(b, l2, r, 1),
                       shape="(8192, 4096) slots, presorted=256")
    say("parity-B3", rows=b, width=l2, tolerance=0, max_abs_err=max(errs),
        ms=ms, plain_ms=pms, library_ms=lib, bound_ms=b_ms, bound_by=by,
        unsorted_case_err=errs[1])

    srt = torch.from_numpy(slot_rows(rng, b, l2)).to(dev)
    mw = torch.full((b,), 2, dtype=torch.int32, device=dev)
    errs = []
    for kk in (2, 4):
        got = torch.stack(C.candidates_packed(
            srt, mw, 15, walk_elems=32, max_candidates=kk,
            sorted_input=True), dim=2)
        want = C.candidates_sorted_plain(srt, mw, 15, walk_elems=32,
                                         max_candidates=kk)
        errs.append(check_equal(f"B4 walk K={kk}", got, want))
    dsr = torch.from_numpy(slot_rows(rng, 2048, 1024)).to(dev)
    dmw = torch.full((2048,), 6, dtype=torch.int32, device=dev)
    got = torch.stack(C.candidates_packed(
        dsr, dmw, 15, dedup_walk=6, max_candidates=2, sorted_input=True),
        dim=2)
    want = C.candidates_sorted_plain(dsr, dmw, 15, dedup_walk=6,
                                     max_candidates=2)
    errs.append(check_equal("B4 dedup", got, want))
    ms = cuda_ms(lambda: C.candidates_packed(
        srt, mw, 15, walk_elems=32, max_candidates=2, sorted_input=True))
    pms = cuda_ms(lambda: C.candidates_sorted_plain(
        srt, mw, 15, walk_elems=32, max_candidates=2))
    # a two-pointer sweep (~4 ops per lane) and K = 2 max + mask rounds
    b_ms, by = _record(results, "candidates", err=max(errs), ms=ms,
                       plain_ms=pms, nbytes=srt.numel() * 4 + b * 4
                       + b * 2 * 16, nops=srt.numel() * (4 + 2 * 2),
                       shape="(8192, 4096) sorted slots, walk 32, K=2")
    say("parity-B4", rows=b, width=l2, tolerance=0, max_abs_err=max(errs),
        ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        dedup_case="(2048, 1024) dedup_walk=6")

    at, aw = (torch.from_numpy(x).to(dev)
              for x in alternating_pairs(rng, b, 16, r))
    st, sw = (torch.from_numpy(x).to(dev) for x in slot_pairs(rng, b, l2))
    mw = torch.full((b,), 2, dtype=torch.int32, device=dev)
    errs = {}
    for name, (tt, ww, pre) in (("alt256", (at, aw, r)),
                                ("shuffled", (st, sw, 0))):
        for kk in (2, 4):
            got = torch.stack(C.candidates_unpacked(
                tt, ww, mw, walk_elems=32, max_candidates=kk,
                presorted=pre), dim=2)
            want = C.candidates_unpacked_plain(tt, ww, mw, walk_elems=32,
                                               max_candidates=kk)
            errs[f"{name}_K{kk}"] = check_equal(
                f"B5 walk {name} K={kk}", got, want)
    dt_, dw_ = (torch.from_numpy(x).to(dev)
                for x in slot_pairs(rng, 2048, 1024))
    got = torch.stack(C.candidates_unpacked(
        dt_, dw_, dmw, dedup_walk=6, max_candidates=2), dim=2)
    want = C.candidates_unpacked_plain(dt_, dw_, dmw, dedup_walk=6,
                                       max_candidates=2)
    errs["dedup"] = check_equal("B5 dedup", got, want)
    ms = cuda_ms(lambda: C.candidates_unpacked(
        at, aw, mw, walk_elems=32, max_candidates=2, presorted=r))
    pms = cuda_ms(lambda: C.candidates_unpacked_plain(
        at, aw, mw, walk_elems=32, max_candidates=2))
    # the (tgt, win) merge of B3's model on two-word keys, then B4's
    # sweep with the target and window compares apart
    b_ms, by = _record(results, "candidates_unpacked",
                       err=max(errs.values()), ms=ms, plain_ms=pms,
                       nbytes=2 * at.numel() * 4 + b * 4 + b * 2 * 16,
                       nops=sort_ops(b, l2, r, 2) + at.numel() * (6 + 4),
                       shape="(8192, 4096) (tgt, win) slots, presorted=256,"
                             " walk 32, K=2")
    say("parity-B5", rows=b, width=l2, tolerance=0,
        max_abs_err=max(errs.values()), cases=errs, ms=ms, plain_ms=pms,
        bound_ms=b_ms, bound_by=by, dedup_case="(2048, 1024) dedup_walk=6")

    phase_parity_decode(results, rng, dev)


def two_tier_table(rng, nf: int, hsl: int = 61, spf: int = 254):
    """Head rows [feature, count, ovf_idx, 61 slots] and overflow rows
    built as tests/test_probe_pallas.py builds them, with 80% of the
    counts at or below the head and 20% above it."""
    feats = np.sort(rng.choice(2**31 - 2, nf, replace=False)) + 1
    deep = rng.random(nf) < 0.2
    cnts = np.where(deep, rng.integers(hsl + 1, spf + 1, nf),
                    rng.integers(1, hsl + 1, nf))
    head = np.empty((nf, 64), np.int32)
    head[:, 0] = feats
    head[:, 1] = cnts
    head[:, 2] = 0
    novf = int(deep.sum())
    head[deep, 2] = np.arange(1, novf + 1)
    head[:, 3:] = rng.integers(0, 2**30, (nf, 61), dtype=np.int32)
    ovf = np.zeros((novf + 1, 200), np.int32)
    ovf[1:, :spf - hsl] = rng.integers(0, 2**30, (novf, spf - hsl),
                                       dtype=np.int32)
    return feats, head, ovf


def decode_probes(rng, feats, n: int):
    """n probe rows: 30% misses, 1% sentinels, 1% indices past the
    table."""
    nf = len(feats)
    idx = rng.integers(0, nf, n)
    flat = feats[idx].copy()
    miss = rng.random(n) < 0.3
    flat[miss] = rng.integers(1, 2**31 - 1, int(miss.sum()))
    flat[::97] = -1
    idx[::101] = nf + 5
    return idx.astype(np.int32), flat.astype(np.int32)


def phase_parity_decode(results, rng, dev):
    """B6 and B7 at the main path's 131,072 probes (8192 reads x 16
    features) on a 2 M-feature table (512 MB of head rows, past the L2
    cache), against their plain versions."""
    from metacache_tpu_torch.ops import probe_decode as D
    n, f, hsl, c = 131072, 16, 61, 254
    feats, head_np, ovf_np = two_tier_table(rng, 1 << 21)
    idx_np, flat_np = decode_probes(rng, feats, n)
    head, ovf, idx, flat = (torch.from_numpy(a).to(dev) for a in
                            (head_np, ovf_np, idx_np, flat_np))
    # what the data needs: per probe its index and feature, the three
    # meta lanes, the slots its count keeps; the outputs once
    row = head_np[np.minimum(idx_np, len(feats) - 1)]
    cnt = np.where((row[:, 0] == flat_np) & (flat_np != -1), row[:, 1], 0)
    errs = []
    for rl in (64, 256):
        pk, cn = D.head_decode(head, idx, flat, hsl, rl, f)
        wpk, wcn = D.head_decode_plain(head, idx, flat, hsl, rl, f)
        errs += [check_equal(f"B6 rl={rl}", pk, wpk),
                 check_equal(f"B6 cnt rl={rl}", cn, wcn)]
    ms = cuda_ms(lambda: D.head_decode(head, idx, flat, hsl, 64, f))
    pms = cuda_ms(lambda: D.head_decode_plain(head, idx, flat, hsl, 64, f))
    kept = int(np.minimum(cnt, hsl).sum())
    b_ms, by = _record(results, "head_decode", err=max(errs), ms=ms,
                       plain_ms=pms, nbytes=n * (8 + 12 + 4 + 64 * 4)
                       + kept * 4, nops=n * 64 * 2,
                       shape="131072 probes, f=16, hsl=61, rl=64")
    say("parity-B6", probes=n, tolerance=0, max_abs_err=max(errs), ms=ms,
        plain_ms=pms, bound_ms=b_ms, bound_by=by,
        deep_share=round(float((cnt > hsl).mean()), 4),
        miss_share=round(float((cnt == 0).mean()), 4))

    errs = []
    for rl, ff in ((256, f), (512, f), (256, 1)):
        got = D.full_decode(head, ovf, idx, flat, hsl, c, rl, ff)
        want = D.full_decode_plain(head, ovf, idx, flat, hsl, c, rl, ff)
        errs.append(check_equal(f"B7 rl={rl} f={ff}", got, want))
    ms = cuda_ms(lambda: D.full_decode(head, ovf, idx, flat, hsl, c, 256, f))
    pms = cuda_ms(lambda: D.full_decode_plain(head, ovf, idx, flat, hsl, c,
                                              256, f))
    b_ms, by = _record(results, "full_decode", err=max(errs), ms=ms,
                       plain_ms=pms, nbytes=n * (8 + 12 + 256 * 4)
                       + int(cnt.sum()) * 4, nops=n * 256 * 2,
                       shape="131072 probes, f=16, hsl=61, c=254, rl=256")
    say("parity-B7", probes=n, tolerance=0, max_abs_err=max(errs), ms=ms,
        plain_ms=pms, bound_ms=b_ms, bound_by=by,
        cases="rl 256/512 f=16, rl 256 f=1")


def phase_build(tmp, name, genomes, species, gen_s):
    """`build` through the CLI; -> (database path, max window)."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.cli.main import main as cli
    t0 = time.time()
    sub = os.path.join(tmp, name)
    os.makedirs(sub)
    fa, tax = write_reference(sub, genomes, species)
    gen_s += time.time() - t0
    db = os.path.join(sub, "db")
    before = kernels.SKETCH.launches
    t0 = time.time()
    rc = cli(["build", db, fa, "-taxonomy", tax])
    build_s = time.time() - t0
    if rc != 0:
        raise AssertionError(f"build exited with {rc}")
    launches = kernels.SKETCH.launches - before
    if launches <= 0:
        raise AssertionError("build did not launch the sketch kernel")
    os.remove(fa)
    p = Database.load(db).parts[0]
    maxwin = int((p.locations & np.uint64(0xFFFFFFFF)).max())
    say(f"build-{name}", genomes=len(genomes),
        bases=sum(len(g) for g in genomes), features=p.num_features,
        locations=p.num_locations, max_bucket=p.max_bucket_size,
        max_window=maxwin, seconds=round(build_s, 3),
        data_gen_seconds=round(gen_s, 3), sketch_launches=launches)
    return db, maxwin


def _query(db_path, reads_path, args, out):
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import (QueryRunner,
                                                     map_queries_to_targets)
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    opt, _, _ = parse_query_options(Args(list(args)))
    db = Database.load(db_path)
    t0 = time.time()
    runner = QueryRunner(db, opt)
    torch.cuda.synchronize()
    stage_s = time.time() - t0
    res = ClassificationResults(out, out, out)
    map_queries_to_targets([reads_path], db, opt, res, runner)
    torch.cuda.synchronize()
    return runner, res, stage_s


def phase_query_summary(tmp, name, db, reads, layout, expect):
    """A main path: counts are zeroed just before it and read just
    after, so its launches are its own. ``expect(runner, batches)`` gives
    the launches each kernel must show. ``reads``: the reads to write,
    or the count of those an earlier phase wrote.
    -> (runner, launches, results)"""
    from metacache_tpu_torch import kernels
    path = os.path.join(tmp, name, "reads.fa")
    if isinstance(reads, int):
        nreads = reads
    else:
        nreads = len(reads)
        write_reads(path, reads)
    kernels.reset_counts()
    runner, res, stage_s = _query(db, path, ["-no-map"], io.StringIO())
    grew = {k: v.launches for k, v in kernels.ALL.items()}
    if not layout(runner) if callable(layout) else runner.layout != layout:
        raise AssertionError(f"layout {runner.layout} with pack bits "
                             f"{runner._pack_bits}, expected {layout}")
    want = expect(runner, -(-nreads // SCAN_BATCH))
    if grew != want:
        raise AssertionError(f"launches {grew}, expected {want}")
    n = res.statistics.total()
    if n != nreads:
        raise AssertionError(f"classified {n} of {nreads} reads")
    frac = res.statistics.assigned() / n
    rpm = n / (res.time_ms / 60000.0)
    say(f"query-summary-{name}", reads=n, reads_per_min=round(rpm),
        seconds=round(res.time_ms / 1000, 3),
        classified_fraction=round(frac, 6), layout=runner.layout.replace(
            " ", ""), pack_bits=runner._pack_bits, spf=runner.tables.spf,
        staged_table_gib=round(runner.tables.nbytes() / 2**30, 3),
        staging_seconds=round(stage_s, 3), launches=grew)
    if not frac > 0.5:
        raise AssertionError(f"classified fraction {frac} too low")
    return runner, grew, res


def path_of(*names):
    """Launch expectation of a dense path: each named kernel once per
    8192-read batch, every other kernel never."""
    from metacache_tpu_torch import kernels
    return lambda runner, batches: {
        k: batches if k in names else 0 for k in kernels.ALL}


def phase_profile(tmp, name, runner, tag=""):
    """Trace a second, warm summary query of the same reads: device time
    by kernel and the device's busy share of the query's wall time."""
    from torch.profiler import ProfilerActivity, profile
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import map_queries_to_targets
    res = ClassificationResults(io.StringIO(), io.StringIO(), io.StringIO())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        map_queries_to_targets([os.path.join(tmp, name, "reads.fa")],
                               runner.db, runner.opt, res, runner)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    say(f"profile-{name}{tag}", wall_seconds=round(wall, 3),
        device_busy_seconds=round(busy_us / 1e6, 3),
        device_idle_share=round(1 - busy_us / 1e6 / wall, 3))
    evs.sort(key=lambda e: -e.self_device_time_total)
    for e in evs[:20]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:7d} x  {e.key[:90]}")


def phase_query_per_read(tmp, name, db, reads):
    path = os.path.join(tmp, name, "reads_per_read.fa")
    write_reads(path, reads)
    out_path = os.path.join(tmp, name, "mapping.txt")
    with open(out_path, "w") as out:
        runner, res, _ = _query(db, path, [], out)
    with open(out_path) as f:
        lines = [l for l in f if not l.startswith("#")]
    if len(lines) != len(reads):
        raise AssertionError(f"{len(lines)} mapping lines for "
                             f"{len(reads)} reads")
    say(f"query-per-read-{name}", reads=len(reads),
        mapping_lines=len(lines), seconds=round(res.time_ms / 1000, 3))
    del runner


def phase_e2e(name, runner, reads, dev=torch.device("cuda")):
    from metacache_tpu_torch.ops.rows import query_step_rows_scan
    b = min(8192, len(reads))
    c4 = np.zeros((b, 128), np.uint8)
    c4[:, :READ_LEN] = reads[:b]
    packed = (c4[:, 0::4] | (c4[:, 1::4] << 2) | (c4[:, 2::4] << 4) |
              (c4[:, 3::4] << 6)).reshape(1, b, 1, 32)
    vmat = np.full((1, b, 1), READ_LEN, np.uint8)
    mwir = np.full((1, b), 2, np.uint8)
    t = runner.tables
    cpu = t.cpu_copy()
    kw = dict(k=16, sketchlen=16, windows_per_query=1, max_candidates=2,
              walk_elems=32, fast_top2=True, pack_bits=runner._pack_bits,
              infeed_packed=True)
    args = (runner.hits_min, 1.0, runner.highest_rank, runner.merge_rank)
    got = query_step_rows_scan(
        torch.from_numpy(packed).to(dev), torch.from_numpy(vmat).to(dev),
        torch.from_numpy(mwir).to(dev), t, *args, **kw).cpu()
    want = query_step_rows_scan(
        torch.from_numpy(packed), torch.from_numpy(vmat),
        torch.from_numpy(mwir), cpu, *args, **kw)
    err = check_equal("end-to-end cls", got, want)
    say(f"e2e-parity-{name}", reads=b, tolerance=0, max_abs_err=err,
        classified=int((got != 0).sum()))


def run_config(tmp, name, db, genomes, layout, path_kernels, profile):
    """Summary query (the main path), its profile, the scan step against
    the plain path, and the per-read path; -> the summary's launches and
    rank histogram."""
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20)
    del genomes
    runner, launches, res = phase_query_summary(
        tmp, name, db, reads, layout, path_of(*path_kernels))
    if profile:
        phase_profile(tmp, name, runner)
    phase_e2e(name, runner, reads)
    del runner
    torch.cuda.empty_cache()
    phase_query_per_read(tmp, name, db, reads[:65536])
    torch.cuda.empty_cache()
    return launches, res.statistics.assigned_.copy()


def refseq_skew_genomes():
    """64 unique + 12 x 52-strain + 1 x 256-strain genomes of 1 Mbp."""
    return make_strain_genomes(
        np.random.default_rng(42),
        [(64, 1, 0.0), (12, 52, 0.003), (1, 256, 0.003)], GENOME_LEN)


def many_target_genomes():
    """One unique 8 Mbp genome (max window 71,428, so 18 window bits)
    plus 36 species x 256 strains of 50 kbp at 0.3% substitutions:
    9217 targets, and ((9217 - 1) << 18) | 71428 > I32_MAX."""
    rng = np.random.default_rng(43)
    big, sp_big = make_strain_genomes(rng, [(1, 1, 0.0)], 8_000_000)
    strains, sp = make_strain_genomes(rng, [(36, 256, 0.003)], 50_000)
    return big + strains, np.concatenate([sp_big, sp + 1])


def two_tier_genomes():
    """The RefSeq-skew generator with 512 more unique genomes and its own
    seed: 576 unique + 12 x 52-strain + 1 x 256-strain genomes of 1 Mbp,
    1456 Mbp, whose dense rows (~80 M features of 1 KiB) exceed an 80 GB
    card's ~63 GiB budget by ~20%."""
    return make_strain_genomes(
        np.random.default_rng(44),
        [(576, 1, 0.0), (12, 52, 0.003), (1, 256, 0.003)], GENOME_LEN)


def packed_stack(reads, b: int):
    """The first b reads as one stack of 2-bit packed infeed rows (the
    native reader's layout): (1, b, 1, 32) u8, lengths, mwir 2."""
    c4 = np.zeros((b, 128), np.uint8)
    c4[:, :READ_LEN] = reads[:b]
    packed = (c4[:, 0::4] | (c4[:, 1::4] << 2) | (c4[:, 2::4] << 4) |
              (c4[:, 3::4] << 6)).reshape(1, b, 1, 32)
    return (torch.from_numpy(packed), torch.full((1, b, 1), READ_LEN,
                                                 dtype=torch.uint8),
            torch.full((1, b), 2, dtype=torch.uint8))


def phase_e2e_two_tier(name, runner, reads, dev=torch.device("cuda")):
    """The escalation steps on one 8192-read stack against the plain path
    on CPU tensors of the same tables (the host holds the second copy):
    phase 1 (B1, B6, B3, B4) and the redo of its flagged reads (B7, B3,
    B4); their merge also equals the full-depth scan (B7) on the card.
    Times one phase-1 batch and one full redo batch."""
    from metacache_tpu_torch.ops import rows as R
    b = SCAN_BATCH
    stack = packed_stack(reads, b)
    t = runner.tables
    t0 = time.time()
    cpu = t.cpu_copy()
    copy_s = time.time() - t0
    args = (runner.hits_min, 1.0, runner.highest_rank, runner.merge_rank)
    kw = dict(k=16, sketchlen=16, max_candidates=2, walk_elems=32,
              fast_top2=True, pack_bits=runner._pack_bits,
              infeed_packed=True)
    dstack = [x.to(dev) for x in stack]
    got = [x.cpu() for x in R.query_step_rows_scan_head(*dstack, t, *args,
                                                         **kw)]
    want = R.query_step_rows_scan_head(*stack, cpu, *args, **kw)
    err = max(check_equal(f"phase 1 {i}", g, w)
              for i, (g, w) in enumerate(zip(got, want)))
    bits = got[1].numpy().reshape(-1)
    mask = ((bits[:, None] >> np.arange(32)) & 1).astype(bool).reshape(-1)
    sel = torch.from_numpy(np.nonzero(mask)[0])
    rkw = dict(max_candidates=2, walk_elems=32, fast_top2=True,
               pack_bits=runner._pack_bits)
    fk, ik = got[2].reshape(b, -1)[sel], got[3].reshape(b, -1)[sel]
    mw = stack[2].reshape(-1)[sel]
    red = R.query_step_rows_redo(fk.to(dev), ik.to(dev), mw.to(dev), t,
                                 *args, **rkw).cpu()
    err = max(err, check_equal("redo", red, R.query_step_rows_redo(
        fk, ik, mw, cpu, *args, **rkw)))
    merged = got[0].reshape(-1).clone()
    merged[sel] = red
    full = R.query_step_rows_scan(*dstack, t, *args, windows_per_query=1,
                                  **kw).cpu()
    err = max(err, check_equal("escalated vs full depth", merged,
                               full.reshape(-1)))
    del cpu
    # one phase-1 batch, one redo batch of 8192 flagged reads and one
    # full-depth batch: CUDA events around each call (launch gaps
    # included), and the kernels' own device time
    rep = torch.arange(b) % max(len(sel), 1)
    fr, ir, mr = (x[rep].to(dev) for x in (fk, ik, mw))
    steps = {
        "phase1": lambda: R.query_step_rows_scan_head(*dstack, t, *args,
                                                      **kw),
        "redo": lambda: R.query_step_rows_redo(fr, ir, mr, t, *args, **rkw),
        "full_depth": lambda: R.query_step_rows_scan(
            *dstack, t, *args, windows_per_query=1, **kw)}
    times = {}
    for k, fn in steps.items():
        times[f"{k}_batch_ms"] = cuda_ms(fn)
        times[f"{k}_batch_device_ms"] = device_ms(fn)
    say(f"e2e-parity-{name}", reads=b, tolerance=0, max_abs_err=err,
        plain="CPU tensors of the same tables", cpu_copy_seconds=round(
            copy_s, 3), flagged=len(sel), classified=int((merged != 0).sum()),
        **times)


def run_two_tier(tmp, profile):
    """The 1456 Mbp database: dense rows above the card's budget, so it
    stages two-tier (hsl 61, pk15). Summary query escalated (the main
    path of B6 and B7), the same query with MC_ESCALATE=0, the steps
    against the plain path, and the per-read path through B7."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import map_queries_to_targets
    name = "1456mbp-two-tier"
    genomes, species, gen_s = generated(two_tier_genomes)
    db, maxwin = phase_build(tmp, name, genomes, species, gen_s)
    if (2 * maxwin).bit_length() != 15:
        raise AssertionError(f"max window {maxwin}")
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20)
    del genomes
    layout = "('two_tier', 61, False, False, 15)"

    def escalated(runner, batches):
        redo = -(-runner.esc_reads // SCAN_BATCH)
        want = {k: 0 for k in kernels.ALL}
        want.update(sketch=batches, head_decode=batches, full_decode=redo,
                    sort=batches + redo, candidates=batches + redo)
        return want
    runner, launches, res = phase_query_summary(tmp, name, db, reads,
                                                layout, escalated)
    share = runner.esc_reads / len(reads)
    if not (runner.dense_bytes > runner.budget_bytes and
            runner.tables.head_slots == 61 and runner._pack_bits == 15 and
            runner._escalation_ok() and 0 < share < 1):
        raise AssertionError("the 1456 Mbp database did not stage two-tier "
                             "and escalate")
    say(f"staging-{name}", features=runner.tables.num_features,
        dense_gib=round(runner.dense_bytes / 2**30, 3),
        budget_gib=round(runner.budget_bytes / 2**30, 3),
        dense_over_budget=round(runner.dense_bytes / runner.budget_bytes, 4),
        staged_gib=round(runner.tables.nbytes() / 2**30, 3),
        head_rows=tuple(runner.tables.fused_rows.shape),
        overflow_rows=tuple(runner.tables.ovf_rows.shape),
        escalated_reads=runner.esc_reads, escalated_share=round(share, 6),
        redo_batches=launches["full_decode"])
    if profile:
        phase_profile(tmp, name, runner)

    os.environ["MC_ESCALATE"] = "0"
    try:
        kernels.reset_counts()
        res0 = ClassificationResults(io.StringIO(), io.StringIO(),
                                     io.StringIO())
        map_queries_to_targets([os.path.join(tmp, name, "reads.fa")],
                               runner.db, runner.opt, res0, runner)
        torch.cuda.synchronize()
        grew = {k: v.launches for k, v in kernels.ALL.items()}
    finally:
        del os.environ["MC_ESCALATE"]
    if not np.array_equal(res0.statistics.assigned_,
                          res.statistics.assigned_):
        raise AssertionError("MC_ESCALATE=0 changed the rank histogram")
    if grew != path_of("sketch", "full_decode", "sort", "candidates")(
            runner, -(-len(reads) // SCAN_BATCH)):
        raise AssertionError(f"full-depth launches {grew}")
    say(f"query-summary-{name}-full-depth", reads=res0.statistics.total(),
        reads_per_min=round(res0.statistics.total() /
                            (res0.time_ms / 60000.0)),
        seconds=round(res0.time_ms / 1000, 3), histogram_equal=True,
        launches=grew)
    if profile:
        os.environ["MC_ESCALATE"] = "0"
        try:
            phase_profile(tmp, name, runner, "-full-depth")
        finally:
            del os.environ["MC_ESCALATE"]
    phase_e2e_two_tier(name, runner, reads)
    del runner
    torch.cuda.empty_cache()
    phase_query_per_read(tmp, name, db, reads[:65536])
    torch.cuda.empty_cache()
    return launches


def phase_dense_limit(tmp, name, db, dense_hist):
    """The many-target database under MC_DENSE_LIMIT=1: two-tier (tgt,
    win) lane rows, torch-op decode and B5, no escalation; its histogram
    equals the dense run's."""
    os.environ["MC_DENSE_LIMIT"] = "1"
    try:
        runner, _l, res = phase_query_summary(
            tmp, name, db, 1 << 20,
            lambda r: r.tables.head_slots > 0 and r._pack_bits == 0,
            path_of("sketch", "candidates_unpacked"))
    finally:
        del os.environ["MC_DENSE_LIMIT"]
    if not np.array_equal(res.statistics.assigned_, dense_hist):
        raise AssertionError("the two-tier histogram differs from the "
                             "dense one")
    say(f"dense-limit-{name}", histogram_equal=True,
        layout=runner.layout.replace(" ", ""),
        staged_gib=round(runner.tables.nbytes() / 2**30, 3))
    del runner
    torch.cuda.empty_cache()


def generated(make):
    t0 = time.time()
    genomes, species = make()
    return genomes, species, time.time() - t0


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a warm summary query of each "
                         "configuration with torch.profiler")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from metacache_tpu_torch import kernels
    t_start = time.time()
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    results: dict = {}
    phase_kernels()
    phase_parity(results)
    launches = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".chip_smoke_") as tmp:
        genomes, species, gen_s = generated(refseq_skew_genomes)
        db, maxwin = phase_build(tmp, "944mbp", genomes, species, gen_s)
        layout = f"pk{(2 * maxwin).bit_length()}"
        if layout != "pk15":
            raise AssertionError(f"944 Mbp database packs as {layout}")
        main_path, _h = run_config(tmp, "944mbp", db, genomes, layout,
                                   ("sketch", "sort", "candidates"),
                                   a.profile)
        for k in ("sketch", "sort", "candidates"):
            launches[k] = main_path[k]
        shutil.rmtree(os.path.join(tmp, "944mbp"))

        genomes, species, gen_s = generated(many_target_genomes)
        db, maxwin = phase_build(tmp, "many-target", genomes, species,
                                 gen_s)
        if len(genomes) != 9217 or (2 * maxwin).bit_length() != 18:
            raise AssertionError(f"{len(genomes)} targets, max window "
                                 f"{maxwin}")
        # slots do not pack: the dense layout of (tgt, win) lane pairs
        main_path, hist = run_config(tmp, "many-target", db, genomes, "True",
                                     ("sketch", "candidates_unpacked"),
                                     a.profile)
        launches["candidates_unpacked"] = main_path["candidates_unpacked"]
        phase_dense_limit(tmp, "many-target", db, hist)
        shutil.rmtree(os.path.join(tmp, "many-target"))

        main_path = run_two_tier(tmp, a.profile)
        for k in ("head_decode", "full_decode"):
            launches[k] = main_path[k]
    if "jax" in sys.modules and sys.modules["jax"] is not None:
        raise AssertionError("JAX was imported")
    rows = []
    for name, k in kernels.ALL.items():
        r = results[name]
        rows.append({"name": name, "route": "cuda", "source": k.source,
                     "replaces": k.replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    if min(r["launches"] for r in rows) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    say("done", seconds=round(time.time() - t_start, 3))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
