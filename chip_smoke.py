#!/usr/bin/env python3
"""Smoke run of metacache_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each against its plain PyTorch version on the card, holds the
device table builder on the card against the same builder on CPU
tensors, then drives the port's query paths through its entry points,
each at a scale its users run. `build` builds its tables on the card
(the device builder) and saves them exported as CSR; `query` uploads the
saved CSR and fills the probe rows on the card.

- packed slots, dense rows: `build` of the RefSeq-skew database (64
  unique + 12 x 52-strain + 1 x 256-strain genomes of 1 Mbp, 944 Mbp,
  buckets at the 254 cap), whose (target, window) slots pack into int32,
  held equal to a host build of the same genomes, and `query` through
  kernels B1 and B4, which sorts each row itself (or B1, B3 and B4 on
  the split route, MC_SPLIT_CAND=1); the same query once more on the
  other route, and under each other staging, all with the same rank
  histogram: host rows
  (MC_DEVICE_LAYOUT=0), the bucket probe through B9
  (MC_PROBE_PALLAS=bucket), and the size-classed cells with escalation
  (MC_DENSE_LIMIT=1 MC_CLASSED=1);
- unpacked slots: `build` of a many-target database (one 8 Mbp genome
  plus 36 species x 256 strains of 50 kbp, 9217 targets, 469 Mbp), whose
  slots do not pack into int32, and `query` through B1 and B5; once more
  with MC_DENSE_LIMIT=1, which stages it two-tier;
- long windows: the same 944 Mbp genomes at `-winlen 255` (the
  reference's 255 preset), built in two steps, `build` without the
  256-strain group and `modify` with it, through kernel B2; `query` of
  250 bp reads through B2 and B4 (each stack of 250 bp reads is 256
  characters wide); and `build+query` of all genomes in one step (tables
  kept on the card from its build), whose mapping lines must equal the
  per-read query's on the modified database;
- packed slots, two-tier rows: `build` of the 1456 Mbp database (the
  RefSeq-skew generator with 576 unique genomes), whose dense rows exceed
  the card's budget, so it stages pair-packed two-tier rows, and `query`
  with escalation: a head-only phase through B1, B6 and B4, and a
  full-depth redo of the reads that touched a deeper bucket through B7
  and B4; once more with MC_ESCALATE=0 (B7 on every batch) and with
  MC_PROBE_PALLAS=1 (B9 for the bucket probe, B8 before B7), which must
  give the same result, per read too.

B3 runs ahead of B4 wherever MC_SPLIT_CAND=1 selects the split route.
At winlen 127 the summary path hands B1 the runner's 2-bit packed rows,
which B1 reads itself.
Each path queries 2^20 reads (100 bp; 250 bp at winlen 255) on the
summary path, 65,536 reads on the per-read path, and one batch of the
scan step compared with the plain path on CPU tensors of the same
tables.

Run from the repository root with no arguments:  python3 chip_smoke.py
It exits non-zero without a CUDA device. Its last stdout line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""
from __future__ import annotations

import argparse
import contextlib
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
PROBE_FEATURES = 1 << 21   # features of the B8/B9 parity table
# the least time of a kernel: the larger of its bytes over the card's
# memory rate and its integer operations over the 32-bit rate outside
# the tensor cores (H100 SXM, NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
CARD = ""


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block, then restore them."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                del os.environ[k]
            else:
                os.environ[k] = v


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True)
    return r.stdout.strip().splitlines()[0]


def say(phase: str, **kv):
    print(f"[{phase}] card={CARD!r} " +
          " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds per call from CUDA events, after one warm-up:
    launch gaps included, so a kernel of a few tens of microseconds reads
    its wrapper's host time (device_ms reads the kernel alone)."""
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


def kernel_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of a call that launches one kernel:
    ``reps`` calls captured in one CUDA graph, replayed 5 times between
    CUDA events, so the kernels run back to back without the wrappers'
    host time (the graph's launch gap between them included). Used in
    place of torch.profiler's kernel durations, which short traces here
    report wrongly (events lost, or read at half their time)."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    del g
    return s.elapsed_time(e) / (5 * reps)


def device_ms(fn, reps: int = 4) -> float:
    """Mean device milliseconds of a call of many kernels (a query step):
    the time of the kernels themselves in a torch.profiler trace of
    ``reps`` calls after a warm-up, without the gaps between launches;
    low by any kernel event the trace loses."""
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


def pack_2bit(codes: np.ndarray) -> np.ndarray:
    """(n, 4 m) codes 0..3 -> (n, m) bytes, four a byte, low bits first
    (the runner's infeed)."""
    return np.ascontiguousarray(
        codes[:, 0::4] | (codes[:, 1::4] << 2) | (codes[:, 2::4] << 4) |
        (codes[:, 3::4] << 6)).astype(np.uint8)


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


def write_genomes(fa, genomes, species, lo: int = 0, hi: int | None = None):
    """Genomes lo .. hi - 1 of the list as FASTA records."""
    with open(fa, "wb") as f:
        for i in range(lo, len(genomes) if hi is None else hi):
            f.write(b">GEN%05d.1 taxid|%d| strain genome\n"
                    % (i, 1000 + int(species[i])))
            f.write(ACGT[genomes[i]].tobytes() + b"\n")


def write_reference(tmp, genomes, species):
    fa = os.path.join(tmp, "genomes.fa")
    write_genomes(fa, genomes, species)
    tax = os.path.join(tmp, "taxonomy")
    write_taxonomy(tax, int(species.max()) + 1)
    return fa, tax


def write_taxonomy(tax, nsp: int):
    os.makedirs(tax, exist_ok=True)
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


def sample_reads(rng, genomes, n: int, read_len: int = READ_LEN):
    """n reads of read_len from uniformly drawn genomes (of any lengths)
    and positions, with Poisson(read_len / 100) substitutions, a 1% rate
    (the draw of bench.py:149-159)."""
    glen = np.array([len(g) for g in genomes])
    gsel = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, glen[gsel] - read_len)
    reads = np.empty((n, read_len), np.uint8)
    for g in np.unique(gsel):
        sel = np.nonzero(gsel == g)[0]
        reads[sel] = genomes[g][pos[sel, None] + np.arange(read_len)]
    nm = rng.poisson(read_len / 100, n)
    rows = np.repeat(np.arange(n), nm)
    reads[rows, rng.integers(0, read_len, len(rows))] = \
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
            host_us, device_ms=None, library_ms=None):
    b_ms, by = bound(nbytes, nops)
    results[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=by, library_ms=library_ms,
                         device_ms=device_ms, host_us_per_call=host_us,
                         shape=shape)
    return b_ms, by


def phase_parity(results):
    """Each kernel against its plain version at the main path's shapes,
    tolerance 0 (integer outputs). The launches made here are not the
    main path's: the counts are zeroed before each query."""
    from metacache_tpu_torch.ops import candidates as C
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)

    phase_parity_b1(results, rng, dev)
    phase_parity_long(results, rng, dev)

    b, l2, r = 8192, 4096, 256
    alt = torch.from_numpy(alternating_runs(rng, b, 16, r)).to(dev)
    rnd = torch.from_numpy(
        rng.permuted(slot_rows(rng, b, l2), axis=1)).to(dev)
    # the 1456 Mbp phase-1 shape (16 features x 64 lanes) and the widest
    # row the kernel takes
    alt1k = torch.from_numpy(alternating_runs(rng, b, 16, 64)).to(dev)
    wide = torch.from_numpy(alternating_runs(rng, 1024, 128, r)).to(dev)
    wrnd = torch.from_numpy(
        rng.permuted(slot_rows(rng, 1024, 32768), axis=1)).to(dev)
    errs = {}
    for name, pk, pre in (("presorted256", alt, r), ("unsorted", rnd, 0),
                          ("8192x1024_presorted64", alt1k, 64),
                          ("1024x32768_presorted256", wide, r),
                          ("1024x32768_unsorted", wrnd, 0)):
        got = C.sort_packed(pk, pre)
        errs[name] = check_equal(f"B3 sort {name}", got,
                                 C.sort_packed_plain(pk, pre))
    del wrnd
    ms1k = cuda_ms(lambda: C.sort_packed(alt1k, 64))
    ms = cuda_ms(lambda: C.sort_packed(alt, r))
    pms = cuda_ms(lambda: C.sort_packed_plain(alt, r))
    lib = cuda_ms(lambda: torch.sort(alt, dim=1))
    hus = host_us(lambda: C.sort_packed(alt, r))
    dms = kernel_ms(lambda: C.sort_packed(alt, r))
    b_ms, by = _record(results, "sort", err=max(errs.values()), ms=ms,
                       plain_ms=pms, library_ms=lib, host_us=hus,
                       device_ms=dms,
                       nbytes=2 * alt.numel() * 4,
                       nops=sort_ops(b, l2, r, 1),
                       shape="(8192, 4096) slots, presorted=256")
    say("parity-B3", rows=b, width=l2, tolerance=0,
        max_abs_err=max(errs.values()), cases=errs, ms=ms, plain_ms=pms,
        library_ms=lib, bound_ms=b_ms, bound_by=by, host_us_per_call=hus,
        kernel_device_ms=dms, ms_8192x1024_presorted64=ms1k,
        bound_ms_8192x1024_presorted64=bound(
            2 * alt1k.numel() * 4, sort_ops(b, 1024, 64, 1))[0])
    phase_parity_b4(results, rng, dev, alt, rnd, alt1k, wide, r)
    del alt1k, wide

    at, aw = (torch.from_numpy(x).to(dev)
              for x in alternating_pairs(rng, b, 16, r))
    st, sw = (torch.from_numpy(x).to(dev) for x in slot_pairs(rng, b, l2))
    wt, ww_ = (torch.from_numpy(x).to(dev)
               for x in alternating_pairs(rng, 1024, 64, r))
    errs = {}
    for name, (tt, ww, pre) in (("alt256", (at, aw, r)),
                                ("shuffled", (st, sw, 0)),
                                ("1024x16384_alt256", (wt, ww_, r))):
        mw = torch.full((tt.shape[0],), 2, dtype=torch.int32, device=dev)
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
    dmw = torch.full((2048,), 6, dtype=torch.int32, device=dev)
    got = torch.stack(C.candidates_unpacked(
        dt_, dw_, dmw, dedup_walk=6, max_candidates=2), dim=2)
    want = C.candidates_unpacked_plain(dt_, dw_, dmw, dedup_walk=6,
                                       max_candidates=2)
    errs["dedup"] = check_equal("B5 dedup", got, want)
    del wt, ww_
    mw = torch.full((b,), 2, dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: C.candidates_unpacked(
        at, aw, mw, walk_elems=32, max_candidates=2, presorted=r))
    pms = cuda_ms(lambda: C.candidates_unpacked_plain(
        at, aw, mw, walk_elems=32, max_candidates=2))
    # the (tgt, win) merge of B3's model on two-word keys, then B4's
    # sweep with the target and window compares apart
    hus = host_us(lambda: C.candidates_unpacked(
        at, aw, mw, walk_elems=32, max_candidates=2, presorted=r))
    dms = kernel_ms(lambda: C.candidates_unpacked(
        at, aw, mw, walk_elems=32, max_candidates=2, presorted=r))
    b_ms, by = _record(results, "candidates_unpacked",
                       err=max(errs.values()), ms=ms, plain_ms=pms,
                       host_us=hus, device_ms=dms,
                       nbytes=2 * at.numel() * 4 + b * 4 + b * 2 * 16,
                       nops=sort_ops(b, l2, r, 2) + at.numel() * (6 + 4),
                       shape="(8192, 4096) (tgt, win) slots, presorted=256,"
                             " walk 32, K=2")
    say("parity-B5", rows=b, width=l2, tolerance=0,
        max_abs_err=max(errs.values()), cases=errs, ms=ms, plain_ms=pms,
        bound_ms=b_ms, bound_by=by, host_us_per_call=hus,
        kernel_device_ms=dms, dedup_case="(2048, 1024) dedup_walk=6",
        wide_case="(1024, 16384) presorted=256")

    phase_parity_decode(results, rng, dev)
    phase_parity_probe(results, rng, dev)


def turns(fa, fb):
    """Two calls timed in turns, a, b, b, a (cuda_ms each) -> their
    mean ms and the four readings."""
    r = [cuda_ms(fa), cuda_ms(fb), cuda_ms(fb), cuda_ms(fa)]
    return (r[0] + r[3]) / 2, (r[1] + r[2]) / 2, r


def host_us(fn, reps: int = 200) -> float:
    """Mean host microseconds a call over ``reps`` unsynchronised calls:
    the wrapper's checks, allocations and launch, not the kernel."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def phase_parity_b1(results, rng, dev):
    """B1 against its plain version, tolerance 0: on the build's
    (65536, 128) and the scan batch's (8192, 128) codes, and on the scan
    batch's packed rows, which B1 reads itself, of 32 bytes and of 28
    (the summary path's: the runner crops a stack's rows to its
    longest read, 100 bp), the same windows with every ambiguous code
    made 2 (the infeed holds none; the reference is the unpack and
    padding, then the plain version), at k 16 and 12 and s 16, 8 and
    128. Its event, device and host times at each shape; the kernels
    line's row is (65536, 128)."""
    from metacache_tpu_torch.ops import sketch as S
    n = 65536
    codes, valid = sketch_inputs(rng, n)
    clean = np.where(codes < 4, codes, 2).astype(np.uint8)
    c = torch.from_numpy(codes).to(dev)
    v = torch.from_numpy(valid).to(dev)
    c8, v8 = c[:SCAN_BATCH], v[:SCAN_BATCH]
    p8 = torch.from_numpy(pack_2bit(clean[:SCAN_BATCH])).to(dev)
    p7 = torch.from_numpy(pack_2bit(clean[:SCAN_BATCH, :112])).to(dev)
    u8 = S.unpack_2bit(p8)
    u7 = S.pad_windows(S.unpack_2bit(p7))
    errs = {}
    for k, s in ((16, 16), (16, 8), (16, 128), (12, 16), (12, 8),
                 (12, 128)):
        for name, got, want in (
                ("65536x128", lambda: S.sketch_windows(c, v, k, s),
                 lambda: S.sketch_windows_plain(c, v, k, s)),
                ("8192x128", lambda: S.sketch_windows(c8, v8, k, s),
                 lambda: S.sketch_windows_plain(c8, v8, k, s)),
                ("8192x32_packed",
                 lambda: S.sketch_windows_packed(p8, v8, k, s),
                 lambda: S.sketch_windows_plain(u8, v8, k, s)),
                ("8192x28_packed",
                 lambda: S.sketch_windows_packed(p7, v8, k, s),
                 lambda: S.sketch_windows_plain(u7, v8, k, s))):
            key = f"{name}_k{k}_s{s}"
            errs[key] = check_equal(f"B1 {key}", got(), want())
    # per k-mer position: 2-bit update, reverse complement, canonical
    # min and hash (~20 ops), plus ~2 to keep the s smallest
    kpos = int(np.maximum(valid.astype(np.int64) - 15, 0).sum())
    kpos8 = int(np.maximum(valid[:SCAN_BATCH].astype(np.int64) - 15,
                           0).sum())

    def full():
        return S.sketch_windows(c, v, 16, 16)

    def scan():
        return S.sketch_windows(c8, v8, 16, 16)

    def packed():
        return S.sketch_windows_packed(p8, v8, 16, 16)

    def cropped():
        return S.sketch_windows_packed(p7, v8, 16, 16)
    ms, hus = cuda_ms(full), host_us(full)
    b_ms, by = _record(results, "sketch", err=max(errs.values()), ms=ms,
                       plain_ms=cuda_ms(lambda: S.sketch_windows_plain(
                           c, v, 16, 16)),
                       nbytes=codes.nbytes + valid.nbytes + n * 16 * 4,
                       nops=22 * kpos, device_ms=kernel_ms(full),
                       host_us=hus,
                       shape="(65536, 128) windows, k=16, s=16")
    scan_b = bound(SCAN_BATCH * (128 + 4 + 16 * 4), 22 * kpos8)[0]
    packed_b = bound(SCAN_BATCH * (32 + 4 + 16 * 4), 22 * kpos8)[0]
    say("parity-B1", windows=n, tolerance=0, max_abs_err=max(errs.values()),
        cases=len(errs), ms=ms,
        kernel_device_ms=results["sketch"]["device_ms"], host_us_per_call=hus,
        plain_ms=results["sketch"]["plain_ms"], bound_ms=b_ms, bound_by=by,
        scan_8192x128_ms=cuda_ms(scan),
        scan_8192x128_device_ms=kernel_ms(scan),
        scan_8192x128_host_us=host_us(scan),
        scan_8192x128_plain_ms=cuda_ms(
            lambda: S.sketch_windows_plain(c8, v8, 16, 16)),
        scan_8192x128_bound_ms=scan_b,
        packed_8192x32_ms=cuda_ms(packed),
        packed_8192x32_device_ms=kernel_ms(packed),
        packed_8192x32_host_us=host_us(packed),
        packed_8192x32_plain_ms=cuda_ms(
            lambda: S.sketch_windows_plain(S.unpack_2bit(p8), v8, 16, 16)),
        packed_8192x32_bound_ms=packed_b,
        packed_8192x28_ms=cuda_ms(cropped),
        packed_8192x28_device_ms=kernel_ms(cropped),
        packed_8192x28_host_us=host_us(cropped),
        packed_8192x28_bound_ms=bound(
            SCAN_BATCH * (28 + 4 + 16 * 4), 22 * int(np.maximum(np.minimum(
                valid[:SCAN_BATCH], 112).astype(np.int64) - 15, 0).sum()))[0])


def phase_parity_b4(results, rng, dev, alt, rnd, alt1k, wide, r):
    """B4 in both forms against its plain version (the plain sort, then
    the plain sweep), tolerance 0: the split form (rows as B3 leaves
    them, sorted: presorted = L2) at walk 32 with K 2 and 4, walk 48 and
    dedup 6; the fused form on unsorted rows, on alternating runs of 256
    and of 64 (the 1456 Mbp phase-1 shape, 8192 x 1024) and on sorted
    rows; the split route (B3, then B4) on the same runs; the widest row,
    1024 x 32768, in both. Times the split form alone, the fused form and
    the split route in turns at 8192 x 4096 (presorted 256) and
    8192 x 1024 (presorted 64), each beside its bound. The kernels
    line's row is the form that MC_SPLIT_CAND's default runs."""
    from metacache_tpu_torch.ops import candidates as C
    from metacache_tpu_torch.ops.rows import split_candidates
    b, l2 = alt.shape
    srt = torch.from_numpy(slot_rows(rng, b, l2)).to(dev)
    dsr = torch.from_numpy(slot_rows(rng, 2048, 1024)).to(dev)
    drnd = torch.from_numpy(rng.permuted(dsr.cpu().numpy(), axis=1)).to(dev)

    def mwir(pk, m):
        return torch.full((pk.shape[0],), m, dtype=torch.int32, device=dev)

    def plain(pk, mw, walk_elems=0, dedup_walk=0, max_candidates=2, **_):
        return C.candidates_sorted_plain(C.sort_packed_plain(pk), mw, 15,
                                         walk_elems, dedup_walk,
                                         max_candidates)
    errs = {}
    for name, pk, m, kw in (
            ("split_walk32_K2", srt, 2, dict(walk_elems=32)),
            ("split_walk32_K4", srt, 2, dict(walk_elems=32,
                                             max_candidates=4)),
            ("split_walk48", srt, 3, dict(walk_elems=48)),
            ("split_dedup6", dsr, 6, dict(dedup_walk=6)),
            ("fused_presorted0", rnd, 2, dict(walk_elems=32, presorted=0)),
            ("fused_presorted256", alt, 2, dict(walk_elems=32,
                                                presorted=r)),
            ("fused_presorted256_K4_walk48", alt, 3, dict(
                walk_elems=48, max_candidates=4, presorted=r)),
            ("fused_8192x1024_presorted64", alt1k, 2, dict(
                walk_elems=32, presorted=64)),
            ("fused_presortedL2", srt, 2, dict(walk_elems=32,
                                               presorted=l2)),
            ("fused_dedup6_presorted0", drnd, 6, dict(dedup_walk=6)),
            ("split_route_presorted256", alt, 2, dict(
                walk_elems=32, presorted=r, split=True)),
            ("fused_1024x32768_presorted256", wide, 2, dict(
                walk_elems=32, max_candidates=4, presorted=r)),
            ("split_route_1024x32768_dedup6", wide, 6, dict(
                dedup_walk=6, presorted=r, split=True))):
        kw.setdefault("max_candidates", 2)
        if name.startswith("split_") and "split" not in kw:
            kw["sorted_input"] = True
        mw = mwir(pk, m)
        got = torch.stack(C.candidates_packed(pk, mw, 15, **kw), dim=2)
        errs[name] = check_equal(f"B4 {name}", got, plain(pk, mw, **kw))
    del drnd, dsr
    mw, mw3, mw1k = mwir(srt, 2), mwir(srt, 3), mwir(alt1k, 2)
    kw = dict(walk_elems=32, max_candidates=2)
    split_ms = cuda_ms(lambda: C.candidates_packed(
        srt, mw, 15, sorted_input=True, **kw))
    split48_ms = cuda_ms(lambda: C.candidates_packed(
        srt, mw3, 15, walk_elems=48, max_candidates=2, sorted_input=True))
    fused_ms, route_ms, reads = turns(
        lambda: C.candidates_packed(alt, mw, 15, presorted=r, **kw),
        lambda: C.candidates_packed(alt, mw, 15, presorted=r, split=True,
                                    **kw))
    fused1k_ms, route1k_ms, reads1k = turns(
        lambda: C.candidates_packed(alt1k, mw1k, 15, presorted=64, **kw),
        lambda: C.candidates_packed(alt1k, mw1k, 15, presorted=64,
                                    split=True, **kw))
    sweep_plain_ms = cuda_ms(lambda: C.candidates_sorted_plain(
        srt, mw, 15, 32, 0, 2))
    fused_plain_ms = cuda_ms(lambda: plain(alt, mw, **kw))
    # a two-pointer sweep (~4 ops per lane) and K = 2 max + mask rounds;
    # the fused form adds B3's merge of runs. Each input read once, the
    # (B, K, 4) result written once: B3 + B4 computes the fused form's
    # function, so the two share a bound
    out_bytes = b * 4 + b * 2 * 16
    sweep_ops = srt.numel() * (4 + 2 * 2)
    split_b = bound(srt.numel() * 4 + out_bytes, sweep_ops)
    fused_b = bound(alt.numel() * 4 + out_bytes,
                    sort_ops(b, l2, r, 1) + sweep_ops)
    fused1k_b = bound(alt1k.numel() * 4 + out_bytes,
                      sort_ops(b, 1024, 64, 1) + alt1k.numel() * 8)
    split_hus = host_us(lambda: C.candidates_packed(
        srt, mw, 15, sorted_input=True, **kw))
    fused_hus = host_us(lambda: C.candidates_packed(alt, mw, 15, presorted=r,
                                                    **kw))
    split_dms = kernel_ms(lambda: C.candidates_packed(
        srt, mw, 15, sorted_input=True, **kw))
    fused_dms = kernel_ms(lambda: C.candidates_packed(alt, mw, 15,
                                                      presorted=r, **kw))
    if split_candidates():
        row = dict(ms=split_ms, plain_ms=sweep_plain_ms, host_us=split_hus,
                   device_ms=split_dms,
                   nbytes=srt.numel() * 4 + out_bytes, nops=sweep_ops,
                   shape="(8192, 4096) sorted slots, walk 32, K=2 "
                         "(split route: after B3)")
    else:
        row = dict(ms=fused_ms, plain_ms=fused_plain_ms, host_us=fused_hus,
                   device_ms=fused_dms,
                   nbytes=alt.numel() * 4 + out_bytes,
                   nops=sort_ops(b, l2, r, 1) + sweep_ops,
                   shape="(8192, 4096) slots, presorted=256, walk 32, K=2 "
                         "(fused: B4 sorts)")
    b_ms, by = _record(results, "candidates", err=max(errs.values()), **row)
    say("parity-B4", rows=b, width=l2, tolerance=0,
        max_abs_err=max(errs.values()), cases=errs,
        default_route="split" if split_candidates() else "fused",
        ms=row["ms"], plain_ms=row["plain_ms"], bound_ms=b_ms, bound_by=by,
        host_us_per_call=row["host_us"], split_host_us=split_hus,
        fused_host_us=fused_hus, split_device_ms=split_dms,
        fused_device_ms=fused_dms, split_ms=split_ms,
        split_bound_ms=split_b[0],
        split_plain_ms=sweep_plain_ms, split_walk48_ms=split48_ms,
        fused_ms=fused_ms, fused_bound_ms=fused_b[0],
        fused_plain_ms=fused_plain_ms, b3_b4_ms=route_ms,
        b3_b4_bound_ms=fused_b[0], turns_fused_b3b4_fused=reads,
        fused_8192x1024_ms=fused1k_ms, b3_b4_8192x1024_ms=route1k_ms,
        bound_8192x1024_ms=fused1k_b[0], turns_8192x1024=reads1k)


def long_sketch_inputs(rng, n: int, w: int, k: int, read_len: int):
    """(n, w) windows for B2: 1% ambiguous codes, ambiguous runs across
    the first chunk cut, all-ambiguous and repeated windows; valid mostly
    ``read_len``, the rest random, below k, one chunk of starts (113),
    just past one chunk (130) and 250."""
    codes = rng.integers(0, 4, (n, w), dtype=np.uint8)
    codes[rng.random((n, w)) < 0.01] = 4
    codes[3::97, 100:180] = 4
    codes[4::89] = 4
    codes[5::83] = np.tile(np.array([0, 1, 2, 3], np.uint8), w)[:w]
    valid = np.full(n, read_len, np.int32)
    valid[1::7] = rng.integers(0, w + 1, len(valid[1::7]))
    valid[2::13] = k - 1
    valid[6::17] = 113
    valid[8::19] = 130
    valid[9::23] = min(250, w)
    return codes, valid


def phase_parity_long(results, rng, dev):
    """B2 against its plain version, tolerance 0: at the build's shape
    (65,536 windows of 255), a 250 bp scan batch (8192 x 256), 511-wide
    windows, k = 12, s = 128, and 1000-wide windows (spans above 512:
    512-char chunks and a running sketch). Timed at the build's and the
    scan batch's shape, each beside its bound."""
    from metacache_tpu_torch.ops import sketch as S
    errs, rec = {}, {}
    for n, w, k, sl in ((65536, 255, 16, 16), (8192, 256, 16, 16),
                        (8192, 511, 16, 16), (8192, 255, 12, 16),
                        (8192, 511, 12, 128), (4096, 1000, 16, 16)):
        codes, valid = long_sketch_inputs(rng, n, w, k,
                                          250 if w == 256 else w)
        c = torch.from_numpy(codes).to(dev)
        v = torch.from_numpy(valid).to(dev)
        got = S.sketch_windows(c, v, k, sl)
        want = S.sketch_windows_long_plain(c, v, k, sl)
        key = f"{n}x{w}_k{k}_s{sl}"
        errs[key] = check_equal(f"B2 sketch {key}", got, want)
        if (n, w, k, sl) in ((65536, 255, 16, 16), (8192, 256, 16, 16)):
            # B1's operation model per k-mer position (phase_parity)
            kpos = int(np.maximum(np.minimum(valid, w).astype(np.int64)
                                  - 15, 0).sum())
            rec[(n, w)] = (cuda_ms(lambda: S.sketch_windows(c, v, k, 16)),
                           cuda_ms(lambda: S.sketch_windows_long_plain(
                               c, v, k, 16)),
                           n * w + 4 * n + 4 * n * 16, 22 * kpos,
                           host_us(lambda: S.sketch_windows(c, v, k, 16)),
                           kernel_ms(lambda: S.sketch_windows(c, v, k, 16)))
    ms, pms, nbytes, nops, hus, dms = rec[(65536, 255)]
    b_ms, by = _record(results, "sketch_long", err=max(errs.values()),
                       ms=ms, plain_ms=pms, nbytes=nbytes, nops=nops,
                       host_us=hus, device_ms=dms,
                       shape="(65536, 255) windows, k=16, s=16")
    sms, spms, sbytes, sops, shus, sdms = rec[(8192, 256)]
    say("parity-B2", tolerance=0, max_abs_err=max(errs.values()),
        cases=errs, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        host_us_per_call=hus, kernel_device_ms=dms,
        scan_8192x256_host_us=shus, scan_8192x256_device_ms=sdms,
        scan_8192x256_ms=sms, scan_8192x256_plain_ms=spms,
        scan_8192x256_bound_ms=bound(sbytes, sops)[0])


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
    cache), against their plain versions. B6 also at rl 64, 128 and 256,
    f 16 and 1, on 131,072 + 17 probes (not a multiple of 32), and on a
    head view 4 bytes past 16-byte alignment (its 4-byte path)."""
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
    # a separate generator: the later phases' data stay as they were
    idx17, flat17 = (torch.from_numpy(a).to(dev) for a in decode_probes(
        np.random.default_rng(4321), feats, n + 17))
    shifted = torch.cat([head.new_zeros(1), head.reshape(-1)])[1:].view(
        head.shape)
    assert shifted.data_ptr() % 16 == 4
    errs = {}
    for name, h, ii, ff_ in (("", head, idx, flat),
                             ("n+17_", head, idx17, flat17),
                             ("4byte_", shifted, idx, flat)):
        for rl in (64, 128, 256):
            for ff in (16, 1):
                pk, cn = D.head_decode(h, ii, ff_, hsl, rl, ff)
                wpk, wcn = D.head_decode_plain(h, ii, ff_, hsl, rl, ff)
                key = f"{name}rl{rl}_f{ff}"
                errs[key] = max(check_equal(f"B6 {key}", pk, wpk),
                                check_equal(f"B6 cnt {key}", cn, wcn))
    del idx17, flat17
    def call():
        return D.head_decode(head, idx, flat, hsl, 64, f)
    ms, dms, hus = cuda_ms(call), kernel_ms(call), host_us(call)
    dms4 = kernel_ms(lambda: D.head_decode(shifted, idx, flat, hsl, 64, f))
    del shifted
    pms = cuda_ms(lambda: D.head_decode_plain(head, idx, flat, hsl, 64, f))
    kept = int(np.minimum(cnt, hsl).sum())
    b_ms, by = _record(results, "head_decode", err=max(errs.values()), ms=ms,
                       plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (8 + 12 + 4 + 64 * 4) + kept * 4,
                       nops=n * 64 * 2,
                       shape="131072 probes, f=16, hsl=61, rl=64")
    say("parity-B6", probes=n, tolerance=0, max_abs_err=max(errs.values()),
        cases=errs, ms=ms, kernel_device_ms=dms, host_us_per_call=hus,
        four_byte_path_device_ms=dms4, plain_ms=pms, bound_ms=b_ms,
        bound_by=by, deep_share=round(float((cnt > hsl).mean()), 4),
        miss_share=round(float((cnt == 0).mean()), 4))

    errs = []
    for rl, ff in ((256, f), (512, f), (256, 1)):
        got = D.full_decode(head, ovf, idx, flat, hsl, c, rl, ff)
        want = D.full_decode_plain(head, ovf, idx, flat, hsl, c, rl, ff)
        errs.append(check_equal(f"B7 rl={rl} f={ff}", got, want))
    def call():
        return D.full_decode(head, ovf, idx, flat, hsl, c, 256, f)
    ms, dms, hus = cuda_ms(call), kernel_ms(call), host_us(call)
    pms = cuda_ms(lambda: D.full_decode_plain(head, ovf, idx, flat, hsl, c,
                                              256, f))
    b_ms, by = _record(results, "full_decode", err=max(errs), ms=ms,
                       plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (8 + 12 + 256 * 4)
                       + int(cnt.sum()) * 4, nops=n * 256 * 2,
                       shape="131072 probes, f=16, hsl=61, c=254, rl=256")
    say("parity-B7", probes=n, tolerance=0, max_abs_err=max(errs), ms=ms,
        kernel_device_ms=dms, host_us_per_call=hus, plain_ms=pms,
        bound_ms=b_ms, bound_by=by, cases="rl 256/512 f=16, rl 256 f=1")


def probe_stream(rng, nf: int):
    """A (feature, tgt, win) build stream of nf distinct features: 80%
    with 1..61 locations, 20% with 62..100 (deeper than a 61-slot head),
    each feature's locations ascending in (tgt, win); int32 tensors."""
    f = np.unique(rng.integers(0, 2**32 - 1, nf + nf // 8, dtype=np.uint64))
    f = rng.permutation(f)[:nf].astype(np.uint32)
    depth = np.where(rng.random(nf) < 0.2, rng.integers(62, 101, nf),
                     rng.integers(1, 62, nf))
    depth[0] = 100
    feats = np.repeat(f, depth)
    start = np.repeat(np.cumsum(depth) - depth, depth)
    tgt = (np.arange(len(feats)) - start).astype(np.int32)
    win = rng.integers(0, 4096, len(feats)).astype(np.int32)
    return [torch.from_numpy(a) for a in (feats.view(np.int32), tgt, win)]


def build_probe_table(stream, dev):
    """The stream's two-tier table as the 1456 Mbp database stages it:
    dense rows refused, head 61, pair-packed head rows (MC_PACK_ROWS=1),
    built by the port's device builder on ``dev`` in 8 chunks."""
    from metacache_tpu_torch.ops import table_device as T
    f, t, w = (x.to(dev) for x in stream)
    n = f.shape[0]
    step = -(-n // 8)
    chunks = [(f[i:i + step], t[i:i + step], w[i:i + step])
              for i in range(0, n, step)]
    del f, t, w
    nf = int(np.unique(stream[0].numpy()).size)
    with environ(MC_PACK_ROWS="1", MC_CLASSED="0"):
        return T.build_device_table_chunked(
            chunks, budget_bytes=T.dense_bytes(nf, 100, 13) - 1)


def phase_parity_probe(results, rng, dev):
    """B9 and B8 at the main path's 131,072 probes (8192 reads x 16
    features) on a 2 M-feature table built on the card by the device
    builder (pair-packed bucket rows and head rows, 512 MB of head rows),
    with 29% misses and 1% sentinels, against their plain versions; then
    the builder on the card against the builder on CPU tensors, on the
    first 300,000 features of the stream: the two-tier rows and the
    size-classed cells staged from their CSR, arrays equal."""
    from metacache_tpu_torch.ops import probe_decode as D
    from metacache_tpu_torch.ops import table_device as T
    n = 131072
    stream = probe_stream(rng, PROBE_FEATURES)
    t0 = time.time()
    dt = build_probe_table(stream, dev)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    if not (dt.packed and dt.head_slots == 61 and not dt.dense):
        raise AssertionError(f"probe table: head {dt.head_slots}, packed "
                             f"{dt.packed}")
    sel = torch.from_numpy(rng.integers(0, dt.nf, n)).to(dev)
    flat = dt.uniq[sel]
    miss = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    flat = torch.where(miss, torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev),
        flat)
    flat[::100] = -1
    errs = []
    idx, found = D.bucket_decode(dt.brows, flat, dt.bbits)
    widx, wfound = D.bucket_decode_plain(dt.brows, flat, dt.bbits)
    errs += [check_equal("B9 idx", idx, widx),
             check_equal("B9 found", found, wfound)]
    ms = cuda_ms(lambda: D.bucket_decode(dt.brows, flat, dt.bbits))
    dms = kernel_ms(lambda: D.bucket_decode(dt.brows, flat, dt.bbits))
    pms = cuda_ms(lambda: D.bucket_decode_plain(dt.brows, flat, dt.bbits))
    # per probe: the feature, its 64-lane (256 B) bucket row, idx + found
    hus = host_us(lambda: D.bucket_decode(dt.brows, flat, dt.bbits))
    b_ms, by = _record(results, "bucket_decode", err=max(errs), ms=ms,
                       plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (4 + 256 + 4 + 1),
                       nops=n * 64 * 3,
                       shape=f"131072 probes, {dt.bbits} bucket bits, "
                             "2 M-feature table")
    say("parity-B9", probes=n, tolerance=0, max_abs_err=max(errs), ms=ms,
        kernel_device_ms=dms, host_us_per_call=hus, plain_ms=pms,
        bound_ms=b_ms, bound_by=by,
        found_share=round(float(found.float().mean()), 4),
        table_build_seconds=round(build_s, 3), features=dt.nf,
        locations=dt.num_locations, bucket_bits=dt.bbits,
        head_rows=tuple(dt.head.shape))
    head = dt.head.view(-1, 64)
    ovf = dt.ovf
    idx = torch.clamp(idx, 0, dt.nf - 1)
    oidx = D.oidx_decode(head, idx, flat)
    errs = [check_equal("B8", oidx, D.oidx_decode_plain(head, idx, flat))]
    errs.append(check_equal(
        "B7 with B8's oidx", D.full_decode(head, ovf, idx, flat, 61, dt.spf,
                                           128, 16, oidx),
        D.full_decode_plain(head, ovf, idx, flat, 61, dt.spf, 128, 16)))
    ms = cuda_ms(lambda: D.oidx_decode(head, idx, flat))
    dms = kernel_ms(lambda: D.oidx_decode(head, idx, flat))
    pms = cuda_ms(lambda: D.oidx_decode_plain(head, idx, flat))
    # per probe: its row index and feature, head lanes 0 and 2, oidx
    hus = host_us(lambda: D.oidx_decode(head, idx, flat))
    b_ms, by = _record(results, "oidx_decode", err=max(errs), ms=ms,
                       plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (4 + 4 + 8 + 4),
                       nops=n * 4, shape="131072 probes, pair-packed head "
                                         "rows, 2 M-feature table")
    say("parity-B8", probes=n, tolerance=0, max_abs_err=max(errs), ms=ms,
        kernel_device_ms=dms, host_us_per_call=hus, plain_ms=pms,
        bound_ms=b_ms, bound_by=by,
        deep_share=round(float((oidx > 0).float().mean()), 4))
    del dt, head, ovf, flat, idx, oidx, found
    torch.cuda.empty_cache()

    # the builder on the card and on CPU tensors
    nf = min(300_000, PROBE_FEATURES // 4)
    f = stream[0].numpy().view(np.uint32)
    cut = int(np.searchsorted(np.cumsum(np.r_[True, f[1:] != f[:-1]]),
                              nf + 1))
    sub = [x[:cut] for x in stream]
    out = []
    for d in (dev, torch.device("cpu")):
        t0 = time.time()
        dt = build_probe_table(sub, d)
        u, o, l = T.export_csr(dt)
        with environ(MC_CLASSED="1"):
            ct = T.device_layout_from_csr(
                u, o, (l >> np.uint64(32)).astype(np.uint32),
                (l & np.uint64(0xFFFFFFFF)).astype(np.uint32), device=d,
                allow_dense=False, budget_bytes=dt.layout_bytes * 2)
        out.append((dt, ct, time.time() - t0))
    for i, what in ((0, "two-tier"), (1, "classed")):
        a, b = out[0][i], out[1][i]
        if not b.classed == (i == 1) or a[5:] != b[5:]:
            raise AssertionError(f"builder {what}: {a[5:]} != {b[5:]}")
        for name in ("uniq", "offsets", "head", "ovf", "brows"):
            check_equal(f"builder {what} {name}", getattr(a, name).cpu(),
                        getattr(b, name))
    say("builder-card-vs-cpu", features=out[1][0].nf,
        locations=out[1][0].num_locations, layouts="two-tier hpack, "
        "classed from its CSR", arrays_equal=True,
        card_seconds=round(out[0][2], 3), cpu_seconds=round(out[1][2], 3))


def phase_build(tmp, name, genomes, species, gen_s, host_check=False):
    """`build` through the CLI (the device builder); with ``host_check``
    a host build of the same genomes must give the same features,
    offsets and locations. -> (database path, max window)."""
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
    torch.cuda.empty_cache()
    launches = kernels.SKETCH.launches - before
    if launches <= 0:
        raise AssertionError("build did not launch the sketch kernel")
    p = Database.load(db).parts[0]
    host = {}
    if host_check:
        from metacache_tpu_torch.db.build import BuildOptions, build_database
        t0 = time.time()
        hp = build_database(BuildOptions(infiles=[fa], taxonomy_dir=tax))
        host = dict(host_build_seconds=round(time.time() - t0, 3),
                    host_build_equal=True)
        if hp.device_parts or len(hp.parts) != 1:
            raise AssertionError("the host build did not build on the host")
        for k in ("unique_features", "offsets", "locations"):
            if not np.array_equal(getattr(hp.parts[0], k), getattr(p, k)):
                raise AssertionError(f"device build != host build: {k}")
        del hp
    os.remove(fa)
    maxwin = int((p.locations & np.uint64(0xFFFFFFFF)).max())
    say(f"build-{name}", genomes=len(genomes),
        bases=sum(len(g) for g in genomes), features=p.num_features,
        locations=p.num_locations, max_bucket=p.max_bucket_size,
        max_window=maxwin, seconds=round(build_s, 3),
        data_gen_seconds=round(gen_s, 3), sketch_launches=launches, **host)
    return db, maxwin


def _query(db_path, reads_path, args, out):
    """A query through the runner; ``db_path``: a path or a loaded
    Database. -> (runner, results, staging seconds)."""
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import (QueryRunner,
                                                     map_queries_to_targets)
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    opt, _, _ = parse_query_options(Args(list(args)))
    db = Database.load(db_path) if isinstance(db_path, str) else db_path
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
    runner.stage_s = stage_s
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


def cand_kernels():
    """The packed path's candidate kernels on the route MC_SPLIT_CAND
    selects: B4 alone (it sorts the rows), or B3 and then B4."""
    from metacache_tpu_torch.ops.rows import split_candidates
    return ("sort", "candidates") if split_candidates() else ("candidates",)


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


def phase_query_per_read(tmp, name, db, reads, tag=""):
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
    say(f"query-per-read-{name}{tag}", reads=len(reads),
        mapping_lines=len(lines), seconds=round(res.time_ms / 1000, 3))
    del runner
    return lines


def phase_e2e(name, runner, reads, dev=torch.device("cuda")):
    """One stack of 8192 reads through the scan step on the card and the
    plain path on CPU tensors of the same tables: rows of ceil(winlen / 4)
    packed bytes (32 at winlen 127, 64 at 255), valid = the read length,
    mwir = 2 + length // stride, the runner's sweep."""
    from metacache_tpu_torch.ops.rows import query_step_rows_scan
    b, rl = min(8192, len(reads)), reads.shape[1]
    nb = (runner.sketching.winlen + 3) // 4
    c4 = np.zeros((b, 4 * nb), np.uint8)
    c4[:, :rl] = reads[:b]
    packed = pack_2bit(c4).reshape(1, b, 1, nb)
    mw = 2 + rl // runner.db.sketching.winstride
    vmat = np.full((1, b, 1), rl, np.uint8)
    mwir = np.full((1, b), mw, np.uint8)
    t = runner.tables
    cpu = t.cpu_copy()
    kw = dict(k=16, sketchlen=16, windows_per_query=1, max_candidates=2,
              fast_top2=True, pack_bits=runner._pack_bits,
              infeed_packed=True,
              **runner._sweep_params(np.array([mw], np.int32), 1))
    args = (runner.hits_min, 1.0, runner.highest_rank, runner.merge_rank)
    got = query_step_rows_scan(
        torch.from_numpy(packed).to(dev), torch.from_numpy(vmat).to(dev),
        torch.from_numpy(mwir).to(dev), t, *args, **kw).cpu()
    want = query_step_rows_scan(
        torch.from_numpy(packed), torch.from_numpy(vmat),
        torch.from_numpy(mwir), cpu, *args, **kw)
    err = check_equal("end-to-end cls", got, want)
    say(f"e2e-parity-{name}", reads=b, packed_bytes=nb, valid=rl, mwir=mw,
        tolerance=0, max_abs_err=err, classified=int((got != 0).sum()))


def phase_other_route(tmp, name, runner, res):
    """The summary query once more on the same staged tables under the
    other MC_SPLIT_CAND route, a main path of its own (counts zeroed
    just before it, read just after): the same rank histogram.
    -> its launches."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import map_queries_to_targets
    from metacache_tpu_torch.ops.rows import split_candidates
    other = "0" if split_candidates() else "1"
    nreads = res.statistics.total()
    with environ(MC_SPLIT_CAND=other):
        kernels.reset_counts()
        res1 = ClassificationResults(io.StringIO(), io.StringIO(),
                                     io.StringIO())
        map_queries_to_targets([os.path.join(tmp, name, "reads.fa")],
                               runner.db, runner.opt, res1, runner)
        torch.cuda.synchronize()
        grew = {k: v.launches for k, v in kernels.ALL.items()}
        want = path_of("sketch", *cand_kernels())(
            runner, -(-nreads // SCAN_BATCH))
    if grew != want:
        raise AssertionError(f"MC_SPLIT_CAND={other}: launches {grew}, "
                             f"expected {want}")
    if not np.array_equal(res1.statistics.assigned_,
                          res.statistics.assigned_):
        raise AssertionError(f"MC_SPLIT_CAND={other} changed the rank "
                             "histogram")
    say(f"query-summary-{name}-split{other}", reads=res1.statistics.total(),
        reads_per_min=round(res1.statistics.total() /
                            (res1.time_ms / 60000.0)),
        seconds=round(res1.time_ms / 1000, 3), histogram_equal=True,
        launches=grew)
    return grew


def run_config(tmp, name, db, genomes, layout, path_kernels, profile,
               other_route=False):
    """Summary query (the main path), its profile, with ``other_route``
    the same query under the other MC_SPLIT_CAND route, the scan step
    against the plain path, and the per-read path; -> the summary's
    launches, rank histogram, staging seconds and the other route's
    launches (None without it)."""
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20)
    del genomes
    runner, launches, res = phase_query_summary(
        tmp, name, db, reads, layout, path_of(*path_kernels))
    stage_s = runner.stage_s
    if profile:
        phase_profile(tmp, name, runner)
    other = phase_other_route(tmp, name, runner, res) if other_route \
        else None
    phase_e2e(name, runner, reads)
    del runner
    torch.cuda.empty_cache()
    phase_query_per_read(tmp, name, db, reads[:65536])
    torch.cuda.empty_cache()
    return launches, res.statistics.assigned_.copy(), stage_s, other


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
    packed = pack_2bit(c4).reshape(1, b, 1, 32)
    return (torch.from_numpy(packed), torch.full((1, b, 1), READ_LEN,
                                                 dtype=torch.uint8),
            torch.full((1, b), 2, dtype=torch.uint8))


def phase_e2e_two_tier(name, runner, reads, dev=torch.device("cuda")):
    """The escalation steps on one 8192-read stack against the plain path
    on CPU tensors of the same tables (the host holds the second copy):
    phase 1 (B1, B6, B4) and the redo of its flagged reads (B7, B4);
    their merge also equals the full-depth scan (B7) on the card.
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


def run_stagings(tmp, name, db, hist, stage_s):
    """The 944 Mbp summary query under the other stagings, each a main
    path of its own, each with the default's rank histogram: host rows
    filled in numpy and copied (MC_DEVICE_LAYOUT=0), the bucket probe
    through B9 (MC_PROBE_PALLAS=bucket), and the size-classed cells
    (MC_DENSE_LIMIT=1 MC_CLASSED=1) with escalation (phase 1 and the redo
    as torch ops, then B4). -> B9's launches."""
    from metacache_tpu_torch import kernels
    n = 1 << 20
    layout = "pk15"
    dense = ("sketch", *cand_kernels())
    out = {"device_staging_seconds": round(stage_s, 3)}

    def classed(runner, batches):
        redo = -(-runner.esc_reads // SCAN_BATCH)
        want = {k: 0 for k in kernels.ALL}
        want.update({k: batches + redo for k in cand_kernels()},
                    sketch=batches)
        return want
    for tag, env, lay, expect in (
            ("host-rows", {"MC_DEVICE_LAYOUT": "0"}, layout, path_of(*dense)),
            ("b9", {"MC_PROBE_PALLAS": "bucket"}, layout,
             path_of(*dense, "bucket_decode")),
            ("classed", {"MC_DENSE_LIMIT": "1", "MC_CLASSED": "1"},
             "('classed', 61, False, False, 15)", classed)):
        with environ(**env):
            runner, grew, res = phase_query_summary(tmp, name, db, n, lay,
                                                    expect)
        if not np.array_equal(res.statistics.assigned_, hist):
            raise AssertionError(f"{tag}: the rank histogram differs from "
                                 "the default staging's")
        out[f"{tag}_staging_seconds"] = round(runner.stage_s, 3)
        out[f"{tag}_staged_gib"] = round(runner.tables.nbytes() / 2**30, 3)
        if tag == "b9":
            b9 = grew["bucket_decode"]
        if tag == "classed":
            if not 0 < runner.esc_reads < n:
                raise AssertionError("the classed query did not escalate")
            out.update(classed_escalated_reads=runner.esc_reads,
                       classed_redo_batches=grew["candidates"]
                       - n // SCAN_BATCH)
        del runner
        torch.cuda.empty_cache()
    say(f"stagings-{name}", histograms_equal=True, **out)
    return b9


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
    layout = "('two_tier', 61, True, False, 15)"       # pair-packed heads

    def escalated(runner, batches):
        redo = -(-runner.esc_reads // SCAN_BATCH)
        want = {k: 0 for k in kernels.ALL}
        want.update({k: batches + redo for k in cand_kernels()},
                    sketch=batches, head_decode=batches, full_decode=redo)
        return want
    runner, launches, res = phase_query_summary(tmp, name, db, reads,
                                                layout, escalated)
    esc_reads = runner.esc_reads
    share = esc_reads / len(reads)
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
    if grew != path_of("sketch", "full_decode", *cand_kernels())(
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
    lines = phase_query_per_read(tmp, name, db, reads[:65536])
    torch.cuda.empty_cache()

    # MC_PROBE_PALLAS=1: B9 in the bucket probe, B8 before B7 in the redo
    def kernels_on(runner, batches):
        want = escalated(runner, batches)
        want.update(bucket_decode=batches,
                    oidx_decode=want["full_decode"])
        return want
    with environ(MC_PROBE_PALLAS="1"):
        runner, pallas, res1 = phase_query_summary(tmp, name, db, len(reads),
                                                   layout, kernels_on)
    if not np.array_equal(res1.statistics.assigned_,
                          res.statistics.assigned_):
        raise AssertionError("MC_PROBE_PALLAS=1 changed the rank histogram")
    if runner.esc_reads != esc_reads or pallas["oidx_decode"] <= 0:
        raise AssertionError("MC_PROBE_PALLAS=1 escalated otherwise")
    del runner
    torch.cuda.empty_cache()
    with environ(MC_PROBE_PALLAS="1"):
        lines1 = phase_query_per_read(tmp, name, db, reads[:65536],
                                      tag="-probe-kernels")
    if lines1 != lines:
        raise AssertionError("MC_PROBE_PALLAS=1 changed the mapping lines")
    say(f"probe-kernels-{name}", histogram_equal=True, lines_equal=True,
        launches=pallas)
    torch.cuda.empty_cache()
    return launches, pallas


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


def run_long_windows(tmp, genomes, species, profile):
    """The 944 Mbp genomes at -winlen 255 (stride 240), through B2: built
    in two steps (`build` without the 256-strain group, then `modify`
    with it), 2^20 250 bp reads on the summary path (the main path of
    B2), the scan step against the plain path, 65,536 reads on the
    per-read path, and `build+query` of all genomes in one step, whose
    mapping lines must equal the per-read query's on the modified
    database. -> the summary's launches."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.cli.main import main as cli
    name = "944mbp-w255"
    sub = os.path.join(tmp, name)
    os.makedirs(sub)
    t0 = time.time()
    a, b = os.path.join(sub, "a.fa"), os.path.join(sub, "b.fa")
    split = len(genomes) - 256
    write_genomes(a, genomes, species, 0, split)
    write_genomes(b, genomes, species, split)
    tax = os.path.join(sub, "taxonomy")
    write_taxonomy(tax, int(species.max()) + 1)
    gen_s = time.time() - t0
    db = os.path.join(sub, "db")
    steps = {}
    for step, args in (("build", ["build", db, a, "-winlen", "255",
                                  "-taxonomy", tax]),
                       ("modify", ["modify", db, b, "-taxonomy", tax])):
        kernels.reset_counts()
        t0 = time.time()
        if cli(args) != 0:
            raise AssertionError(f"{step} failed")
        steps[step] = dict(seconds=round(time.time() - t0, 3),
                           sketch_long=kernels.SKETCH_LONG.launches,
                           sketch=kernels.SKETCH.launches)
        if steps[step]["sketch_long"] <= 0 or steps[step]["sketch"]:
            raise AssertionError(f"{step} launches {steps[step]}")
    d = Database.load(db)
    p = d.parts[0]
    maxwin = int((p.locations & np.uint64(0xFFFFFFFF)).max())
    if (d.target_count, len(d.parts), d.sketching.winlen,
            d.sketching.winstride) != (len(genomes), 1, 255, 240):
        raise AssertionError(f"{d.target_count} targets, {len(d.parts)} "
                             f"parts, sketching {vars(d.sketching)}")
    say(f"build-{name}", genomes=len(genomes), build_genomes=split,
        modify_genomes=len(genomes) - split, features=p.num_features,
        locations=p.num_locations, max_bucket=p.max_bucket_size,
        max_window=maxwin, data_gen_seconds=round(gen_s, 3), **steps)
    del d, p
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20, 250)
    layout = f"pk{(2 * maxwin).bit_length()}"
    runner, launches, _res = phase_query_summary(
        tmp, name, db, reads, layout,
        path_of("sketch_long", *cand_kernels()))
    say(f"staging-{name}", layout=runner.layout,
        dense_gib=round(runner.dense_bytes / 2**30, 3),
        staged_gib=round(runner.tables.nbytes() / 2**30, 3),
        rows=tuple(runner.tables.fused_rows.shape))
    if profile:
        phase_profile(tmp, name, runner)
    phase_e2e(name, runner, reads)
    del runner
    torch.cuda.empty_cache()
    lines = phase_query_per_read(tmp, name, db, reads[:65536])
    torch.cuda.empty_cache()
    out = os.path.join(sub, "buildquery.txt")
    kernels.reset_counts()
    t0 = time.time()
    if cli(["build+query", "-targets", a, b, "-taxonomy", tax, "-winlen",
            "255", "-query", os.path.join(sub, "reads_per_read.fa"),
            "-out", out]) != 0:
        raise AssertionError("build+query failed")
    bq_s = time.time() - t0
    with open(out) as f:
        bq = [l for l in f if not l.startswith("#")]
    if bq != lines:
        diff = sum(x != y for x, y in zip(bq, lines))
        raise AssertionError(f"build+query: {len(bq)} lines, {diff} differ "
                             "from the per-read query on the modified "
                             "database")
    say(f"build+query-{name}", seconds=round(bq_s, 3), mapping_lines=len(bq),
        equal_to_modified=True, sketch_long=kernels.SKETCH_LONG.launches,
        sketch=kernels.SKETCH.launches)
    torch.cuda.empty_cache()
    return launches


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
        db, maxwin = phase_build(tmp, "944mbp", genomes, species, gen_s,
                                 host_check=True)
        layout = f"pk{(2 * maxwin).bit_length()}"
        if layout != "pk15":
            raise AssertionError(f"944 Mbp database packs as {layout}")
        main_path, hist, stage_s, other = run_config(
            tmp, "944mbp", db, genomes, layout,
            ("sketch", *cand_kernels()), a.profile, other_route=True)
        for k in ("sketch", "candidates"):
            launches[k] = main_path[k]
        # B3 runs on whichever of the two routes splits
        launches["sort"] = main_path["sort"] or other["sort"]
        run_stagings(tmp, "944mbp", Database.load(db), hist, stage_s)
        shutil.rmtree(os.path.join(tmp, "944mbp"))
        main_path = run_long_windows(tmp, genomes, species, a.profile)
        launches["sketch_long"] = main_path["sketch_long"]
        shutil.rmtree(os.path.join(tmp, "944mbp-w255"))
        del genomes, species

        genomes, species, gen_s = generated(many_target_genomes)
        db, maxwin = phase_build(tmp, "many-target", genomes, species,
                                 gen_s)
        if len(genomes) != 9217 or (2 * maxwin).bit_length() != 18:
            raise AssertionError(f"{len(genomes)} targets, max window "
                                 f"{maxwin}")
        # slots do not pack: the dense layout of (tgt, win) lane pairs
        main_path, hist, _s, _o = run_config(
            tmp, "many-target", db, genomes, "True",
            ("sketch", "candidates_unpacked"), a.profile)
        launches["candidates_unpacked"] = main_path["candidates_unpacked"]
        phase_dense_limit(tmp, "many-target", db, hist)
        shutil.rmtree(os.path.join(tmp, "many-target"))

        main_path, pallas = run_two_tier(tmp, a.profile)
        for k in ("head_decode", "full_decode"):
            launches[k] = main_path[k]
        for k in ("bucket_decode", "oidx_decode"):
            launches[k] = pallas[k]
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
                     "library_ms": r["library_ms"],
                     "device_ms": r["device_ms"],
                     "host_us_per_call": r["host_us_per_call"],
                     "shape": r["shape"]})
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
