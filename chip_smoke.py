#!/usr/bin/env python3
"""Smoke run of metacache_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each against its plain PyTorch version on the card, then drives
the port's two query paths through its entry points, each at a scale
its users run:

- packed slots: `build` of the RefSeq-skew database (64 unique +
  12 x 52-strain + 1 x 256-strain genomes of 1 Mbp, 944 Mbp, buckets at
  the 254 cap), whose (target, window) slots pack into int32, and
  `query` through kernels B1, B3 and B4;
- unpacked slots: `build` of a many-target database (one 8 Mbp genome
  plus 36 species x 256 strains of 50 kbp, 9217 targets, 469 Mbp), whose
  slots do not pack into int32, and `query` through B1 and B5.

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


def phase_query_summary(tmp, name, db, reads, layout, path_kernels):
    """A main path: counts are zeroed just before it and read just
    after, so its launches are its own. Each kernel of ``path_kernels``
    launches once per 8192-read batch, every other kernel never."""
    from metacache_tpu_torch import kernels
    path = os.path.join(tmp, name, "reads.fa")
    write_reads(path, reads)
    kernels.reset_counts()
    runner, res, stage_s = _query(db, path, ["-no-map"], io.StringIO())
    grew = {k: v.launches for k, v in kernels.ALL.items()}
    if runner.layout != layout or (runner._pack_bits == 0) != \
            (layout == "True"):
        raise AssertionError(f"layout {runner.layout} with pack bits "
                             f"{runner._pack_bits}, expected {layout}")
    batches = -(-len(reads) // SCAN_BATCH)
    want = {k: batches if k in path_kernels else 0 for k in kernels.ALL}
    if grew != want:
        raise AssertionError(f"launches {grew}, expected {want}")
    n = res.statistics.total()
    if n != len(reads):
        raise AssertionError(f"classified {n} of {len(reads)} reads")
    frac = res.statistics.assigned() / n
    rpm = n / (res.time_ms / 60000.0)
    say(f"query-summary-{name}", reads=n, reads_per_min=round(rpm),
        seconds=round(res.time_ms / 1000, 3),
        classified_fraction=round(frac, 6), layout=runner.layout,
        pack_bits=runner._pack_bits, spf=runner.tables.spf,
        staged_table_gib=round(runner.tables.nbytes() / 2**30, 3),
        staging_seconds=round(stage_s, 3), launches=grew)
    if not frac > 0.5:
        raise AssertionError(f"classified fraction {frac} too low")
    return runner, grew


def phase_profile(tmp, name, runner):
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
    say(f"profile-{name}", wall_seconds=round(wall, 3),
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
    from metacache_tpu_torch.db.state import DeviceTables
    from metacache_tpu_torch.ops.rows import query_step_rows_scan
    b = min(8192, len(reads))
    c4 = np.zeros((b, 128), np.uint8)
    c4[:, :READ_LEN] = reads[:b]
    packed = (c4[:, 0::4] | (c4[:, 1::4] << 2) | (c4[:, 2::4] << 4) |
              (c4[:, 3::4] << 6)).reshape(1, b, 1, 32)
    vmat = np.full((1, b, 1), READ_LEN, np.uint8)
    mwir = np.full((1, b), 2, np.uint8)
    t = runner.tables
    cpu = DeviceTables(t.fused_rows.cpu(), t.bucket_rows.cpu(),
                       t.lineages.cpu(), t.merge_tax.cpu(),
                       num_features=t.num_features,
                       bucket_bits=t.bucket_bits, spf=t.spf,
                       slot_bits=t.slot_bits)
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
    the plain path, and the per-read path; -> the summary's launches."""
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20)
    del genomes
    runner, launches = phase_query_summary(tmp, name, db, reads, layout,
                                           path_kernels)
    if profile:
        phase_profile(tmp, name, runner)
    phase_e2e(name, runner, reads)
    del runner
    torch.cuda.empty_cache()
    phase_query_per_read(tmp, name, db, reads[:65536])
    torch.cuda.empty_cache()
    return launches


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
        main_path = run_config(tmp, "944mbp", db, genomes, layout,
                               ("sketch", "sort", "candidates"), a.profile)
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
        main_path = run_config(tmp, "many-target", db, genomes, "True",
                               ("sketch", "candidates_unpacked"), a.profile)
        launches["candidates_unpacked"] = main_path["candidates_unpacked"]
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
