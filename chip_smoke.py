#!/usr/bin/env python3
"""Smoke run of metacache_tpu_torch on one NVIDIA GPU.

Builds the CUDA kernels from csrc/ (one nvcc per source, in parallel),
holds each against its plain PyTorch version on the card (the 64-bit
sketch kernel of k > 16 too, at k 17, 18, 24 and 32), holds the
device table builder on the card against the same builder on CPU
tensors, then drives the port's query paths through its entry points,
each at a scale its users run. `build` builds its tables on the card
(the device builder) and saves them exported as CSR; `query` uploads the
saved CSR and fills the probe rows on the card.

- packed slots, dense rows: `build` of the RefSeq-skew database (64
  unique + 12 x 52-strain + 1 x 256-strain genomes of 1 Mbp, 944 Mbp,
  buckets at the 254 cap), whose (target, window) slots pack into int32,
  held equal to a host build of the same genomes, and `query` through
  kernels B1, B9 (the bucket probe of every row layout), dense_decode
  (the rows' probe) and B4, which sorts each row itself (or B1, B9,
  dense_decode, B3 and B4 on the split route, MC_SPLIT_CAND=1); the
  same query once more on the other route, and under each other
  staging, all with the same rank histogram: host rows
  (MC_DEVICE_LAYOUT=0, B9 on the host's 65-lane index), and the
  size-classed cells with escalation (MC_DENSE_LIMIT=1 MC_CLASSED=1:
  classed_bucket and classed_decode's head form in phase 1, its full
  form in the redo), where classed_bucket and classed_decode are held
  against their plain versions at the main path's probes;
- unpacked slots: `build` of a many-target database (one 8 Mbp genome
  plus 36 species x 256 strains of 50 kbp, 9217 targets, 469 Mbp), whose
  slots do not pack into int32, and `query` through B1, dense_decode and
  B5; once more with MC_DENSE_LIMIT=1, which stages it two-tier (lane
  rows, dense_decode too);
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
  and B4 (B9 the bucket probe of phase 1); once more with MC_ESCALATE=0
  (B7 on every batch) and with MC_PROBE_PALLAS=1, which changes no
  route (B8's overflow-row id is folded into B7, which must launch B8
  no time and equal B8 then B7 on the query's own probes) and must give
  the same result, per read too;
- long reads: 2^14 reads of log-normal lengths (median 480 bp, clipped
  to 200-19,000 bp, the reference's long-read workload; the spread is
  assumed) against the 944 Mbp database with per-read output and
  -tophits: window buckets up to 256 windows, rows of up to 1 M slots;
  rows one block holds through B1 and B4, wider ones through B4's wide
  form, ranges past 48 windows (which JAX does not fuse) through the
  non-fused result path (torch sorts and scans); the same reads with
  MC_FUSED_CANDIDATES=0 give byte-identical mapping lines; the routes
  the runner's batching predicts for the same lengths equal the
  measured ones, and are printed for spreads of 0.7 and 1.5 too; and
  2^13 long reads against the many-target database the same way,
  through B5 and B5's wide form;
- taxon merging: the many-target database with -lowest species -maxcand
  8 -allhits on 2^14 reads (the non-fused path with per-hit lists), its
  card result held in all nine QueryResult fields against the same
  rows_to_result on CPU tensors, on three 512-row blocks of its batch;
- paired-end reads: 2 x 100 bp mates of fragments of normal(300, 30) bp
  clipped to 200-500 bp (an assumed library), mate 2 reverse-
  complemented: 2^20 pairs on the summary path (-pairfiles -no-map, two
  coded windows a pair) of the 944 Mbp database through B1 and B4, and
  2^16 of them per read (-tophits; -insertsize 500; interleaved with
  -pairseq and with MC_FUSED_CANDIDATES=0, whose lines must not change;
  the per-read rank counts equal to the summary's); 2^16 pairs on the
  many-target database through B1 and B5, per read the same; 2^20 pairs
  on the 1456 Mbp database escalated (B1, B6, B4, then B7, B4 on the
  flagged pairs), the same histogram under MC_ESCALATE=0; each path
  with one stack against the plain path on CPU tensors;
- multi-part: the 944 Mbp genomes built with `build -parts 2` (the host
  build), staged part by part within one budget; 2^16 reads and 2^16
  pairs per read through the multi-part step (B1 once, every part's
  probe, B4 on the concatenated rows), the same lines under
  MC_FUSED_CANDIDATES=0, and one batch against the same step on CPU
  tensors of both parts in all nine QueryResult fields (512 of its reads
  also with -maxcand 8: the non-fused path and its per-hit lists).

- 64-bit features: the 944 Mbp genomes built with `build -kmerlen 18`
  (the host table build, sketched on the card by the 64-bit sketch
  kernel), staged as u64 dense rows; 2^20 reads on the summary path
  (the 64-bit sketch kernel on the runner's packed rows, B4), one stack
  against the plain path on CPU tensors; 2^14 reads and 2^14 pairs per
  read, byte-identical under MC_FUSED_CANDIDATES=0; the same database
  staged as u64 two-tier rows under a smaller MC_HBM_GB, the same rank
  histogram;
- host-side modes on the 944 Mbp database: -cov-percentile 50 on 2^16
  reads and -align on 128 reads (each lines equal under
  MC_FUSED_CANDIDATES=0; -align's share of blocks on the read's true
  genome), and the interactive mode fed two lines of 2,048 reads, whose
  lines equal the two direct queries';
- the non-fused batch within free memory: the two-part database's
  non-fused per-read query, and 2^14 of its reads with -allhits, once
  more beside a ballast tensor that leaves 12 GiB free: several
  launches, the same lines;
- grids of devices: the 944 Mbp database under -table-shards 4 on
  cuda:0 repeated four times (and on four distinct cards where the host
  has them), its four feature ranges staged two-tier; the summary's
  2^20 reads through the sharded steps (B1 on each position's quarter
  of a batch, B6 heads, the exchange, B4; the flagged reads redone
  through B7 and B4) with the unsharded histogram, a profile of 2^17
  of them beside the unsharded one's, and the per-read phase's 2^16
  reads with byte-identical lines; -replicate 2 on cuda:0 repeated (one
  staged copy), the same lines; and two processes of the multi-process
  dryrun worker joined by gloo, each checking its rows on the card;
- the CSR layout (databases no row layout fits): the 944 Mbp database
  under the MC_HBM_GB whose budget admits its CSR bytes and no row
  layout (the window is computed from the database's bytes and
  printed), 2^20 reads on the summary path through B1, csr_decode and
  B4 with the dense staging's rank histogram, one stack against the
  plain path on CPU tensors, and the per-read phase's 2^16 reads, whose
  lines must equal the dense staging's byte for byte; the many-target
  database the same way through B5 (summary); the k = 18 database under
  MC_DEVICE_LAYOUT=0 (the u64 CSR, searched by its sign-flipped
  features) through the 64-bit sketch kernel, csr_decode and B4
  (summary); each with its staging seconds split into the host's
  (unpack_locations among them) and the card's, and a profile of a warm
  second query.

B3 runs ahead of B4 wherever MC_SPLIT_CAND=1 selects the split route.
At winlen 127 the summary path hands B1 the runner's 2-bit packed rows,
which B1 reads itself.
Each path queries 2^20 reads (100 bp; 250 bp at winlen 255) on the
summary path, 65,536 reads on the per-read path, and one batch of the
scan step compared with the plain path on CPU tensors of the same
tables. The fused candidate kernels and the non-fused result path are
timed against each other at the short-read widths (the JAX runner's
FUSED_MIN_SLOTS crossover). B4's and B5's wide forms are held against
their plain versions at the long-read path's widths, on both of their
routes (one thread block cluster a row up to 8 sort tiles, merge passes
in device memory above), with the cluster kernel's resident clusters,
registers and spills.

Run from the repository root with no arguments:  python3 chip_smoke.py
It exits non-zero without a CUDA device. Its last stdout line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
`--profile` adds torch.profiler traces of the summaries (those of the
CSR stagings are always traced).
The builds that run on the host (the 944 Mbp host build held against
the device build, `build -parts 2`, `build -kmerlen 18`, and the
-winlen 255 `build` and `modify`) run in a second process of this
script (``--jobs``, the class ``Background``) beside the queries of the
phases before the one that needs them; the script waits for it before
any phase whose routes depend on the card's free memory, and stops it
when it exits.
"""
from __future__ import annotations

import argparse
import collections
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
CSR_FEATURES = 1 << 24     # features of the csr_decode parity table
LONG_READS = 1 << 14       # reads of the long-read phase (944 Mbp)
LONG_READS_MANY = 1 << 13  # long reads against the many-target database
MERGE_READS = 1 << 14      # reads of the taxon-merging phase
PAIRS = 1 << 20            # read pairs of the paired summary queries
PAIRS_PER_READ = 1 << 16   # pairs of the per-read and many-target phases
# -align re-reads the top target's record from its source FASTA for
# every read (as JAX and the reference binary do); the 944 Mbp genomes
# are written one file a genome, so a re-read scans about 1 MB
ALIGN_READS = 128
REPL_READS = 2048          # reads a line of the interactive-mode phase
K18_PER_READ = 1 << 14     # reads and pairs of the k = 18 per-read phase
ALLHITS_READS = 1 << 14    # -allhits reads of the ballast phase
SHARDS = 4                 # -table-shards of the grid phase
REPLICAS = 2               # -replicate of the grid phase
GRID_PROFILE_READS = 1 << 17   # reads of the grid phase's profiles
# kernels no main path launches: B8's work is done by B7 (ops/rows.py)
FOLDED = {"oidx_decode": "full_decode"}
# the probe of dense rows, two-tier lane rows and u64 rows, a launch a
# batch (a part) wherever such rows are staged
DENSE = "dense_decode"
# the step's tail: the ranked LCA (every step) and the rank histogram (every
# summary stack on the card)
TAIL = ("classify_lca", "rank_hist")
# the least time of a kernel: the larger of its bytes over the card's
# memory rate and its integer operations over the 32-bit rate outside
# the tensor cores (H100 SXM, NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12
CARD = ""
T_START = time.time()


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
    """One result line; ``t`` is the seconds since the script started."""
    print(f"[{phase}] card={CARD!r} t={time.time() - T_START:.1f} " +
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


def write_reference(tmp, genomes, species, per_genome: bool = False):
    """The genomes as one FASTA file, or (``per_genome``) as a directory
    of one file a genome, GEN<i>.fa, which `build` reads in name order.
    -> (FASTA file or directory, taxonomy directory)."""
    fa = os.path.join(tmp, "genomes.fa")
    if per_genome:
        fa = os.path.join(tmp, "genomes")
        os.makedirs(fa)
        for i in range(len(genomes)):
            write_genomes(os.path.join(fa, "GEN%05d.fa" % i), genomes,
                          species, i, i + 1)
    else:
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


def by_genome(gsel, ngenomes: int):
    """(genome, the indices that drew it, increasing) for each genome
    drawn, from one stable sort of the draws."""
    order = np.argsort(gsel, kind="stable")
    cuts = np.searchsorted(gsel[order], np.arange(ngenomes + 1))
    for g in np.nonzero(cuts[1:] > cuts[:-1])[0]:
        yield g, order[cuts[g]:cuts[g + 1]]


def sample_reads(rng, genomes, n: int, read_len: int = READ_LEN,
                 with_genomes: bool = False):
    """n reads of read_len from uniformly drawn genomes (of any lengths)
    and positions, with Poisson(read_len / 100) substitutions, a 1% rate
    (the draw of bench.py:149-159); ``with_genomes``: -> (reads, the
    genome index of each)."""
    glen = np.array([len(g) for g in genomes])
    gsel = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, glen[gsel] - read_len)
    reads = np.empty((n, read_len), np.uint8)
    for g, sel in by_genome(gsel, len(genomes)):
        reads[sel] = genomes[g][pos[sel, None] + np.arange(read_len)]
    nm = rng.poisson(read_len / 100, n)
    rows = np.repeat(np.arange(n), nm)
    reads[rows, rng.integers(0, read_len, len(rows))] = \
        rng.integers(0, 4, len(rows), dtype=np.uint8)
    return (reads, gsel) if with_genomes else reads


def write_reads(path, reads):
    with open(path, "wb") as f:
        lines = ACGT[reads]
        for i in range(len(reads)):
            f.write(b">r%d\n" % i + lines[i].tobytes() + b"\n")


def long_read_lengths(rng, n: int, sigma: float = 1.0) -> np.ndarray:
    """n log-normal read lengths, median 480 bp, clipped to
    200..19,000 bp. The reference states the range and the median only
    (BASELINE.md); the spread ``sigma`` is assumed."""
    return np.clip(np.round(480 * np.exp(rng.normal(0.0, sigma, n))), 200,
                   19000).astype(np.int64)


def sample_long_reads(rng, genomes, n: int):
    """n reads of ``long_read_lengths`` (the reference's long-read
    workload: 200 bp to 19,000 bp, median 480, BASELINE.md; the spread
    is assumed), from uniformly drawn genomes
    and positions, with Poisson(length / 100) substitutions, the draw of
    ``sample_reads``. -> (codes of all reads concatenated, offsets)."""
    lens = long_read_lengths(rng, n)
    glen = np.array([len(g) for g in genomes])
    gsel = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, glen[gsel] - lens)
    offs = np.concatenate([[0], np.cumsum(lens)])
    codes = np.empty(offs[-1], np.uint8)
    for i in range(n):
        codes[offs[i]:offs[i + 1]] = genomes[gsel[i]][pos[i]:pos[i] + lens[i]]
    nm = rng.poisson(lens / 100)
    rows = np.repeat(np.arange(n), nm)
    codes[offs[rows] + rng.integers(0, lens[rows])] = \
        rng.integers(0, 4, len(rows), dtype=np.uint8)
    return codes, offs


def write_long_reads(path, codes, offs):
    text = ACGT[codes]
    with open(path, "wb") as f:
        for i in range(len(offs) - 1):
            f.write(b">r%d\n" % i + text[offs[i]:offs[i + 1]].tobytes() +
                    b"\n")


def sample_pairs(rng, genomes, n: int, read_len: int = READ_LEN):
    """n read pairs of read_len from fragments of normal(300, 30) bp
    clipped to 200-500 bp (an assumed library: the repo's sources give
    none) at uniformly drawn genomes and positions: mate 1 the
    fragment's start, mate 2 the reverse complement of its end, each
    with Poisson(read_len / 100) substitutions, the draw of
    ``sample_reads``. -> (mate 1 codes (n, read_len), mate 2 codes)."""
    frag = np.clip(np.round(rng.normal(300, 30, n)), 200, 500).astype(
        np.int64)
    glen = np.array([len(g) for g in genomes])
    gsel = rng.integers(0, len(genomes), n)
    pos = rng.integers(0, glen[gsel] - frag)
    span = np.arange(read_len)
    m1 = np.empty((n, read_len), np.uint8)
    m2 = np.empty((n, read_len), np.uint8)
    for g, sel in by_genome(gsel, len(genomes)):
        m1[sel] = genomes[g][pos[sel, None] + span]
        m2[sel] = genomes[g][(pos[sel] + frag[sel] - read_len)[:, None] +
                             span]
    m2 = np.ascontiguousarray(3 - m2[:, ::-1])    # codes 0..3 = ACGT
    for m in (m1, m2):
        nm = rng.poisson(read_len / 100, n)
        rows = np.repeat(np.arange(n), nm)
        m[rows, rng.integers(0, read_len, len(rows))] = \
            rng.integers(0, 4, len(rows), dtype=np.uint8)
    return m1, m2


def write_pairs(sub, tag, m1, m2, interleaved=False):
    """Mates as two FASTA files (``p<i>/1``, ``p<i>/2``) and, with
    ``interleaved``, as one file of consecutive records (-pairseq).
    -> the file names, relative to ``sub``."""
    names = [f"{tag}_1.fa", f"{tag}_2.fa"]
    l1, l2 = ACGT[m1], ACGT[m2]
    with open(os.path.join(sub, names[0]), "wb") as f1, \
            open(os.path.join(sub, names[1]), "wb") as f2:
        for i in range(len(m1)):
            f1.write(b">p%d/1\n" % i + l1[i].tobytes() + b"\n")
            f2.write(b">p%d/2\n" % i + l2[i].tobytes() + b"\n")
    if interleaved:
        names.append(f"{tag}_seq.fa")
        with open(os.path.join(sub, names[2]), "wb") as f:
            for i in range(len(m1)):
                f.write(b">p%d/1\n" % i + l1[i].tobytes() + b"\n>p%d/2\n"
                        % i + l2[i].tobytes() + b"\n")
    return names


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
    phase_parity_sketch64(results, np.random.default_rng(64), dev)

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

    phase_parity_wide(results, rng, dev)
    phase_parity_decode(results, rng, dev)
    phase_parity_csr(results, np.random.default_rng(99), dev)
    phase_parity_dense(results, np.random.default_rng(17), dev)
    phase_parity_tail(results, np.random.default_rng(18), dev)
    phase_parity_probe(results, rng, dev)


def phase_parity_wide(results, rng, dev):
    """B4's and B5's wide forms (rows past one block's shared memory)
    against their plain versions, tolerance 0, on both routes
    (ops/candidates.py::wide_route: one cluster launch a row up to 8
    sort tiles, merge passes in device memory above): the cluster
    kernel's resident clusters of 2, 4 and 8 blocks, registers and local
    (spill) bytes first; packed rows of 65,536, 131,072 and 262,144
    slots (2, 4 and 8 tiles) in runs of 256 (the probe's alternating
    runs at 256 slots a feature) with the dedup sweep at 16, 32 and 48
    (the long-read path's ranges), walk 32 on unsorted rows and dedup 6
    on sorted rows (presorted = L2), 524,288 slots (16 tiles, the merge
    passes); pairs at 32,768, 65,536 and 131,072 (2, 4 and 8 tiles) and
    262,144 (16), walk 32 and dedup 6 and 16; and rows of 2^20 where one
    target's hits pass 2^31 / L2 (the int64 keys). Each kernels-line row
    is timed at the widest shape of the long-read batches that take it;
    every shape's device time (CUDA graph) and bound are printed."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.ops import candidates as C
    r = 256
    info = {}
    for pairs in (False, True):
        for nc in (2, 4, 8):
            x = kernels.wide_cluster_info(pairs, nc)
            if x["max_active_clusters"] < 1:
                raise AssertionError(f"no cluster of {nc} blocks fits: {x}")
            info[pairs, nc] = x
    for pairs in (False, True):
        x = info[pairs, 8]
        say("wide-cluster-kernel", slots="pairs" if pairs else "packed",
            max_active_clusters={nc: info[pairs, nc]["max_active_clusters"]
                                 for nc in (2, 4, 8)},
            registers=x["registers"], local_bytes=x["local_bytes"],
            shared_bytes=x["shared_bytes"])

    def mwir(b, m):
        return torch.full((b,), m, dtype=torch.int32, device=dev)

    def plain(pk, mw, walk_elems=0, dedup_walk=0, max_candidates=2, **_):
        return C.candidates_sorted_plain(C.sort_packed_plain(pk), mw, 15,
                                         walk_elems, dedup_walk,
                                         max_candidates)

    def deep(b, l2):
        """(b, l2) rows, 3,000 slots of one target at two windows."""
        tgt = rng.integers(0, 944, (b, l2))
        win = rng.integers(0, 8929, (b, l2))
        tgt[:, :3000], win[:, :3000] = 7, rng.integers(40, 42, (b, 3000))
        return tgt, win

    def timed(shapes, call, pairs):
        """Each shape's device ms (kernel_ms) and bound (the kernels
        line's byte and operation counts), by route."""
        out = {}
        for l2_, (args, b_) in sorted(shapes.items()):
            tag = f"{C.wide_route(l2_, pairs)}_{b_}x{l2_}"
            out[f"ms_{tag}"] = kernel_ms(lambda a=args: call(*a), reps=5)
            out[f"bound_ms_{tag}"] = bound(
                b_ * l2_ * (8 if pairs else 4) + b_ * 36,
                sort_ops(b_, l2_, r, 2 if pairs else 1) +
                b_ * l2_ * (10 if pairs else 8))[0]
        return out
    errs, shapes = {}, {}
    for b, f, m in ((512, 256, 16), (128, 512, 32), (64, 1024, 48),
                    (32, 2048, 48)):
        pk = torch.from_numpy(alternating_runs(rng, b, f, r)).to(dev)
        shapes[f * r] = ((pk, mwir(b, m), m), b)
        route = C.wide_route(f * r, False)
        for kk in (2, 4):
            kw = dict(dedup_walk=m, max_candidates=kk, presorted=r)
            got = torch.stack(C.candidates_packed(pk, mwir(b, m), 15, **kw),
                              dim=2)
            errs[f"{route}_{b}x{f * r}_dedup{m}_K{kk}"] = check_equal(
                f"B4 wide {b}x{f * r} dedup {m} K={kk}", got,
                plain(pk, mwir(b, m), **kw))
    pk = shapes[1 << 16][0][0]
    for name, x, kw in (
            ("65536_unsorted_walk32", pk[:, torch.randperm(
                1 << 16, device=dev)], dict(walk_elems=32)),
            ("65536_sorted_dedup6", torch.sort(pk, dim=1).values,
             dict(dedup_walk=6, sorted_input=True))):
        got = torch.stack(C.candidates_packed(x, mwir(len(x), 6), 15, **kw),
                          dim=2)
        errs[f"cluster_{name}"] = check_equal(f"B4 wide {name}", got,
                                              plain(x, mwir(len(x), 6), **kw))
    t, w = deep(2, 1 << 20)
    dpk = torch.from_numpy(((t << 15) | w).astype(np.int32)).to(dev)
    got = torch.stack(C.candidates_packed(dpk, mwir(2, 4), 15, dedup_walk=6),
                      dim=2)
    want = plain(dpk, mwir(2, 4), dedup_walk=6)
    errs["passes_2x1048576_int64_keys"] = check_equal("B4 wide int64 keys",
                                                      got, want)
    if int(want[0, 0, 1]) << 20 < 2**31:
        raise AssertionError("the int64-key case stays below 2^31")
    # the kernels line: the long-read path's widest wide-form batches
    # (rank-join takes the wider ones)
    (pk, mw, m), b = shapes[1 << 18]
    kw = dict(dedup_walk=m, max_candidates=2, presorted=r)
    ms = cuda_ms(lambda: C.candidates_packed(pk, mw, 15, **kw))
    pms = cuda_ms(lambda: plain(pk, mw, **kw))
    hus = host_us(lambda: C.candidates_packed(pk, mw, 15, **kw), reps=20)
    dms = kernel_ms(lambda: C.candidates_packed(pk, mw, 15, **kw), reps=5)
    b, l2 = pk.shape
    b_ms, by = _record(
        results, "candidates_wide", err=max(errs.values()), ms=ms,
        plain_ms=pms, host_us=hus, device_ms=dms,
        nbytes=pk.numel() * 4 + b * 4 + b * 2 * 16,
        nops=sort_ops(b, l2, r, 1) + pk.numel() * 8,
        shape=f"({b}, {l2}) slots, presorted=256, dedup {m}, K=2")
    per = timed(shapes, lambda x, mw_, m_: C.candidates_packed(
        x, mw_, 15, dedup_walk=m_, max_candidates=2, presorted=r), False)
    # the same rows sorted (presorted = L2): the load and the sweep alone
    srt = torch.sort(pk, dim=1).values
    per["ms_cluster_64x262144_sorted_input"] = kernel_ms(
        lambda: C.candidates_packed(srt, mw, 15, dedup_walk=m,
                                    max_candidates=2, sorted_input=True),
        reps=5)
    del srt
    (pk, mw, m), _b = shapes[1 << 19]
    host_passes = host_us(lambda: C.candidates_packed(
        pk, mw, 15, dedup_walk=m, max_candidates=2, presorted=r), reps=20)
    say("parity-B4-wide", tolerance=0, max_abs_err=max(errs.values()),
        cases=errs, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        host_us_per_call=hus, kernel_device_ms=dms, shape=(b, l2),
        route=C.wide_route(l2, False),
        host_us_per_call_passes_32x524288=host_passes, **per)
    del shapes, pk, dpk

    errs = {}
    pairs = {}
    for b, f in ((512, 128), (128, 256), (64, 512), (32, 1024)):
        tt, ww = (torch.from_numpy(x).to(dev)
                  for x in alternating_pairs(rng, b, f, r))
        pairs[f * r] = ((tt, ww, mwir(b, 6)), b)
        route = C.wide_route(f * r, True)
        for kk, kw in ((2, dict(walk_elems=32)), (4, dict(dedup_walk=6)),
                       (2, dict(dedup_walk=16))):
            got = torch.stack(C.candidates_unpacked(
                tt, ww, mwir(b, 6), max_candidates=kk, presorted=r, **kw),
                dim=2)
            (sweep, e), = kw.items()
            errs[f"{route}_{b}x{f * r}_{sweep}{e}_K{kk}"] = check_equal(
                f"B5 wide {b}x{f * r} {sweep} {e} K={kk}", got,
                C.candidates_unpacked_plain(tt, ww, mwir(b, 6),
                                            max_candidates=kk, **kw))
    t, w = (torch.from_numpy(x.astype(np.int32)).to(dev)
            for x in deep(2, 1 << 20))
    got = torch.stack(C.candidates_unpacked(t, w, mwir(2, 4), dedup_walk=6),
                      dim=2)
    errs["passes_2x1048576_int64_keys"] = check_equal(
        "B5 wide int64 keys", got,
        C.candidates_unpacked_plain(t, w, mwir(2, 4), dedup_walk=6))
    (tt, ww, mw), b = pairs[1 << 15]
    b, l2 = tt.shape
    kw = dict(dedup_walk=6, max_candidates=2, presorted=r)
    ms = cuda_ms(lambda: C.candidates_unpacked(tt, ww, mw, **kw))
    pms = cuda_ms(lambda: C.candidates_unpacked_plain(
        tt, ww, mw, dedup_walk=6, max_candidates=2))
    hus = host_us(lambda: C.candidates_unpacked(tt, ww, mw, **kw), reps=20)
    dms = kernel_ms(lambda: C.candidates_unpacked(tt, ww, mw, **kw), reps=5)
    b_ms, by = _record(
        results, "candidates_unpacked_wide", err=max(errs.values()), ms=ms,
        plain_ms=pms, host_us=hus, device_ms=dms,
        nbytes=tt.numel() * 8 + b * 4 + b * 2 * 16,
        nops=sort_ops(b, l2, r, 2) + tt.numel() * (6 + 4),
        shape=f"({b}, {l2}) (tgt, win) slots, presorted=256, dedup 6, K=2")
    per = timed(pairs, lambda x, y, mw_: C.candidates_unpacked(
        x, y, mw_, **kw), True)
    say("parity-B5-wide", tolerance=0, max_abs_err=max(errs.values()),
        cases=errs, ms=ms, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        host_us_per_call=hus, kernel_device_ms=dms, shape=(b, l2),
        route=C.wide_route(l2, True), **per)
    del pairs, tt, ww, t, w
    torch.cuda.empty_cache()


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


def sketch64_resources() -> dict:
    """Registers, local (spill) and shared bytes of the 64-bit sketch
    kernel's three instances: packed rows, coded rows of one 128-start
    chunk, coded rows of several."""
    from metacache_tpu_torch import kernels
    return {f"{name}_{f}": x for name, packed, multi in (
        ("packed", True, False), ("coded", False, False),
        ("coded_multi", False, True))
        for f, x in kernels.sketch64_info(packed, multi).items()}


def sketch64_shapes(rng) -> dict:
    """name -> (rows, valid lengths, packed) of the 64-bit sketch
    kernel's parity and timing cases: the build's (65536, 128) coded
    windows, the k = 18 summary path's packed rows (8192, 28 bytes: 100
    bp reads), 250 bp windows (8192, 256), and windows of several
    128-start chunks, (8192, 511) and (2048, 1024), with valid lengths
    at the chunk boundary of k = 18 (145, 146 and 147) and windows of
    one repeated k-mer (all code 0)."""
    codes, valid = sketch_inputs(rng, 65536)
    clean = np.where(codes < 4, codes, 2).astype(np.uint8)
    out = {"65536x128": (codes, valid, False),
           "8192x28_packed": (pack_2bit(clean[:SCAN_BATCH, :112]),
                              valid[:SCAN_BATCH], True),
           "8192x256": (*long_sketch_inputs(rng, SCAN_BATCH, 256, 18, 250),
                        False)}
    for n, w in ((SCAN_BATCH, 511), (2048, 1024)):
        lc, lv = long_sketch_inputs(rng, n, w, 18, w)
        lc[10::101] = 0
        lv[12::29], lv[14::31], lv[15::37] = 145, 146, 147
        out[f"{n}x{w}"] = (lc, lv, False)
    return out


def sketch64_work(rows: np.ndarray, valid: np.ndarray, packed: bool,
                  s: int = 16):
    """-> (bytes, operations) of the 64-bit sketch at k = 18 for bound():
    the rows and valid lengths read, 8 s bytes a window written; its
    64-bit arithmetic as 32-bit operations, about twice B1's 22 a k-mer
    position."""
    width = 4 * rows.shape[1] if packed else rows.shape[1]
    kpos = int(np.maximum(np.minimum(valid, width).astype(np.int64) - 17,
                          0).sum())
    return rows.nbytes + valid.nbytes + 8 * s * len(rows), 44 * kpos


def phase_parity_sketch64(results, rng, dev):
    """The 64-bit sketch kernel (k > 16) against its plain version,
    tolerance 0, at k 17, 18, 24 and 32, s = 16, on sketch64_shapes'
    rows (packed rows against the plain version of their unpacked
    codes). Timed at each shape at k = 18 (CUDA events, a CUDA graph,
    the host's time a call) beside its bound (sketch64_work); no
    PyTorch call computes this sketch, so no library time. Prints the
    kernel's registers, spill and shared bytes. The kernels line's row
    is (65536, 128), k = 18."""
    from metacache_tpu_torch.ops import sketch as S
    cases, work = {}, {}
    for name, (rows, vl, packed) in sketch64_shapes(rng).items():
        r, v = torch.from_numpy(rows).to(dev), torch.from_numpy(vl).to(dev)
        if packed:
            cases[name] = (
                lambda k, r=r, v=v: S.sketch_windows_packed(r, v, k, 16),
                lambda k, u=S.unpack_2bit(r), v=v:
                    S.sketch_windows64_plain(u, v, k, 16))
        else:
            cases[name] = (
                lambda k, r=r, v=v: S.sketch_windows(r, v, k, 16),
                lambda k, r=r, v=v: S.sketch_windows64_plain(r, v, k, 16))
        work[name] = sketch64_work(rows, vl, packed)
    errs = {}
    for k in (17, 18, 24, 32):
        for name, (got, want) in cases.items():
            errs[f"{name}_k{k}"] = check_equal(f"sketch64 {name} k{k}",
                                               got(k), want(k))
    timed = {}
    for name, (got, want) in cases.items():
        b_ms, by = bound(*work[name])
        timed[name] = dict(ms=cuda_ms(lambda: got(18)),
                           device_ms=kernel_ms(lambda: got(18)),
                           host_us=host_us(lambda: got(18)),
                           plain_ms=cuda_ms(lambda: want(18)),
                           bound_ms=b_ms, bound_by=by)
    t = timed["65536x128"]
    nbytes, nops = work["65536x128"]
    _record(results, "sketch64", err=max(errs.values()), ms=t["ms"],
            plain_ms=t["plain_ms"], nbytes=nbytes, nops=nops,
            device_ms=t["device_ms"], host_us=t["host_us"],
            shape="(65536, 128) windows, k=18, s=16")
    say("parity-sketch64", tolerance=0, max_abs_err=max(errs.values()),
        cases=len(errs), library_ms=None, **sketch64_resources(),
        **{f"{n}_{f}": x for n, d in timed.items() for f, x in d.items()})


def phase_parity_b4(results, rng, dev, alt, rnd, alt1k, wide, r):
    """B4 in both forms against its plain version (the plain sort, then
    the plain sweep), tolerance 0: the split form (rows as B3 leaves
    them, sorted: presorted = L2) at walk 32 with K 2 and 4, walk 48 and
    dedup 6; the fused form on unsorted rows, on alternating runs of 256
    and of 64 (the 1456 Mbp phase-1 shape, 8192 x 1024) and on sorted
    rows; the split route (B3, then B4) on the same runs; the widest row,
    1024 x 32768, in both. Times the split form alone, the fused form and
    the split route in turns at 8192 x 4096 (presorted 256) and
    8192 x 1024 (presorted 64), each beside its bound; the shapes of the
    paired and multi-part paths (b4_paired_multipart_shapes) and of the
    -table-shards path (b4_grid_shapes). The kernels line's row is the
    form that MC_SPLIT_CAND's default runs."""
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
    paths = b4_paired_multipart_shapes(C, plain, mwir, dev, errs)
    paths.update(b4_grid_shapes(C, plain, mwir, dev, errs))
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
        bound_8192x1024_ms=fused1k_b[0], turns_8192x1024=reads1k, **paths)


def b4_paired_multipart_shapes(C, plain, mwir, dev, errs):
    """B4 (sorting its own rows) at the shapes the paired and multi-part
    paths give it: the paired summary's rows of 8,192 slots (32 features
    x 256-lane runs, 8192 pairs), dedup 3; the multi-part per-read
    batch, 65,536 rows of 8,192 slots sorted whole (presorted 0), walk
    32, held against the plain version on its first 2,048 rows. Their
    own generator, so the later phases' data stay as they were.
    -> their device ms and bounds."""
    rng = np.random.default_rng(810)
    pair = torch.from_numpy(alternating_runs(rng, 8192, 32, 256)).to(dev)
    base = torch.from_numpy(rng.permuted(slot_rows(rng, 4096, 8192),
                                         axis=1)).to(dev)
    multi = base.repeat(16, 1)
    del base
    out = {}
    for name, pk, m, kw, pre in (
            ("pairs_8192x8192_presorted256_dedup3", pair, 3,
             dict(dedup_walk=3), 256),
            ("multipart_65536x8192_presorted0_walk32", multi, 2,
             dict(walk_elems=32), 0)):
        mw = mwir(pk, m)
        chk = pk[:2048]
        got = torch.stack(C.candidates_packed(chk, mw[:2048], 15,
                                              max_candidates=2,
                                              presorted=pre, **kw), dim=2)
        errs[name] = check_equal(f"B4 {name}", got,
                                 plain(chk, mw[:2048], **kw))
        rows, l2 = pk.shape
        out[f"{name}_device_ms"] = kernel_ms(lambda: C.candidates_packed(
            pk, mw, 15, max_candidates=2, presorted=pre, **kw), reps=5)
        # the rows and mwir read once, (rows, K=2, 4) results written
        out[f"{name}_bound_ms"] = bound(
            pk.numel() * 4 + rows * 4 + rows * 2 * 16,
            sort_ops(rows, l2, pre or 1, 1) + pk.numel() * 8)[0]
    return out


def b4_grid_shapes(C, plain, mwir, dev, errs):
    """B4 (sorting its own rows) at the shapes the -table-shards 4
    summary gives it (run_shards): a position's 1,024 rows of a
    4,096-row batch after the exchange, each row SHARDS shard blocks of
    16 features side by side -- the head step's runs of 64 lanes
    (1024 x 4096, presorted 64) and the redo's runs of 256 (1024 x
    16384, presorted 256). The runs alternate across the block
    boundaries, as presorted_runs (parallel/rows_mesh.py) takes them.
    Walk 32, K = 2, tolerance 0, on all rows. Their own generator.
    -> their ms, device ms and bounds."""
    rng = np.random.default_rng(1504)
    out = {}
    for name, runs in (("grid_head_1024x4096_presorted64", 64),
                       ("grid_redo_1024x16384_presorted256", 256)):
        pk = torch.from_numpy(alternating_runs(rng, 1024, SHARDS * 16,
                                               runs)).to(dev)
        mw = mwir(pk, 2)
        kw = dict(walk_elems=32, max_candidates=2, presorted=runs)
        got = torch.stack(C.candidates_packed(pk, mw, 15, **kw), dim=2)
        errs[name] = check_equal(f"B4 {name}", got, plain(pk, mw, **kw))
        rows, l2 = pk.shape
        out[f"{name}_ms"] = cuda_ms(lambda: C.candidates_packed(
            pk, mw, 15, **kw))
        out[f"{name}_device_ms"] = kernel_ms(lambda: C.candidates_packed(
            pk, mw, 15, **kw), reps=5)
        out[f"{name}_plain_ms"] = cuda_ms(lambda: plain(pk, mw, **kw))
        # the rows and mwir read once, (rows, K=2, 4) results written
        out[f"{name}_bound_ms"] = bound(
            pk.numel() * 4 + rows * 4 + rows * 2 * 16,
            sort_ops(rows, l2, runs, 1) + pk.numel() * 8)[0]
    return out


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


def csr_table(rng, dev, nf: int, ntgt: int, nwin: int):
    """A CSR of nf features on the card at the 944 Mbp database's bucket
    depths (1-16 locations, every 64th feature 200-399, past the 254
    cap): int64 offsets, targets below ``ntgt``, windows below ``nwin``
    (made on the card from a seed)."""
    cnt = rng.integers(1, 17, nf)
    cnt[::64] = rng.integers(200, 400, len(cnt[::64]))
    offs = np.zeros(nf + 1, np.int64)
    np.cumsum(cnt, out=offs[1:])
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    loc = [torch.randint(0, m, (int(offs[-1]),), generator=g, device=dev,
                         dtype=torch.int32) for m in (ntgt, nwin)]
    return torch.from_numpy(offs).to(dev), *loc


def phase_parity_csr(results, rng, dev):
    """csr_decode against its plain version at the main paths' 131,072
    probes (8192 reads x 16 features), c 254, rl 256 (alternating runs,
    f 16) and rl 254 (f 1), on a 16 M-feature CSR (221 M locations, past
    the L2 cache): the 944 Mbp summary's packed form (pk15), the
    many-target form ((tgt, win), pack_bits 0), and the k = 18 form,
    whose rows come from the search of sign-flipped u64 features
    (ops/rows.py::_csr_rows). Bound: the rl output lanes a probe, 8
    bytes a slot the counts keep, and each probe's row id, found flag
    and offsets pair once."""
    from types import SimpleNamespace
    from metacache_tpu_torch.ops import probe_decode as D
    from metacache_tpu_torch.ops.rows import INT64_MIN, _csr_rows
    n, f, c, rl = 131072, 16, 254, 256
    nf = CSR_FEATURES
    offs, ltgt, lwin = csr_table(rng, dev, nf, 944, 1 << 14)
    idx = torch.from_numpy(rng.integers(0, nf, n).astype(np.int32)).to(dev)
    found = torch.from_numpy(rng.random(n) < 0.9).to(dev)
    # a u64 table: sorted distinct sign-flipped features, probed by the
    # features of 90% of its rows and 10% random ones
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    keys = torch.unique(torch.randint(-2**63, 2**63 - 1, (nf,), generator=g,
                                      device=dev, dtype=torch.int64))
    t64 = SimpleNamespace(num_features=keys.numel(), bucket_rows=None,
                          features=keys)
    q = keys[torch.randint(0, keys.numel(), (n,), generator=g, device=dev)]
    q = torch.where(torch.rand(n, generator=g, device=dev) < 0.9, q,
                    torch.randint(-2**63, 2**63 - 1, (n,), generator=g,
                                  device=dev, dtype=torch.int64)) ^ INT64_MIN
    idx64, found64 = _csr_rows(q, t64)
    offs64 = offs[:keys.numel() + 1]
    cases = {"944mbp_pk15": (idx, found, offs, 15, rl, f),
             "many_target_tgt_win": (idx, found, offs, 0, rl, f),
             "k18_u64_search_pk15": (idx64, found64, offs64, 15, rl, f),
             "pk15_rl254_f1": (idx, found, offs, 15, c, 1)}
    out = {}
    for name, (ii, fd, oo, pb, r_, ff) in cases.items():
        def call():
            return D.csr_decode(ii, fd, oo, ltgt, lwin, c, r_, ff, pb)

        def plain():
            return D.csr_decode_plain(ii, fd, oo, ltgt, lwin, c, r_, ff, pb)
        err = max(check_equal(f"csr_decode {name}", a, b)
                  for a, b in zip(call(), plain()))
        i = torch.clamp(ii.to(torch.int64), 0, oo.numel() - 2)
        kept = int(torch.where(fd, torch.clamp(oo[i + 1] - oo[i], max=c),
                               0).sum())
        nbytes = n * r_ * 4 * (1 if pb else 2) + kept * 8 + n * 5 + \
            int(fd.sum()) * 16
        b_ms, by = bound(nbytes, n * r_)
        out[name] = dict(max_abs_err=err, ms=cuda_ms(call),
                         kernel_ms=kernel_ms(call), host_us=host_us(call),
                         plain_ms=cuda_ms(plain), bound_ms=b_ms,
                         bound_by=by, slots_read=kept)
        if name == "944mbp_pk15":
            _record(results, "csr_decode", err=err, ms=out[name]["ms"],
                    plain_ms=out[name]["plain_ms"],
                    device_ms=out[name]["kernel_ms"],
                    host_us=out[name]["host_us"], nbytes=nbytes, nops=n * r_,
                    shape="131072 probes, f=16, c=254, rl=256, pk15, "
                          "16 M-feature CSR")
        say(f"parity-csr_decode-{name}", probes=n, c=c, rl=r_, f=ff,
            pack_bits=pb, tolerance=0, **out[name])
    search_ms = kernel_ms(lambda: _csr_rows(q, t64))
    say("parity-csr_decode", tolerance=0,
        max_abs_err=max(o["max_abs_err"] for o in out.values()),
        features=nf, locations=ltgt.numel(), u64_features=keys.numel(),
        u64_search_ms=search_ms, cases={k: v["max_abs_err"]
                                        for k, v in out.items()})


def dense_rows(g, dev, nf: int, width: int, meta: int,
               deep_every: int = 64):
    """(nf, width) int32 rows on the card (made there from generator
    ``g``): random slot lanes below 2^30 (packed pk15 slots, or targets
    and windows), ``meta`` feature lanes of random values (a row's lo and
    hi for u64 features), then the count lane: 1-16 locations, every
    ``deep_every``-th row 200-399 (past the 254 cap), as the 944 Mbp
    database's buckets."""
    rows = torch.randint(0, 1 << 30, (nf, width), generator=g, device=dev,
                         dtype=torch.int32)
    rows[:, :meta] = torch.randint(-2**31, 2**31 - 1, (nf, meta),
                                   generator=g, device=dev,
                                   dtype=torch.int32)
    cnt = torch.randint(1, 17, (nf,), generator=g, device=dev,
                        dtype=torch.int32)
    cnt[::deep_every] = torch.randint(200, 400, (cnt[::deep_every].numel(),),
                                      generator=g, device=dev,
                                      dtype=torch.int32)
    rows[:, meta] = cnt
    return rows


def dense_probes(g, dev, rows, n: int, wide: bool):
    """n probes of ``rows``: row ids (1% past the table) and their
    features, 10% of them misses and 1% the sentinel; int64 features
    from the two meta lanes where ``wide``."""
    nf = rows.shape[0]
    idx = torch.randint(0, nf, (n,), generator=g, device=dev,
                        dtype=torch.int32)
    r = rows[idx.to(torch.int64)]
    flat = ((r[:, 1].to(torch.int64) << 32) |
            (r[:, 0].to(torch.int64) & 0xFFFFFFFF)) if wide else r[:, 0]
    miss = torch.rand(n, generator=g, device=dev) < 0.1
    flat = torch.where(miss, flat ^ 0x5A5A, flat)
    flat[::97] = -1
    idx[::101] = nf + 5
    return idx, flat


def phase_parity_dense(results, rng, dev):
    """dense_decode against its plain version at the main paths' 131,072
    probes (8192 reads x 16 features), c 254, rl 256 (f 16): the 944 Mbp
    summary's dense pk15 rows (1 M rows of 256 lanes, 1 GiB, past the L2
    cache; also at rl 254, f 1), the many-target summary's dense (tgt,
    win) lanes (512 K rows of 510 lanes, pack_bits 0), and at 16,384
    probes the many-target two-tier lanes (head 30, as MC_DENSE_LIMIT=1
    stages them), the k = 18 u64 dense pk15 rows and the u64 two-tier
    rows (head 60). Bound: the rl output lanes a probe, each probe's row
    id, feature and meta lanes once, and the slots its count keeps."""
    from metacache_tpu_torch.ops import probe_decode as D
    g = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    n, f, c, rl = 131072, 16, 254, 256
    main = dense_rows(g, dev, 1 << 20, 2 + c, 1)
    lanes = dense_rows(g, dev, 1 << 19, 2 + 2 * c, 1)
    lt_head = dense_rows(g, dev, 1 << 16, 64, 1, deep_every=4)
    lt_ovf = torch.randint(0, 1 << 30, (1 << 14, 2 * (c - 30)), generator=g,
                           device=dev, dtype=torch.int32)
    lt_head[:, 2] = torch.randint(0, 1 << 14, (1 << 16,), generator=g,
                                  device=dev, dtype=torch.int32)
    u64 = dense_rows(g, dev, 1 << 16, 3 + c, 2)
    u64_head = dense_rows(g, dev, 1 << 16, 64, 2, deep_every=4)
    u64_ovf = torch.randint(0, 1 << 30, (1 << 14, c - 60), generator=g,
                            device=dev, dtype=torch.int32)
    u64_head[:, 3] = torch.randint(0, 1 << 14, (1 << 16,), generator=g,
                                   device=dev, dtype=torch.int32)
    small = 16384
    # name -> (rows, ovf, hsl, slot_bits, pack_bits, probes, rl, f, u64)
    cases = {"944mbp_pk15": (main, None, 0, 15, 15, n, rl, f, False),
             "pk15_rl254_f1": (main, None, 0, 15, 15, n, c, 1, False),
             "many_target_tgt_win": (lanes, None, 0, 0, 0, n, rl, f, False),
             "two_tier_tgt_win_h30": (lt_head, lt_ovf, 30, 0, 0, small, rl,
                                      f, False),
             "k18_u64_pk15": (u64, None, 0, 15, 15, small, rl, f, True),
             "k18_u64_two_tier_h60": (u64_head, u64_ovf, 60, 15, 15, small,
                                      rl, f, True)}
    out = {}
    for name, (rows, ovf, hsl, sb, pb, nn, r_, ff, wide) in cases.items():
        idx, flat = dense_probes(g, dev, rows, nn, wide)

        def call():
            return D.dense_decode(rows, ovf, idx, flat, hsl, c, r_, ff, sb,
                                  pb)

        def plain():
            return D.dense_decode_plain(rows, ovf, idx, flat, hsl, c, r_,
                                        ff, sb, pb)
        err = max(check_equal(f"dense_decode {name}", a, b)
                  for a, b in zip(call(), plain()))
        # what the data needs: each probe's id, feature and meta lanes
        # (the overflow id too), the slots its count keeps, the outputs
        nm = 2 if wide else 1
        row = rows[torch.clamp(idx.to(torch.int64), max=rows.shape[0] - 1)]
        kept = int(torch.where(D.meta_match(row, flat),
                               torch.clamp(row[:, nm], 0, c), 0).sum())
        nouts = 1 if pb else 2
        nbytes = nn * r_ * 4 * nouts + nn * (4 + 4 * nm) + \
            nn * 4 * (nm + (2 if ovf is not None else 1)) + \
            kept * 4 * (1 if sb else 2)
        b_ms, by = bound(nbytes, nn * r_ * nouts)
        out[name] = dict(max_abs_err=err, ms=cuda_ms(call),
                         kernel_ms=kernel_ms(call), host_us=host_us(call),
                         plain_ms=cuda_ms(plain), bound_ms=b_ms,
                         bound_by=by, slots_read=kept)
        if name == "944mbp_pk15":
            _record(results, "dense_decode", err=err, ms=out[name]["ms"],
                    plain_ms=out[name]["plain_ms"],
                    device_ms=out[name]["kernel_ms"],
                    host_us=out[name]["host_us"], nbytes=nbytes,
                    nops=nn * r_ * nouts,
                    shape="131072 probes, f=16, c=254, rl=256, pk15 dense "
                          "rows, 1 M-row table")
        say(f"parity-dense_decode-{name}", probes=nn, c=c, rl=r_, f=ff,
            hsl=hsl, slot_bits=sb, pack_bits=pb, tolerance=0, **out[name])
    del main, lanes, lt_head, lt_ovf, u64, u64_head, u64_ovf
    torch.cuda.empty_cache()
    say("parity-dense_decode", tolerance=0,
        max_abs_err=max(o["max_abs_err"] for o in out.values()),
        cases={k: v["max_abs_err"] for k, v in out.items()})


# the targets of each species in the smoke databases' taxonomies: 944 Mbp
# (64 unique + 12 x 52 + 1 x 256 genomes) and many-target (1 + 36 x 256)
GROUPS_944 = (1,) * 64 + (52,) * 12 + (256,)
GROUPS_MANY = (1,) + (256,) * 36
NUM_RANKS = 21


def tail_taxonomy(groups):
    """The lineages and taxon table of a smoke database's taxonomy
    (write_taxonomy: species under Bacteria, the domain, under root),
    target i's sequence-level taxon 2,000,000 + i. ``groups``: the
    targets of each species. -> (lineages (t, 21), species of each
    target, ascending taxon ids, their ranks), numpy int32."""
    sp = np.repeat(np.arange(len(groups)), groups)
    t = len(sp)
    lin = np.zeros((t, NUM_RANKS), np.int32)
    lin[:, 0] = 2_000_000 + np.arange(t)
    lin[:, 4] = 1000 + sp
    lin[:, 19] = 2
    lin[:, 20] = 1
    ids = np.concatenate([[1, 2], 1000 + np.arange(len(groups)),
                          lin[:, 0]]).astype(np.int32)
    ranks = np.concatenate([[20, 19], np.full(len(groups), 4),
                            np.zeros(t)]).astype(np.int32)
    return lin, sp, ids, ranks


def tail_candidates(rng, groups, sp, b: int, k: int):
    """A batch's top candidates as B4 gives them: b reads, up to k
    targets each (a read finds 0 with probability 0.1, else a geometric
    count of 1-k), the first a random target, each later one of its
    species with probability 0.8, hits descending from 3-16 (16
    features a read); absent candidates are target -1, hits 0.
    -> (tgt, hits) numpy int32."""
    starts = np.concatenate([[0], np.cumsum(groups)[:-1]])
    size = np.asarray(groups)
    t = len(sp)
    base = rng.integers(0, t, b)
    own = starts[sp[base]][:, None] + (rng.random((b, k)) *
                                       size[sp[base]][:, None]).astype(int)
    tgt = np.where(rng.random((b, k)) < 0.8, own, rng.integers(0, t, (b, k)))
    tgt[:, 0] = base
    hits = np.clip(rng.integers(3, 17, (b, 1)) - np.cumsum(
        rng.integers(0, 4, (b, k)), axis=1) + rng.integers(0, 4, (b, 1)),
        1, 16)
    n = np.where(rng.random(b) < 0.1, 0, np.minimum(rng.geometric(0.5, b), k))
    gone = np.arange(k)[None, :] >= n[:, None]
    return (np.where(gone, -1, tgt).astype(np.int32),
            np.where(gone, 0, hits).astype(np.int32))


def lca_rows_read(tax, hits, hits_min: int, frac: float) -> int:
    """The lineage rows classify_lca must read for these candidates: the
    included ones (the plain version's include mask)."""
    exists = tax != 0
    h0 = hits[:, 0]
    thr = torch.where(h0 > hits_min, (h0 - hits_min).float() * frac,
                      torch.zeros((), device=h0.device))
    inc = hits.float() > thr[:, None]
    inc[:, 0] = True
    return int(torch.cumprod((inc & exists).int(), dim=1).sum())


def phase_parity_tail(results, rng, dev):
    """The step's tail against its plain versions, tolerance 0:
    classify_lca at the 944 Mbp summary's batch (8192 reads, K = 2, the
    lookup form of the fused branch and the form with taxa given) and
    at the many-target merge's (K = 8, -lowest species: merge rank 4),
    on the databases' taxonomies; at the edges (K = 40, R = 1, 21 and
    32, contiguous tables and strided views, 1,000 reads); rank_hist on
    a stack of 32 batches (262,144 reads), with and without escalation
    phase 1's overflow bits, and at the edges (one read, a ragged view 3
    ints past the 16-byte grid, 2^20 taxa). Each line's floor_ms is an
    empty kernel launched as the kernel is, on its grid, in the same
    CUDA graph harness. No single PyTorch call computes either function
    (library_ms None). Bounds: classify_lca the candidates' ints, the
    included candidates' lineage rows and the classes; rank_hist the
    reads' taxa (and overflow words), the taxon table once and the
    bins."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.classify import runner as R
    from metacache_tpu_torch.ops import pipeline as P
    hits_min, frac, highest = 5, 1.0, 19     # the query's defaults
    out = {}
    for name, groups, k, merge_rank in (("944mbp", GROUPS_944, 2, 0),
                                        ("many-target", GROUPS_MANY, 8, 4)):
        lin, sp, _i, _r = tail_taxonomy(groups)
        merge_tax = lin[:, merge_rank].copy()
        tgt, hits = tail_candidates(rng, groups, sp, SCAN_BATCH, k)
        tgt_d, hits_d, lin_d, mt_d = (torch.from_numpy(a).to(dev)
                                      for a in (tgt, hits, lin, merge_tax))
        tax_d = P.classify_with_taxa_plain(tgt_d, hits_d, mt_d, lin_d,
                                           hits_min, frac, highest,
                                           merge_rank)[0]
        args = (hits_min, frac, highest, merge_rank)
        forms = {
            "lookup": (lambda: P.classify_with_taxa(
                tgt_d, hits_d, mt_d, lin_d, *args),
                lambda: P.classify_with_taxa_plain(
                tgt_d, hits_d, mt_d, lin_d, *args), 16),
            "taxa": (lambda: (P.classify_candidates(
                tgt_d, tax_d, hits_d, lin_d, *args),),
                lambda: (P.classify_candidates_plain(
                    tgt_d, tax_d, hits_d, lin_d, *args),), 12)}
        rows = lca_rows_read(tax_d, hits_d, hits_min, frac)
        floor = kernel_ms(lambda: kernels.launch_floor(0, SCAN_BATCH))
        for form, (call, plain, per_cand) in forms.items():
            err = max(check_equal(f"classify_lca {name} {form}", a, b_)
                      for a, b_ in zip(call(), plain()))
            nbytes = SCAN_BATCH * k * per_cand + rows * NUM_RANKS * 4 + \
                SCAN_BATCH * 4
            b_ms, by = bound(nbytes, rows * NUM_RANKS)
            tag = f"{name}_K{k}_{form}"
            out[tag] = dict(max_abs_err=err, ms=cuda_ms(call),
                            kernel_ms=kernel_ms(call), floor_ms=floor,
                            host_us=host_us(call),
                            plain_ms=cuda_ms(plain), bound_ms=b_ms,
                            bound_by=by, lineage_rows_read=rows,
                            classified=int((call()[-1] != 0).sum()))
            if name == "944mbp" and form == "lookup":
                _record(results, "classify_lca", err=err,
                        ms=out[tag]["ms"], plain_ms=out[tag]["plain_ms"],
                        device_ms=out[tag]["kernel_ms"],
                        host_us=out[tag]["host_us"], nbytes=nbytes,
                        nops=rows * NUM_RANKS,
                        shape="8192 reads x 2 candidates, lookup form, "
                              "944 targets x 21 ranks")
            say(f"parity-classify_lca-{name}", reads=SCAN_BATCH, k=k,
                form=form, merge_rank=merge_rank, tolerance=0,
                library_ms=None, **out[tag])
    # the edges: K = 40 (five turns), R = 1 and 32, a contiguous table
    # and a strided view
    floor = kernel_ms(lambda: kernels.launch_floor(0, 1000))
    for r in (1, 21, 32):
        lin = np.zeros((1024, r), np.int32)
        lin[:, r - 1] = 1
        if r > 4:
            lin[:, 4] = 1000 + np.arange(1024) // 16
        lin[:, 0] = 2_000_000 + np.arange(1024)
        tgt, hits = tail_candidates(rng, (16,) * 64, np.repeat(
            np.arange(64), 16), 1000, 40)
        tgt_d, hits_d, lin_c, mt_d = (torch.from_numpy(a).to(dev) for a in (
            tgt, hits, lin, lin[:, 0].copy()))
        merge_rank = min(4, r - 1)
        args = (hits_min, frac, min(highest, r - 1), merge_rank)
        wide = torch.zeros((1024, r + 3), dtype=torch.int32, device=dev)
        wide[:, :r] = lin_c
        for layout, lin_d in (("contiguous", lin_c),
                              ("strided", wide[:, :r])):
            def call():
                return P.classify_with_taxa(tgt_d, hits_d, mt_d, lin_d,
                                            *args)
            err = max(check_equal(f"classify_lca edge R={r} {layout}", a,
                                  b_) for a, b_ in zip(call(), (
                                      P.classify_with_taxa_plain(
                                          tgt_d, hits_d, mt_d, lin_c,
                                          *args))))
            say("parity-classify_lca-edge", reads=1000, k=40, ranks=r,
                table=layout, row_stride=lin_d.stride(0), max_abs_err=err,
                tolerance=0, kernel_ms=kernel_ms(call), floor_ms=floor)
    lin, sp, ids, ranks = tail_taxonomy(GROUPS_944)
    m = 32 * SCAN_BATCH
    pick = rng.random(m)
    cls = np.where(pick < 0.45, lin[rng.integers(0, len(sp), m), 0],
                   np.where(pick < 0.85, 1000 + rng.integers(
                       0, len(GROUPS_944), m), np.where(pick < 0.9, 1, 0)))
    over = rng.random(m) < 0.05
    words = (over.reshape(-1, 32).astype(np.int64) <<
             np.arange(32)).sum(axis=1).astype(np.uint32).view(np.int32)
    cls_d, ids_d, ranks_d, over_d = (torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32)).to(dev) for a in (cls, ids, ranks, words))
    n = m - 1000                 # the last stack of a query: padded reads
    hist = {}
    floor = kernel_ms(lambda: kernels.launch_floor(1, m))
    for masked in (False, True):
        ob = over_d if masked else None

        def call():
            return R.rank_histogram(cls_d, n, ids_d, ranks_d, over_bits=ob)

        def plain():
            return R.rank_histogram_plain(cls_d, n, ids_d, ranks_d,
                                          over_bits=ob)
        tag = "masked" if masked else "plain_stack"
        err = check_equal(f"rank_hist {tag}", call(), plain())
        nbytes = m * 4 + (words.nbytes if masked else 0) + \
            len(ids) * 8 + (NUM_RANKS + 1) * 8
        nops = m * max(1, len(ids).bit_length())
        b_ms, by = bound(nbytes, nops)
        hist[tag] = dict(max_abs_err=err, ms=cuda_ms(call),
                         kernel_ms=kernel_ms(call), floor_ms=floor,
                         host_us=host_us(call), plain_ms=cuda_ms(plain),
                         bound_ms=b_ms, bound_by=by,
                         counted=int(call().sum()))
        if not masked:
            _record(results, "rank_hist", err=err, ms=hist[tag]["ms"],
                    plain_ms=hist[tag]["plain_ms"],
                    device_ms=hist[tag]["kernel_ms"],
                    host_us=hist[tag]["host_us"], nbytes=nbytes, nops=nops,
                    shape="a stack of 262,144 reads, 944 Mbp taxonomy "
                          f"({len(ids)} taxa)")
        say("parity-rank_hist-stack", reads=m, n=n, masked=masked,
            taxa=len(ids), tolerance=0, library_ms=None, **hist[tag])
    # the edges: one read, a ragged view past the 16-byte grid, 2^20 taxa
    big_ids = np.cumsum(rng.integers(1, 64, 1 << 20)).astype(np.int32)
    big_ranks = rng.integers(0, NUM_RANKS + 1, 1 << 20).astype(np.int32)
    big_cls = np.where(rng.random(m) < 0.7, big_ids[rng.integers(
        0, 1 << 20, m)], rng.integers(0, 1 << 26, m)).astype(np.int32)
    bi_d, br_d, bc_d = (torch.from_numpy(a).to(dev) for a in (
        big_ids, big_ranks, big_cls))
    for edge, c_d, i_d, r_d, nn in (
            ("one", cls_d[:1], ids_d, ranks_d, 1),
            ("ragged_offset3", cls_d[3:m - 2], ids_d, ranks_d, n),
            ("taxa_2^20", bc_d, bi_d, br_d, n)):
        for masked in (False, True):
            ob = over_d if masked else None

            def call():
                return R.rank_histogram(c_d, nn, i_d, r_d, over_bits=ob)
            err = check_equal(f"rank_hist edge {edge}", call(),
                              R.rank_histogram_plain(c_d, nn, i_d, r_d,
                                                     over_bits=ob))
            say("parity-rank_hist-edge", edge=edge, reads=c_d.numel(),
                taxa=i_d.numel(), masked=masked, max_abs_err=err,
                tolerance=0, kernel_ms=kernel_ms(call),
                floor_ms=kernel_ms(lambda: kernels.launch_floor(
                    1, c_d.numel())))
    del cls_d, over_d, bc_d, bi_d, br_d


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


def b9_timed(tag, brows, flat, bits, **kv):
    """[parity-B9-<tag>]: B9 on one index against its plain version
    (tolerance 0), timed: device ms (CUDA graph), wrapper ms, plain ms,
    host us a call, and the bound of its bytes (the feature, its L-lane
    row, idx and found a probe) and operations (a compare, a select and
    an add a lane)."""
    from metacache_tpu_torch.ops import probe_decode as D
    n = flat.shape[0]
    lanes = 64 if brows.shape[1] == 128 else brows.shape[1]
    got = D.bucket_decode(brows, flat, bits)
    want = D.bucket_decode_plain(brows, flat, bits)
    err = max(check_equal(f"B9 {tag} idx", got[0], want[0]),
              check_equal(f"B9 {tag} found", got[1], want[1]))

    def call():
        return D.bucket_decode(brows, flat, bits)
    ms, dms = cuda_ms(call), kernel_ms(call)
    pms = cuda_ms(lambda: D.bucket_decode_plain(brows, flat, bits))
    hus = host_us(call)
    b_ms, by = bound(n * (flat.element_size() + 4 * lanes + 4 + 1),
                     n * lanes * 3)
    say(f"parity-B9-{tag}", lanes=lanes, bucket_bits=bits, probes=n,
        tolerance=0, max_abs_err=err, ms=ms, kernel_device_ms=dms,
        host_us_per_call=hus, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        found_share=round(float(got[1].float().mean()), 4), **kv)


def parity_b9_host(rng, feats, flat, dev):
    """B9 on the host's bucket-row indexes of the probe table's sorted
    features (ops/probe.py::make_bucket_index): 64 lanes at its default
    bits and 65 lanes (one 4-byte load a lane twice: the width of the
    944 Mbp database's MC_DEVICE_LAYOUT=0 index) at the fewest bits whose
    deepest bucket holds at most 64 features;
    and the u64 index (make_bucket_index64) of as many random 64-bit
    features, probed by int64 bit patterns; the same 131,072 probes."""
    from metacache_tpu_torch.ops.probe import (make_bucket_index,
                                               make_bucket_index64)
    n = flat.shape[0]
    rows, bits = make_bucket_index(feats)
    b9_timed("host64", torch.from_numpy(rows).to(dev), flat, bits)
    b65 = next(b for b in range(12, 24) if int(np.bincount(
        feats >> np.uint32(32 - b)).max()) <= 64)
    rows, bits = make_bucket_index(feats, b65)
    b9_timed(f"host{rows.shape[1]}", torch.from_numpy(rows).to(dev), flat,
             bits)
    del rows
    f64 = np.unique(rng.integers(0, 2**64 - 1, len(feats), dtype=np.uint64))
    index = make_bucket_index64(f64)
    if index is None:
        raise AssertionError("the u64 probe table has a low-32 collision")
    rows, bits = index
    q = f64[rng.integers(0, len(f64), n)]
    u = rng.random(n)
    q[u < 0.3] = rng.integers(0, 2**64 - 1, int((u < 0.3).sum()),
                              dtype=np.uint64)
    q[::100] = np.uint64(2**64 - 1)
    b9_timed("u64", torch.from_numpy(rows).to(dev),
             torch.from_numpy(q.view(np.int64)).to(dev), bits,
             features=len(f64))


def phase_parity_probe(results, rng, dev):
    """B9 and B8 at the main path's 131,072 probes (8192 reads x 16
    features) on a 2 M-feature table built on the card by the device
    builder (pair-packed bucket rows and head rows, 512 MB of head rows),
    with 29% misses and 1% sentinels, against their plain versions (B8
    on index and feature views off the 16-byte grid too, and beside its
    launch floor); then the builder on the card against the builder on
    CPU tensors, on the first 300,000 features of the stream: the
    two-tier rows and the size-classed cells staged from their CSR,
    arrays equal."""
    from metacache_tpu_torch import kernels
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
    shape = (f"131072 probes, {dt.bbits} bucket bits, 2 M-feature table, "
             "pair-packed")
    b_ms, by = _record(results, "bucket_decode", err=max(errs), ms=ms,
                       plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (4 + 256 + 4 + 1),
                       nops=n * 64 * 3, shape=shape)
    say("parity-B9", index="pair-packed", lanes=64, probes=n, tolerance=0,
        max_abs_err=max(errs), ms=ms, kernel_device_ms=dms,
        host_us_per_call=hus, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        found_share=round(float(found.float().mean()), 4),
        table_build_seconds=round(build_s, 3), features=dt.nf,
        locations=dt.num_locations, bucket_bits=dt.bbits,
        head_rows=tuple(dt.head.shape))
    parity_b9_host(rng, dt.uniq.cpu().numpy().view(np.uint32),
                   flat, dev)
    head = dt.head.view(-1, 64)
    ovf = dt.ovf
    idx = torch.clamp(idx, 0, dt.nf - 1)
    oidx = D.oidx_decode(head, idx, flat)
    errs = {"rows": check_equal("B8", oidx,
                                D.oidx_decode_plain(head, idx, flat))}
    # n - 3 probes from index and feature views 4 bytes past the grid
    vi, vf = idx[1:n - 2], flat[1:n - 2]
    errs["views_n-3"] = check_equal("B8 views", D.oidx_decode(head, vi, vf),
                                    D.oidx_decode_plain(head, vi, vf))
    errs["B7_with_B8"] = check_equal(
        "B7 with B8's oidx", D.full_decode(head, ovf, idx, flat, 61, dt.spf,
                                           128, 16, oidx),
        D.full_decode_plain(head, ovf, idx, flat, 61, dt.spf, 128, 16))
    ms = cuda_ms(lambda: D.oidx_decode(head, idx, flat))
    dms = kernel_ms(lambda: D.oidx_decode(head, idx, flat))
    floor = kernel_ms(lambda: kernels.launch_floor(2, n))
    pms = cuda_ms(lambda: D.oidx_decode_plain(head, idx, flat))
    # per probe: its row index and feature, head lanes 0 and 2, oidx
    hus = host_us(lambda: D.oidx_decode(head, idx, flat))
    b_ms, by = _record(results, "oidx_decode", err=max(errs.values()),
                       ms=ms, plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (4 + 4 + 8 + 4),
                       nops=n * 4, shape="131072 probes, pair-packed head "
                                         "rows, 2 M-feature table")
    say("parity-B8", probes=n, tolerance=0, max_abs_err=max(errs.values()),
        cases=errs, ms=ms, kernel_device_ms=dms, floor_ms=floor,
        host_us_per_call=hus, plain_ms=pms, bound_ms=b_ms, bound_by=by,
        bound_share=round(b_ms / dms, 4),
        deep_share=round(float((oidx > 0).float().mean()), 4))
    del dt, head, ovf, flat, idx, oidx, found, vi, vf
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


def phase_build(tmp, name, genomes, species, gen_s, keep_fasta=False):
    """`build` through the CLI (the device builder); ``keep_fasta``: the
    genomes are written one FASTA file a genome, which stay (-align
    re-reads a target's file, and the host builds of ``Background``
    read them). -> (database path, max window)."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.cli.main import main as cli
    t0 = time.time()
    sub = os.path.join(tmp, name)
    os.makedirs(sub)
    fa, tax = write_reference(sub, genomes, species, per_genome=keep_fasta)
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
    if not keep_fasta:
        os.remove(fa)
    maxwin = int((p.locations & np.uint64(0xFFFFFFFF)).max())
    say(f"build-{name}", genomes=len(genomes),
        bases=sum(len(g) for g in genomes), features=p.num_features,
        locations=p.num_locations, max_bucket=p.max_bucket_size,
        max_window=maxwin, seconds=round(build_s, 3),
        data_gen_seconds=round(gen_s, 3), sketch_launches=launches)
    return db, maxwin


def host_build_check(fa, tax, db) -> dict:
    """A host build of the genomes in ``fa`` must give the device-built
    database ``db`` its features, offsets and locations."""
    from metacache_tpu_torch.db.build import BuildOptions, build_database
    hp = build_database(BuildOptions(infiles=[fa], taxonomy_dir=tax))
    if hp.device_parts or len(hp.parts) != 1:
        raise AssertionError("the host build did not build on the host")
    p = Database.load(db).parts[0]
    for k in ("unique_features", "offsets", "locations"):
        if not np.array_equal(getattr(hp.parts[0], k), getattr(p, k)):
            raise AssertionError(f"device build != host build: {k}")
    return dict(host_build_equal=True)


def run_jobs(path) -> int:
    """The second process of ``Background``: the jobs of the JSON list
    in ``path`` in turn, each a CLI command (``args``) or a host build
    held against a device build (``host_check``), each printing one
    ``JOB {...}`` line: its seconds and the kernels it launched."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.cli.main import main as cli
    with open(path) as f:
        jobs = json.load(f)
    for job in jobs:
        kernels.reset_counts()
        t0 = time.time()
        if "host_check" in job:
            out = host_build_check(*job["host_check"])
        elif cli(job["args"]) != 0:
            raise AssertionError(f"{' '.join(job['args'])} failed")
        else:
            out = {}
        out.update(seconds=round(time.time() - t0, 3),
                   launches={k: v for k, v in launch_counts().items() if v})
        print("JOB " + json.dumps(out), flush=True)
    return 0


BACKGROUND: list = []      # the processes Background started


class Background:
    """Jobs of ``run_jobs`` in a second process of this script, started
    now; ``wait()`` waits for it and returns the jobs' results in order.
    Its kernel launches are its own: the counts of this process, which
    the phases check, do not see them."""

    def __init__(self, tmp, name, jobs):
        self.name = name
        path = os.path.join(tmp, f"jobs-{name}.json")
        with open(path, "w") as f:
            json.dump(jobs, f)
        self.out = os.path.join(tmp, f"jobs-{name}.out")
        self.t0 = time.time()
        with open(self.out, "w") as f:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--jobs", path],
                stdout=f)
        BACKGROUND.append(self.proc)

    def wait(self) -> list:
        t0 = time.time()
        rc = self.proc.wait()
        with open(self.out) as f:
            done = [json.loads(l[4:]) for l in f if l.startswith("JOB ")]
        if rc != 0:
            raise AssertionError(f"background jobs {self.name} exited "
                                 f"with {rc} after {len(done)} jobs")
        say(f"background-{self.name}", jobs=len(done),
            seconds=round(time.time() - self.t0, 3),
            waited_seconds=round(time.time() - t0, 3))
        return done


def stop_background():
    for proc in BACKGROUND:
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def _query(db_path, reads_path, args, out, runner=None, devices=None):
    """A query through the runner; ``db_path``: a path or a loaded
    Database; ``reads_path``: a path or a list (two files a pair under
    -pairfiles). ``runner``: staged tables to reuse under other flags,
    of those that change no staged state (pairing, output, insert size).
    ``devices``: the new runner's devices (-replicate, -table-shards).
    -> (runner, results, staging seconds)."""
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import (QueryRunner,
                                                     map_queries_to_targets)
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    opt, _, _ = parse_query_options(Args(list(args)))
    stage_s = 0.0
    if runner is None:
        db = Database.load(db_path) if isinstance(db_path, str) else db_path
        t0 = time.time()
        runner = QueryRunner(db, opt, devices=devices)
        torch.cuda.synchronize()
        stage_s = time.time() - t0
    else:
        runner.opt, runner._line_writer = opt, None
    res = ClassificationResults(out, out, out)
    paths = [reads_path] if isinstance(reads_path, str) else list(reads_path)
    map_queries_to_targets(paths, runner.db, opt, res, runner)
    torch.cuda.synchronize()
    return runner, res, stage_s


def phase_query_summary(tmp, name, db, reads, layout, expect, pairs=None,
                        runner=None):
    """A main path: counts are zeroed just before it and read just
    after, so its launches are its own. ``expect(runner, batches)`` gives
    the launches each kernel must show. ``reads``: the reads to write,
    or the count of those an earlier phase wrote; with ``pairs``, the
    two files of that many read pairs, queried with -pairfiles;
    ``runner``: staged tables to query (else a runner stages them).
    -> (runner, launches, results)"""
    from metacache_tpu_torch import kernels
    path = os.path.join(tmp, name, "reads.fa")
    if isinstance(reads, int):
        nreads = reads
    else:
        nreads = len(reads)
        write_reads(path, reads)
    args = ["-no-map"] + (["-pairfiles"] if pairs else [])
    kernels.reset_counts()
    runner, res, stage_s = _query(db, pairs or path, args, io.StringIO(),
                                  runner)
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
    unit = "pairs" if pairs else "reads"
    say(f"query-{'pair' if pairs else 'summary'}-{name}",
        **{unit: n, f"{unit}_per_min": round(rpm)},
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


def stacks(runner, batches: int, scan_k: int | None = None) -> int:
    """rank_hist's launches in a summary of ``batches`` batches on the
    scan: one a stack of min(MC_SCAN_K, batches) batches (the last stack
    may be shorter or padded), none where the runner counts its
    histogram on the host (no taxon table on the card)."""
    if runner._hist_dev is None:
        return 0
    k = int(scan_k or os.environ.get("MC_SCAN_K", "32"))
    return -(-batches // max(1, min(k, batches)))


def probes_through_b9(runner) -> bool:
    """Whether the runner's tables find their rows through B9: every row
    layout but the classed cells (classed_bucket), and a u32 CSR part (a
    u64 one is searched)."""
    t = runner.tables
    return t.bucket_rows is not None and not t.classed


def path_of(*names):
    """Launch expectation of a dense path: each named kernel, the bucket
    probe (B9, where ``probes_through_b9``) and classify_lca (the step's
    tail) once per 8192-read batch, rank_hist once a stack, every other
    kernel never."""
    from metacache_tpu_torch import kernels

    def want(runner, batches):
        w = {k: batches if k in names else 0 for k in kernels.ALL}
        w.update(classify_lca=batches, rank_hist=stacks(runner, batches),
                 bucket_decode=batches if probes_through_b9(runner) else 0)
        return w
    return want


# the kernels of B4's and B5's wide form (csrc/candidates_wide.cu): the
# cluster route's one kernel and the multi-pass route's
WIDE_KERNELS = ("wide_cluster_kernel", "tile_sort_kernel",
                "merge_pass_kernel", "run_count_kernel", "tile_scan_kernel",
                "compact_kernel", "sweep_kernel", "pick_kernel",
                "copy_keys_kernel")


def phase_profile(tmp, name, runner, tag="", reads="reads.fa",
                  share=None):
    """Trace a second, warm query of the same reads (the summary query's
    unless ``reads`` names another file, or the two files of pairs):
    device time by kernel and the device's busy share of the query's
    wall time; with ``share`` (kernel names) also those kernels' device
    seconds and their share of the device time."""
    from torch.profiler import ProfilerActivity, profile
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import map_queries_to_targets
    res = ClassificationResults(io.StringIO(), io.StringIO(), io.StringIO())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        map_queries_to_targets(
            [os.path.join(tmp, name, r) for r in
             ([reads] if isinstance(reads, str) else reads)],
            runner.db, runner.opt, res, runner)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    # torch's concatenate and flip kernels: the probe's slot-run
    # reshaping before dense_decode wrote the runs itself
    reshape = {op: sum(e.count for e in evs if key in e.key)
               for op, key in (("cat", "CatArrayBatchedCopy"),
                               ("flip", "flip"))}
    # the host-to-device copies by source: pageable memory makes the copy
    # wait for its stream; the runner's infeed copies from pinned buffers
    h2d = {kind: sum(e.count for e in evs
                     if e.key == f"Memcpy HtoD ({kind} -> Device)")
           for kind in ("Pageable", "Pinned")}
    # the step's tail: its two kernels, where torch ran dozens a batch
    tail = {op: [e for e in evs if key in e.key]
            for op, key in (("lca", "lca_kernel"),
                            ("hist", "rank_hist_kernel"))}
    # the bucket probe's kernels, and torch's row gathers and reductions
    # (the bucket probe's before B9 took every route); classed_decode is
    # two kernels, its head form and its full form
    tail.update({op: [e for e in evs if any(k in e.key for k in keys)]
                 for op, keys in (("b9", ("bucket_decode_kernel",)),
                                  ("classed_bucket",
                                   ("classed_bucket_kernel",)),
                                  ("classed_decode",
                                   ("classed_head_kernel",
                                    "classed_decode_kernel")))})
    gathers = sum(e.count for e in evs if "index_elementwise" in e.key or
                  "gather" in e.key)
    part = dict(h2d_pageable_events=h2d["Pageable"],
                h2d_pinned_events=h2d["Pinned"],
                cat_kernels=reshape["cat"], flip_kernels=reshape["flip"],
                index_kernels=gathers, reduce_kernels=sum(
                    e.count for e in evs if "reduce_kernel" in e.key),
                kernel_events=sum(e.count for e in evs),
                **{f"{op}_kernels": sum(e.count for e in x)
                   for op, x in tail.items()},
                **{f"{op}_device_ms": round(sum(
                    e.self_device_time_total for e in x) / 1e3, 4)
                   for op, x in tail.items()})
    if share:
        mine = [e for e in evs if any(k in e.key for k in share)]
        us = sum(e.self_device_time_total for e in mine)
        part = dict(share_kernels_device_seconds=round(us / 1e6, 4),
                    share_kernels_launches=sum(e.count for e in mine),
                    share_of_device_time=round(us / max(busy_us, 1), 4))
    say(f"profile-{name}{tag}", wall_seconds=round(wall, 3),
        device_busy_seconds=round(busy_us / 1e6, 3),
        device_idle_share=round(1 - busy_us / 1e6 / wall, 3), **part)
    evs.sort(key=lambda e: -e.self_device_time_total)
    for e in evs[:20]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:7d} x  {e.key[:90]}")
    return dict(wall_seconds=wall, device_busy_seconds=busy_us / 1e6,
                h2d_pageable_events=h2d["Pageable"])


def phase_query_per_read(tmp, name, db, reads, tag="", runner=None):
    """The per-read query of ``reads`` (on ``runner``'s staged tables
    where one is given) -> its mapping lines."""
    path = os.path.join(tmp, name, "reads_per_read.fa")
    write_reads(path, reads)
    out_path = os.path.join(tmp, name, "mapping.txt")
    with open(out_path, "w") as out:
        runner, res, _ = _query(db, path, [], out, runner)
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
    mwir = 2 + length // stride, the runner's sweep. -> that CPU copy of
    the tables."""
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
    kw = dict(k=runner.sketching.kmerlen, sketchlen=16, windows_per_query=1,
              max_candidates=2, fast_top2=True, pack_bits=runner._pack_bits,
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
    return cpu


def summary_again(tmp, name, runner, env, reads="reads.fa"):
    """The summary query of an earlier phase's reads once more on the same
    staged tables under ``env``, a main path of its own (counts zeroed
    just before it, read just after). -> (results, launches, runner's
    redo dispatches of this query)."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import map_queries_to_targets
    res = ClassificationResults(io.StringIO(), io.StringIO(), io.StringIO())
    done = len(runner.redo_dispatches)
    with environ(**env):
        kernels.reset_counts()
        map_queries_to_targets([os.path.join(tmp, name, reads)], runner.db,
                               runner.opt, res, runner)
        torch.cuda.synchronize()
        grew = {k: v.launches for k, v in kernels.ALL.items()}
    return res, grew, runner.redo_dispatches[done:]


def phase_prefetch(tmp, name, runner, res, profile):
    """[prefetch-<name>]: the summary query on the same staged tables with
    the pipelined scan (the default: each batch's sketch and bucket probe
    on a side stream one batch ahead) and without it (MC_PREFETCH=0),
    warm, in turns (off, on, on, off): the same rank histogram, the same
    launches (B1 and B4 a batch), each run's wall and reads/min; with
    ``profile`` a trace of each (device busy, idle share, host-to-device
    copies from pageable and pinned memory)."""
    nreads = res.statistics.total()
    want = path_of("sketch", DENSE, *cand_kernels())(runner,
                                              -(-nreads // SCAN_BATCH))
    runs = {"on": [], "off": []}
    for tag in ("off", "on", "on", "off"):
        env = {"MC_PREFETCH": "0"} if tag == "off" else {}
        r, grew, _d = summary_again(tmp, name, runner, env)
        if grew != want:
            raise AssertionError(f"prefetch {tag}: launches {grew}, "
                                 f"expected {want}")
        if not np.array_equal(r.statistics.assigned_,
                              res.statistics.assigned_):
            raise AssertionError(f"prefetch {tag} changed the histogram")
        runs[tag].append(r.time_ms / 1000)
    traces = {}
    if profile:
        for tag, env in (("on", {}), ("off", {"MC_PREFETCH": "0"})):
            with environ(**env):
                traces[tag] = phase_profile(tmp, name, runner,
                                            f"-prefetch-{tag}")
    say(f"prefetch-{name}", reads=nreads, histogram_equal=True,
        launches_equal=True,
        **{f"prefetch_{t}_seconds": [round(x, 3) for x in v]
           for t, v in runs.items()},
        **{f"prefetch_{t}_reads_per_min": round(nreads / (min(v) / 60))
           for t, v in runs.items()},
        **{f"prefetch_{t}_{k}": round(x, 4) for t, tr in traces.items()
           for k, x in tr.items()})


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
        want = path_of("sketch", DENSE, *cand_kernels())(
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
               other_route=False, keep=None, prefetch=False):
    """Summary query (the main path), its profile, with ``other_route``
    the same query under the other MC_SPLIT_CAND route, the scan step
    against the plain path, and the per-read path; -> the summary's
    launches, rank histogram, staging seconds and the other route's
    launches (None without it). ``keep``: a dict that takes the per-read
    lines ("lines") and a profile of the summary query of the first
    GRID_PROFILE_READS reads ("profile"), for the grid phases, and the
    runner ("runner") and the scan step's CPU copy of its tables ("cpu"),
    for the pairs.
    ``prefetch``: the summary with and without the pipelined scan
    (``phase_prefetch``)."""
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20)
    del genomes
    runner, launches, res = phase_query_summary(
        tmp, name, db, reads, layout, path_of(*path_kernels))
    stage_s = runner.stage_s
    if profile:
        phase_profile(tmp, name, runner)
    if prefetch:
        phase_prefetch(tmp, name, runner, res, profile)
    other = phase_other_route(tmp, name, runner, res) if other_route \
        else None
    cpu = phase_e2e(name, runner, reads)
    if keep is not None:
        keep["cpu"] = cpu
        write_reads(os.path.join(tmp, name, "reads_grid_profile.fa"),
                    reads[:GRID_PROFILE_READS])
        keep["profile"] = phase_profile(tmp, name, runner, "-grid-reads",
                                        reads="reads_grid_profile.fa")
    del cpu
    # the summary's staged tables serve the per-read query
    lines = phase_query_per_read(tmp, name, db, reads[:65536],
                                 runner=runner)
    if keep is not None:
        keep.update(lines=lines, runner=runner)
    del runner
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


def phase_e2e_two_tier(name, runner, reads, cpu, copy_s,
                       dev=torch.device("cuda")):
    """The escalation steps on one 8192-read stack against the plain path
    on ``cpu``, CPU tensors of the same tables (the host holds the second
    copy, made in ``copy_s`` seconds): phase 1 (B1, B6, B4) and the redo
    of its flagged reads (B7, B4); their merge also equals the full-depth
    scan (B7) on the card. Times one phase-1 batch and one full redo
    batch."""
    from metacache_tpu_torch.ops import rows as R
    b = SCAN_BATCH
    stack = packed_stack(reads, b)
    t = runner.tables
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
    # B8 folded into B7: on the flagged reads' own probes, B7 alone (the
    # overflow row read from the head row) against B8 then B7
    from metacache_tpu_torch.ops import probe_decode as D
    c, hsl = t.spf, t.head_slots
    rl = 1 << (c - 1).bit_length()
    pf, pi = fk.reshape(-1).to(dev), ik.reshape(-1).to(dev)
    alone = D.full_decode(t.fused_rows, t.ovf_rows, pi, pf, hsl, c, rl, 16)
    chained = D.full_decode(t.fused_rows, t.ovf_rows, pi, pf, hsl, c, rl,
                            16, D.oidx_decode(t.fused_rows, pi, pf))
    fold_err = check_equal("B7 alone vs B8 then B7", alone, chained)
    fold = dict(b8_fold_probes=pf.numel(), b8_fold_max_abs_err=fold_err,
                b8_fold_deep_probes=int((D.oidx_decode_plain(
                    t.fused_rows, pi, pf) > 0).sum()))
    del alone, chained, pf, pi
    merged = got[0].reshape(-1).clone()
    merged[sel] = red
    full = R.query_step_rows_scan(*dstack, t, *args, windows_per_query=1,
                                  **kw).cpu()
    err = max(err, check_equal("escalated vs full depth", merged,
                               full.reshape(-1)))
    # one phase-1 batch, one redo batch of 8192 flagged reads and one
    # full-depth batch: CUDA events around each call (launch gaps
    # included), and the kernels' own device time
    rep = torch.arange(b) % max(len(sel), 1)
    fr, ir, mr = (x[rep].to(dev) for x in (fk, ik, mw))
    # the fused dispatch: phase 1 of the stack and a redo slice of half a
    # batch of its flagged reads on the side stream, against the two apart
    from metacache_tpu_torch.device import SideStream
    side = SideStream(dev)
    b2 = b // 2
    rslice = (fr[:b2][None], ir[:b2][None], mr[:b2].to(torch.int32)[None])
    fused = R.query_step_rows_scan_head_fused(*dstack, *rslice, t, *args,
                                              side=side, **kw)
    apart = (*R.query_step_rows_scan_head(*dstack, t, *args, prefetch=True,
                                          side=side, **kw),
             R.query_step_rows_redo_scan(*rslice, t, *args, **rkw))
    fused_err = max(check_equal(f"fused {i}", g.cpu(), w.cpu())
                    for i, (g, w) in enumerate(zip(fused, apart)))
    steps = {
        "phase1": lambda: R.query_step_rows_scan_head(*dstack, t, *args,
                                                      **kw),
        "redo": lambda: R.query_step_rows_redo(fr, ir, mr, t, *args, **rkw),
        "full_depth": lambda: R.query_step_rows_scan(
            *dstack, t, *args, windows_per_query=1, **kw),
        "fused_half_redo": lambda: R.query_step_rows_scan_head_fused(
            *dstack, *rslice, t, *args, side=side, **kw),
        "apart_half_redo": lambda: (
            R.query_step_rows_scan_head(*dstack, t, *args, prefetch=True,
                                        side=side, **kw),
            R.query_step_rows_redo_scan(*rslice, t, *args, **rkw))}
    times = {}
    for k, fn in steps.items():
        times[f"{k}_batch_ms"] = cuda_ms(fn)
        times[f"{k}_batch_device_ms"] = device_ms(fn)
    say(f"e2e-parity-{name}", reads=b, tolerance=0, max_abs_err=err,
        plain="CPU tensors of the same tables", cpu_copy_seconds=round(
            copy_s, 3), flagged=len(sel), classified=int((merged != 0).sum()),
        fused_vs_apart_max_abs_err=fused_err, fused_redo_reads=b2,
        **fold, **times)


def run_stagings(tmp, name, db, hist, stage_s, genomes, results,
                 profile=False):
    """The 944 Mbp summary query under the other stagings, each a main
    path of its own, each with the default's rank histogram: host rows
    filled in numpy and copied (MC_DEVICE_LAYOUT=0), probed through B9 as
    every row layout is, and the size-classed cells (MC_DENSE_LIMIT=1
    MC_CLASSED=1) with escalation (phase 1 through classed_bucket and
    classed_decode's head form, the redo through classed_decode at full
    depth, then B4); on the classed cells, classed_bucket and
    classed_decode at the main path's probes (``phase_parity_classed``);
    with ``profile`` a trace of the classed summary. -> the classed
    summary's launches."""
    from metacache_tpu_torch import kernels
    n = 1 << 20
    layout = "pk15"
    dense = ("sketch", DENSE, *cand_kernels())
    out = {"device_staging_seconds": round(stage_s, 3)}

    def classed(runner, batches):
        redo = -(-runner.esc_reads // SCAN_BATCH)
        want = {k: 0 for k in kernels.ALL}
        want.update({k: batches + redo for k in cand_kernels()},
                    sketch=batches, classed_bucket=batches,
                    classed_decode=batches + redo,
                    classify_lca=batches + redo,
                    rank_hist=stacks(runner, batches) +
                    len(runner.redo_dispatches))
        return want
    for tag, env, lay, expect in (
            ("host-rows", {"MC_DEVICE_LAYOUT": "0"}, layout, path_of(*dense)),
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
        if tag == "host-rows":
            out["host_rows_bucket_lanes"] = runner.tables.bucket_rows.shape[1]
        if tag == "classed":
            if not 0 < runner.esc_reads < n:
                raise AssertionError("the classed query did not escalate")
            out.update(classed_escalated_reads=runner.esc_reads,
                       classed_redo_batches=grew["candidates"]
                       - n // SCAN_BATCH)
            launches = grew
            phase_parity_classed(results, runner, genomes, name)
            if profile:
                with environ(**env):
                    phase_profile(tmp, name, runner, "-classed")
        del runner
        torch.cuda.empty_cache()
    say(f"stagings-{name}", histograms_equal=True, **out)
    return launches


def main_path_probes(runner, genomes, b: int = SCAN_BATCH):
    """The bucket probe's input on the summary path: B1's sketches of b
    reads of ``genomes`` (100 bp, the runner's packed infeed rows), (b *
    16,) int32 features on the card."""
    from metacache_tpu_torch.ops.sketch import sketch_windows_packed
    reads = sample_reads(np.random.default_rng(41), genomes, b)
    packed, lens, _m = packed_stack(reads, b)
    dev = torch.device("cuda")
    return sketch_windows_packed(
        packed.reshape(b, -1).to(dev), lens.reshape(b).to(torch.int32).to(
            dev), runner.sketching.kmerlen, 16).reshape(-1)


def phase_parity_classed(results, runner, genomes, name):
    """[parity-classed_bucket-<name>] and [parity-classed_decode-<name>]
    (full and head): the two kernels on the classed cells the summary
    staged, at the main path's 131,072 probes (B1's sketches of 8192
    reads), each against its plain version on the same CUDA tensors
    (tolerance 0), timed: device ms (CUDA graph), wrapper ms, plain ms,
    host us a call, bound. classed_decode's head form (rl =
    pow2(hsl), f = 16) is escalation phase 1's, a launch a batch; its
    full form (rl = pow2(c)) the redo's."""
    from metacache_tpu_torch.ops import probe_decode as D
    t = runner.tables
    flat = main_path_probes(runner, genomes)
    n = flat.shape[0]
    bits, hsl, c, sb = t.bucket_bits, t.head_slots, t.spf, t.slot_bits
    pidx, found = D.classed_bucket(t.bucket_rows, flat, bits)
    wp, wf = D.classed_bucket_plain(t.bucket_rows, flat, bits)
    err = max(check_equal("classed_bucket pidx", pidx, wp),
              check_equal("classed_bucket found", found, wf))

    def bucket():
        return D.classed_bucket(t.bucket_rows, flat, bits)
    ms, dms = cuda_ms(bucket), kernel_ms(bucket)
    pms = cuda_ms(lambda: D.classed_bucket_plain(t.bucket_rows, flat, bits))
    hus = host_us(bucket)
    # per probe: the feature, its 256-byte bucket row, pidx and found; the
    # least work a match, a class test and a rank test of 122 entries
    b_ms, by = _record(results, "classed_bucket", err=err, ms=ms,
                       plain_ms=pms, device_ms=dms, host_us=hus,
                       nbytes=n * (4 + 256 + 4 + 1), nops=n * 122 * 4,
                       shape=f"131072 probes, {bits} bucket bits, classed "
                             "944 Mbp index")
    cls = (pidx & 3)[found]
    say(f"parity-classed_bucket-{name}", probes=n, tolerance=0,
        max_abs_err=err, ms=ms, kernel_device_ms=dms, host_us_per_call=hus,
        plain_ms=pms, bound_ms=b_ms, bound_by=by,
        found_share=round(float(found.float().mean()), 4),
        class_shares=[round(float((cls == k).float().mean()), 4)
                      for k in range(3)])
    for form, head in (("full", False), ("head", True)):
        width = hsl if head else c
        rl = 1 << max(int(width - 1).bit_length(), 0)
        args = (t.fused_rows, t.ovf_rows, pidx, flat, hsl, c, rl, 16, sb,
                sb, head)
        got = D.classed_decode(*args)
        want = D.classed_decode_plain(*args)
        err = max(check_equal(f"classed_decode {form} {i}", g, w)
                  for i, (g, w) in enumerate(zip(got, want)))
        cnt = D.classed_decode(*args[:-1], True)[1]
        kept = int(torch.clamp(cnt, 0, width).sum())

        def call():
            return D.classed_decode(*args)
        ms, dms = cuda_ms(call), kernel_ms(call)
        pms = cuda_ms(lambda: D.classed_decode_plain(*args))
        hus = host_us(call)
        # per probe: pidx, the feature, the cell's meta lanes, the rl
        # output lanes (and the count); the slots its count keeps
        nbytes = n * (4 + 4 + 12 + 4 * rl + (4 if head else 0)) + 4 * kept
        shape = (f"131072 probes, f=16, hsl={hsl}, c={c}, rl={rl}, "
                 f"{form} form, classed 944 Mbp cells")
        if head:
            b_ms, by = _record(results, "classed_decode", err=err, ms=ms,
                               plain_ms=pms, device_ms=dms, host_us=hus,
                               nbytes=nbytes, nops=n * rl, shape=shape)
        else:
            b_ms, by = bound(nbytes, n * rl)
        say(f"parity-classed_decode-{name}", form=form, probes=n, rl=rl,
            tolerance=0, max_abs_err=err, ms=ms, kernel_device_ms=dms,
            host_us_per_call=hus, plain_ms=pms, bound_ms=b_ms, bound_by=by,
            slots_kept=kept)


def hbm_gb_for_budget(budget: int) -> str:
    """The MC_HBM_GB whose budget (device.py::hbm_budget_bytes: the total
    less max(2 GiB, 20%)) is ``budget`` bytes."""
    total = budget + (2 << 30) if budget <= 8 << 30 else budget / 0.8
    return f"{total / 2**30:.6f}"


def csr_window(db) -> dict:
    """A budget that admits a single-part database's CSR bytes and no
    row layout: below the least two-tier rows by the host rule (the
    feature count unpadded, so the builder's padded rows cannot fit
    either, and the classed cells are weighed only beside a fitting
    two-tier head), at the middle of [CSR bytes, that). -> the bytes
    and the MC_HBM_GB that gives the budget."""
    from metacache_tpu_torch.classify.runner import _max_window, \
        slot_pack_bits
    from metacache_tpu_torch.ops.probe import make_bucket_index
    from metacache_tpu_torch.ops.table import csr_bytes, device_layout
    d = Database.load(db)
    p = d.parts[0]
    spf = min(p.max_bucket_size, d.max_locations_per_feature) or 1
    pb = slot_pack_bits(d.target_count, _max_window(p))
    csr_b = csr_bytes(p, make_bucket_index(p.unique_features)[0].nbytes)
    head, dense_b, rows_b = device_layout(p, spf, pb, 1 << 62,
                                          allow_dense=False)
    if not csr_b < rows_b:
        raise AssertionError(f"no budget admits the CSR layout ({csr_b} "
                             f"bytes) and no row layout ({rows_b})")
    budget = (csr_b + rows_b) // 2
    return dict(csr_bytes=csr_b, least_two_tier_bytes=rows_b,
                least_two_tier_head=head, dense_bytes=dense_b,
                budget_bytes=budget, mc_hbm_gb=hbm_gb_for_budget(budget))


def run_csr(tmp, name, db, hist, path_kernels, env, stack=None,
            lines=None):
    """[query-summary-<name>] (layout False), [staging-<name>-csr] and
    [profile-<name>-csr]: the 2^20-read summary query (the reads of the
    dense staging's summary) with the database staged in the CSR layout
    under ``env``, a main path of its own (csr_decode once a batch
    beside ``path_kernels``): the dense staging's rank histogram, its
    staging seconds split into the host's (unpack_locations among them)
    and the card's, a profile of a warm second query (device busy, idle
    share); ``stack``:
    one stack of reads through the scan step against the plain path on
    CPU tensors; ``lines``: the dense staging's per-read mapping lines of
    reads_per_read.fa, which the CSR staging must give byte for byte.
    -> the summary's launches."""
    with environ(**env):
        runner, grew, res = phase_query_summary(
            tmp, name, db, 1 << 20, lambda r: r.layout == "False" and
            r.tables.csr, path_of(*path_kernels, "csr_decode"))
    if not np.array_equal(res.statistics.assigned_, hist):
        raise AssertionError(f"{name} CSR: the rank histogram differs from "
                             "the dense staging's")
    if runner.staged_bytes > runner.budget_bytes and \
            env.get("MC_DEVICE_LAYOUT") != "0":
        raise AssertionError(f"{name} CSR: {runner.staged_bytes} bytes "
                             f"staged, budget {runner.budget_bytes}")
    [split] = runner.stage_seconds
    t = runner.tables
    say(f"staging-{name}-csr", layout=runner.layout, env=env,
        staged_gib=round(runner.staged_bytes / 2**30, 3),
        budget_gib=round(runner.budget_bytes / 2**30, 3),
        features=t.num_features, locations=t.loc_tgt.numel(), spf=t.spf,
        bucket_bits=t.bucket_bits, wide=t.wide,
        staging_seconds=round(runner.stage_s, 3),
        host_seconds=round(split["host_s"], 3),
        unpack_locations_seconds=round(split["unpack_s"], 3),
        card_seconds=round(split["card_s"], 3), histogram_equal=True)
    phase_profile(tmp, name, runner, tag="-csr")
    if stack is not None:
        phase_e2e(f"{name}-csr", runner, stack)
    if lines is not None:
        got, _r, r = query_lines(db, os.path.join(tmp, name,
                                                  "reads_per_read.fa"),
                                 [], os.path.join(tmp, name, "csr.txt"),
                                 runner)
        got = [l for l in got if not l.startswith("#")]
        if got != lines:
            raise AssertionError(f"{name} CSR: {len(got)} mapping lines, "
                                 f"equal to the dense staging's "
                                 f"{len(lines)}: {got == lines}")
        say(f"query-per-read-{name}-csr", reads=len(got),
            lines_equal_dense=True, seconds=round(r.time_ms / 1000, 3),
            reads_per_min=round(len(got) / (r.time_ms / 60000.0)))
    del runner
    torch.cuda.empty_cache()
    return grew


def run_csr_window(tmp, name, db, hist, path_kernels, genomes=None,
                   per_read=False):
    """[csr-window-<name>] and the database in CSR under the MC_HBM_GB
    of that window (run_csr); with ``genomes`` one stack of their reads
    against the CPU, with ``per_read`` the per-read phase's 2^16 reads,
    whose lines must equal the dense staging's (its mapping.txt).
    -> the summary's launches."""
    win = csr_window(db)
    say(f"csr-window-{name}", **{k: (round(v / 2**30, 4) if k.endswith(
        "bytes") else v) for k, v in win.items()})
    lines = None
    if per_read:
        with open(os.path.join(tmp, name, "mapping.txt")) as f:
            lines = [l for l in f if not l.startswith("#")]
    stack = None if genomes is None else sample_reads(
        np.random.default_rng(8), genomes, SCAN_BATCH)
    return run_csr(tmp, name, db, hist, path_kernels,
                   {"MC_HBM_GB": win["mc_hbm_gb"]}, stack=stack,
                   lines=lines)


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
    m1, m2 = sample_pairs(np.random.default_rng(17), genomes, PAIRS)
    del genomes
    layout = "('two_tier', 61, True, False, 15)"       # pair-packed heads

    def escalated(runner, batches):
        return escalated_launches(runner.redo_dispatches, batches)
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
    phase_escalation_routes(tmp, name, runner, res, esc_reads, profile)
    # one CPU copy of the 24 GiB of tables for the single reads' and the
    # pairs' steps
    t0 = time.time()
    cpu = runner.tables.cpu_copy()
    copy_s = time.time() - t0
    phase_e2e_two_tier(name, runner, reads, cpu, copy_s)
    phase_e2e_pairs(name, runner, m1, m2, SCAN_BATCH, escalated=True,
                    cpu=cpu)
    del cpu
    # MC_PROBE_PALLAS=1 changes no route: B9 is the bucket probe under
    # every value, and B7 does B8's work, so B8 launches no time. The
    # stage is read at each probe: the summary's tables serve (before the
    # per-read query, which leaves its options on the runner)
    before = runner.esc_reads
    res1, pallas, dispatches = summary_again(tmp, name, runner,
                                             {"MC_PROBE_PALLAS": "1"})
    want = escalated_launches(dispatches, -(-len(reads) // SCAN_BATCH))
    if pallas != want:
        raise AssertionError(f"MC_PROBE_PALLAS=1: launches {pallas}, "
                             f"expected {want}")
    if not np.array_equal(res1.statistics.assigned_,
                          res.statistics.assigned_):
        raise AssertionError("MC_PROBE_PALLAS=1 changed the rank histogram")
    if runner.esc_reads - before != esc_reads or pallas["oidx_decode"] != 0:
        raise AssertionError("MC_PROBE_PALLAS=1 escalated otherwise")
    say(f"query-summary-{name}-probe-kernels", reads=res1.statistics.total(),
        reads_per_min=round(res1.statistics.total() /
                            (res1.time_ms / 60000.0)),
        seconds=round(res1.time_ms / 1000, 3), histogram_equal=True,
        launches=pallas)
    lines = phase_query_per_read(tmp, name, db, reads[:65536],
                                 runner=runner)
    with environ(MC_PROBE_PALLAS="1"):
        lines1 = phase_query_per_read(tmp, name, db, reads[:65536],
                                      tag="-probe-kernels", runner=runner)
    if lines1 != lines:
        raise AssertionError("MC_PROBE_PALLAS=1 changed the mapping lines")
    say(f"probe-kernels-{name}", histogram_equal=True, lines_equal=True,
        launches=pallas)
    pairs = run_pairs_two_tier(tmp, name, db, m1, m2, layout, runner,
                               profile)
    del runner
    torch.cuda.empty_cache()
    return launches, pallas, pairs


def escalated_launches(dispatches, batches: int, scan_k: int = 32) -> dict:
    """The launches an escalated summary of ``batches`` phase-1 batches
    makes with these redo dispatches (the runner's ``redo_dispatches``:
    route, batches, reads a batch, real reads): B1, B9, B6, B4 and
    classify_lca a phase-1 batch; B7, B4 and classify_lca a redo batch of
    any width (the fused dispatch's MC_ESC_B2-wide slices, padded with
    sentinel features, count as batches; they take phase 1's feature
    rows); the row redo (MC_PREFETCH=0) sketches and probes its batches
    again (B1, B9); rank_hist once a phase-1 stack of ``scan_k`` batches
    and once a redo dispatch."""
    from metacache_tpu_torch import kernels
    redo = sum(k for _r, k, _w, _g in dispatches)
    rows = sum(k for r, k, _w, _g in dispatches if r == "rows")
    want = {k: 0 for k in kernels.ALL}
    want.update({k: batches + redo for k in cand_kernels()},
                sketch=batches + rows, bucket_decode=batches + rows,
                head_decode=batches, full_decode=redo,
                classify_lca=batches + redo,
                rank_hist=-(-batches // max(1, min(scan_k, batches))) +
                len(dispatches))
    return want


ESC_SCAN_K = "8"    # stacks of the escalation routes' summaries


def phase_escalation_routes(tmp, name, runner, res, esc_reads, profile):
    """[escalation-routes-<name>]: the escalated summary once more on the
    same staged tables under MC_SCAN_K=8 (16 stacks, so that phase 1
    dispatches after flagged reads were collected), on each route of the
    redo: the fused dispatch (the default: slices of MC_ESC_B2 = 4096
    flagged reads a batch redone on the side stream beside a later phase
    1), separate redo stacks (MC_ESC_FUSED=0), and the reads' rows through
    the full-depth scan (MC_PREFETCH=0). Each gives the default summary's
    rank histogram and escalated reads, the launches its redo dispatches
    predict (``escalated_launches``), its wall and reads/min; with
    ``profile`` a trace of the fused and the separate route."""
    nreads = res.statistics.total()
    batches = -(-nreads // SCAN_BATCH)
    out = {}
    for tag, env in (("fused", {}), ("separate", {"MC_ESC_FUSED": "0"}),
                     ("rows", {"MC_PREFETCH": "0"})):
        env = dict(env, MC_SCAN_K=ESC_SCAN_K)
        before = runner.esc_reads
        r, grew, disp = summary_again(tmp, name, runner, env)
        esc = runner.esc_reads - before
        routes = collections.Counter(d[0] for d in disp)
        # the fused route redoes the last stacks' reads in separate stacks
        want_routes = {"fused": {"fused", "feats"}, "separate": {"feats"},
                       "rows": {"rows"}}[tag]
        if not np.array_equal(r.statistics.assigned_,
                              res.statistics.assigned_):
            raise AssertionError(f"{tag}: the rank histogram changed")
        if esc != esc_reads or sum(d[3] for d in disp) != esc:
            raise AssertionError(f"{tag}: {esc} escalated reads, redone "
                                 f"{sum(d[3] for d in disp)}, expected "
                                 f"{esc_reads}")
        need = {"fused": "fused", "separate": "feats", "rows": "rows"}[tag]
        if need not in routes or not set(routes) <= want_routes or any(
                (d[0] == "fused") != (d[2] == SCAN_BATCH // 2) or
                d[1] > int(ESC_SCAN_K) for d in disp):
            raise AssertionError(f"{tag}: redo dispatches {disp}")
        want = escalated_launches(disp, batches, int(ESC_SCAN_K))
        if grew != want:
            raise AssertionError(f"{tag}: launches {grew}, expected {want}")
        out[tag] = r
        trace = {}
        if profile and tag != "rows":
            with environ(**env):
                trace = phase_profile(tmp, name, runner, f"-esc-{tag}")
        say(f"escalation-routes-{name}-{tag}", reads=nreads,
            scan_k=int(ESC_SCAN_K), histogram_equal=True,
            escalated_reads=esc, redo_dispatches=dict(routes),
            redo_batches=sum(d[1] for d in disp),
            redo_batch_reads=sorted({d[2] for d in disp}),
            seconds=round(r.time_ms / 1000, 3),
            reads_per_min=round(nreads / (r.time_ms / 60000.0)),
            launches={k: v for k, v in grew.items() if v},
            **{k: round(v, 4) for k, v in trace.items()})
    return out


def phase_dense_limit(tmp, name, db, dense_hist):
    """The many-target database under MC_DENSE_LIMIT=1: two-tier (tgt,
    win) lane rows, dense_decode and B5, no escalation; its histogram
    equals the dense run's."""
    os.environ["MC_DENSE_LIMIT"] = "1"
    try:
        runner, _l, res = phase_query_summary(
            tmp, name, db, 1 << 20,
            lambda r: r.tables.head_slots > 0 and r._pack_bits == 0,
            path_of("sketch", DENSE, "candidates_unpacked"))
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


def long_window_jobs(tmp, genomes, species) -> list:
    """The 944 Mbp genomes written for run_long_windows (all but the
    256-strain group in a.fa, that group in b.fa) -> its `build` and
    `modify` as jobs of ``Background``."""
    sub = os.path.join(tmp, "944mbp-w255")
    os.makedirs(sub)
    a, b = os.path.join(sub, "a.fa"), os.path.join(sub, "b.fa")
    split = len(genomes) - 256
    write_genomes(a, genomes, species, 0, split)
    write_genomes(b, genomes, species, split)
    tax = os.path.join(sub, "taxonomy")
    write_taxonomy(tax, int(species.max()) + 1)
    db = os.path.join(sub, "db")
    return [{"args": ["build", db, a, "-winlen", "255", "-taxonomy", tax]},
            {"args": ["modify", db, b, "-taxonomy", tax]}]


def run_long_windows(tmp, genomes, built, profile):
    """The 944 Mbp genomes at -winlen 255 (stride 240), through B2: built
    in two steps (`build` without the 256-strain group, then `modify`
    with it; ``built``: the results of ``long_window_jobs``), 2^20 250 bp
    reads on the summary path (the main path of B2), the scan step
    against the plain path, 65,536 reads on the per-read path, and
    `build+query` of all genomes in one step, whose mapping lines must
    equal the per-read query's on the modified database. -> the
    summary's launches."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.cli.main import main as cli
    name = "944mbp-w255"
    sub = os.path.join(tmp, name)
    a, b = os.path.join(sub, "a.fa"), os.path.join(sub, "b.fa")
    split = len(genomes) - 256
    tax = os.path.join(sub, "taxonomy")
    db = os.path.join(sub, "db")
    steps = {}
    for step, job in zip(("build", "modify"), built):
        launched = job["launches"]
        steps[step] = dict(seconds=job["seconds"],
                           sketch_long=launched.get("sketch_long", 0),
                           sketch=launched.get("sketch", 0))
        if steps[step]["sketch_long"] <= 0 or steps[step]["sketch"]:
            raise AssertionError(f"{step} launches {launched}")
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
        max_window=maxwin, **steps)
    del d, p
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20, 250)
    layout = f"pk{(2 * maxwin).bit_length()}"
    runner, launches, _res = phase_query_summary(
        tmp, name, db, reads, layout,
        path_of("sketch_long", DENSE, *cand_kernels()))
    say(f"staging-{name}", layout=runner.layout,
        dense_gib=round(runner.dense_bytes / 2**30, 3),
        staged_gib=round(runner.tables.nbytes() / 2**30, 3),
        rows=tuple(runner.tables.fused_rows.shape))
    if profile:
        phase_profile(tmp, name, runner)
    phase_e2e(name, runner, reads)
    # the summary's staged tables serve the per-read query
    lines = phase_query_per_read(tmp, name, db, reads[:65536],
                                 runner=runner)
    del runner
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


def route_spy(stats: list):
    """Wrap ops.rows.rows_to_result, which each query step calls with
    the branch its route chose: every call appends its rows, padded
    width, sweep, branch, whether a fused batch takes the kernel's wide
    form (rows past one block's shared memory), and, when it does not
    fuse, the reason (the candidate kernels off, the rank-join sweep, or
    other flags), and the device memory it allocated beyond what was
    allocated before it (``work``, from a peak reset at its start) and
    the peak since the previous call (``peak``: the probe's included).
    -> a function that restores the original."""
    from metacache_tpu_torch.ops import rows as R
    from metacache_tpu_torch.ops.candidates import (MAX_CAND_L2,
                                                    MAX_UNPACKED_L2,
                                                    padded_width)
    real = R.rows_to_result

    def spy(tgt, win, mwir, *a, **kw):
        walk, dedup = kw.get("walk_elems", 0), kw.get("dedup_walk", 0)
        pb, fc = kw.get("pack_bits", 0), kw.get("fused_candidates", True)
        b, l = tgt.shape
        fused = R.fuses(fc, kw.get("fast_top2", False), kw["max_candidates"],
                        walk, dedup, kw.get("emit_hits", False))
        if fused:
            reason = ""
        elif not R.fused_candidates_enabled():
            reason = "off"
        elif not (walk or dedup):
            reason = "rank-join"
        else:
            reason = "flags"
        sweep = "dedup" if dedup else "walk" if walk and (
            fused or walk < l) else "rank-join"
        peak = torch.cuda.max_memory_allocated()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = real(tgt, win, mwir, *a, **kw)
        work = torch.cuda.max_memory_allocated() - before
        wide = fused and padded_width(l) > (MAX_CAND_L2 if pb
                                            else MAX_UNPACKED_L2)
        stats.append(dict(rows=b, width=padded_width(l), sweep=sweep,
                          fused=fused, wide=wide, reason=reason, work=work,
                          peak=max(peak, before + work)))
        return res
    R.rows_to_result = spy
    return lambda: setattr(R, "rows_to_result", real)


def predict_routes(runner, lens) -> dict:
    """The batches each route would take for reads of these lengths, in
    file order, from the runner's own batching and flags (the native
    reader's batch of reads, ``_dispatch_coded``'s window buckets,
    ``_step_flags`` and ``ops.rows.route``), without classifying: ->
    batch and read counts by route (narrow and wide kernel forms,
    non-fused) and the widest row."""
    from metacache_tpu_torch.classify import runner as RN
    from metacache_tpu_torch.ops import rows as R
    from metacache_tpu_torch.ops import windows as W
    from metacache_tpu_torch.ops.candidates import (MAX_CAND_L2,
                                                    MAX_UNPACKED_L2,
                                                    padded_width)
    sk, opt = runner.sketching, runner.opt
    stride = runner.db.sketching.winstride
    limit = MAX_CAND_L2 if runner._pack_bits else MAX_UNPACKED_L2
    nr = max(opt.batch_windows, 1024)
    max_len = max(1024, int(lens.max()))
    if max_len > 1024:
        nr = max(256, min(nr, (128 << 20) // max_len))
    nwin = {n: W.num_windows(n, sk) for n in np.unique(lens).tolist()}
    out = collections.Counter()
    widest = 0
    for b0 in range(0, len(lens), nr):
        buckets = collections.defaultdict(list)
        for n in lens[b0:b0 + nr].tolist():
            buckets[1 if n <= sk.winlen else RN._bucket_wq(nwin[n])].append(n)
        for wq, ns in buckets.items():
            rows = RN._round_up_pow2(len(ns))
            mwir = np.full(rows, 2, np.int32)
            mwir[:len(ns)] = [2 + max(n, opt.classify.insert_size_max) //
                              stride for n in ns]
            flags = runner._step_flags(mwir, wq,
                                       opt.classify.max_candidates)
            fused, alt = R.route(
                flags["fused_candidates"], flags["fast_top2"],
                flags["max_candidates"], flags.get("walk_elems", 0),
                flags.get("dedup_walk", 0), flags["emit_hits"],
                wq * sk.sketchlen, runner.tables.spf)
            width = padded_width(wq * sk.sketchlen *
                                 (alt or runner.tables.spf))
            kind = ("nonfused" if not fused else
                    "wide" if width > limit else "narrow")
            out[f"{kind}_batches"] += 1
            out[f"{kind}_reads"] += len(ns)
            widest = max(widest, width)
    return dict(sorted(out.items()), widest_row_slots=widest)


def ballast_rank_join(sub, name, runner, path, dev=torch.device("cuda")):
    """[nonfused-ballast-<name>-rank-join]: the long reads of ``path``
    (all past 47 windows, so every batch sweeps by the rank join on the
    non-fused path) on the runner's tables, per read with -tophits, once
    as they come, then beside a ballast tensor that leaves free a third
    of the largest batch's sized bytes (rows x padded width x
    RANK_JOIN_BYTES_A_SLOT; at least two rows): more launches, the same
    lines, the memory the query took beside the ballast within what was
    free, and each launch's bytes a padded slot (route_spy's work) within
    the sizing's figure."""
    from metacache_tpu_torch.classify import runner as RN
    from metacache_tpu_torch.device import free_bytes
    runs = {}
    ballast = None
    for tag in ("alone", "ballast"):
        if tag == "ballast":
            widest = max(x["width"] for x in runs["alone"]["stats"])
            sized = max(x["rows"] * x["width"]
                        for x in runs["alone"]["stats"]) *                 RN.RANK_JOIN_BYTES_A_SLOT
            keep = max(sized // 3, 2 * widest * RN.RANK_JOIN_BYTES_A_SLOT)
            torch.cuda.empty_cache()
            ballast = torch.empty(max(free_bytes(dev) - keep, 0),
                                  dtype=torch.uint8, device=dev)
        free = free_bytes(dev)
        stats: list = []
        before = runner.row_launches
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        restore = route_spy(stats)
        out_path = os.path.join(sub, f"rank-join-{tag}.txt")
        try:
            with open(out_path, "w") as out:
                _query(None, path, ["-tophits"], out, runner)
        finally:
            restore()
        peak = max([torch.cuda.max_memory_allocated()] +
                   [x["peak"] for x in stats])
        runs[tag] = dict(stats=stats, lines=mapping_lines(out_path),
                         launches=runner.row_launches - before,
                         free=free, took=peak - held)
    del ballast
    torch.cuda.empty_cache()
    alone, split = runs["alone"], runs["ballast"]
    a_slot = max(x["work"] / (x["rows"] * x["width"])
                 for x in split["stats"])
    if {x["sweep"] for x in alone["stats"] + split["stats"]} != \
            {"rank-join"} or any(x["fused"] for x in split["stats"]):
        raise AssertionError("a long read's batch did not sweep by the "
                             "rank join")
    if split["lines"] != alone["lines"] or \
            split["launches"] <= alone["launches"] or \
            split["took"] > split["free"] or \
            a_slot > RN.RANK_JOIN_BYTES_A_SLOT:
        raise AssertionError(
            f"rank-join ballast: lines equal {split['lines'] == alone['lines']}"
            f", launches {alone['launches']} -> {split['launches']}, took "
            f"{split['took']} of {split['free']} free bytes, "
            f"{a_slot:.2f} bytes a padded slot")
    say(f"nonfused-ballast-{name}-rank-join", reads=len(alone["lines"]),
        batches=alone["launches"], launches_beside_ballast=split["launches"],
        widest_row_slots=max(x["width"] for x in alone["stats"]),
        most_rows_a_launch=max(x["rows"] for x in split["stats"]),
        free_gib_beside_ballast=round(split["free"] / 2**30, 3),
        took_gib=round(split["took"] / 2**30, 3),
        bytes_per_padded_slot_max=round(a_slot, 2),
        sized_bytes_per_padded_slot=RN.RANK_JOIN_BYTES_A_SLOT,
        lines_equal=True)


def run_long_reads(tmp, name, db, genomes, nreads, profile, narrow, wide,
                   ballast=False):
    """[query-long-<name>]: ``nreads`` long reads against a database
    with per-read output and -tophits, on the default routes (the
    kernel ``narrow`` on rows one block holds, its wide form ``wide`` on
    wider ones, the non-fused path where JAX's flags do not fuse: ranges
    past 48 windows) and under MC_FUSED_CANDIDATES=0 (every batch
    non-fused, on the same staged tables), whose mapping lines must be
    byte-identical. Prints each
    run's reads/min (the runner's clock), batches by route, the widest
    row, the sweeps, the peak device memory and the launches; then the
    routes predicted from the runner's batching for the same lengths
    (which must equal the measured ones) and for log-normal spreads of
    0.7 and 1.5 beside the assumed 1. With ``ballast``, the reads that
    sweep by the rank join once more beside a ballast
    (``ballast_rank_join``). -> the default run's launches."""
    from metacache_tpu_torch import kernels
    path = os.path.join(tmp, name, "reads_long.fa")
    t0 = time.time()
    codes, offs = sample_long_reads(np.random.default_rng(8), genomes,
                                    nreads)
    write_long_reads(path, codes, offs)
    lens = np.diff(offs)
    rank_join = os.path.join(tmp, name, "reads_rank_join.fa")
    if ballast:
        # mwir = 2 + length // stride past MAX_DEDUP_WALK: the rank join
        from metacache_tpu_torch.classify.runner import QueryRunner
        from metacache_tpu_torch.config import SketchingOptions
        stride = SketchingOptions().resolved().winstride
        sel = np.nonzero(lens >= (QueryRunner.MAX_DEDUP_WALK - 1) *
                         stride)[0]
        write_long_reads(rank_join, np.concatenate(
            [codes[offs[i]:offs[i + 1]] for i in sel]),
            np.concatenate([[0], np.cumsum(lens[sel])]))
    say(f"long-reads-{name}", reads=nreads, bases=int(offs[-1]),
        median_bp=int(np.median(lens)), mean_bp=round(float(lens.mean()), 1),
        p99_bp=int(np.percentile(lens, 99)), max_bp=int(lens.max()),
        over_5kbp=int((lens > 5000).sum()), sigma_assumed=1.0,
        data_gen_seconds=round(time.time() - t0, 3))
    del codes
    db = Database.load(db)
    lines, main_path, runner = {}, None, None
    for tag in ("", "-nonfused"):
        stats: list = []
        out_path = os.path.join(tmp, name, f"long{tag}.txt")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_counts()
        restore = route_spy(stats)
        if tag:
            # MC_FUSED_CANDIDATES=0 on the same staged tables (nonfused)
            runner._fused_candidates = False
        try:
            with open(out_path, "w") as out:
                runner, res, stage_s = _query(db, path, ["-tophits"], out,
                                              runner)
        finally:
            restore()
        grew = {k: v.launches for k, v in kernels.ALL.items()}
        peak = max([torch.cuda.max_memory_allocated()] +
                   [x["peak"] for x in stats])
        with open(out_path) as f:
            lines[tag] = [l for l in f if not l.startswith("#")]
        n = res.statistics.total()
        if n != nreads or len(lines[tag]) != nreads:
            raise AssertionError(f"{n} reads, {len(lines[tag])} lines")
        fused = [x for x in stats if x["fused"]]
        other = [x for x in stats if not x["fused"]]
        wides = [x for x in fused if x["wide"]]
        if grew["classify_lca"] != len(stats):
            raise AssertionError(f"classify_lca launched "
                                 f"{grew['classify_lca']} times in "
                                 f"{len(stats)} steps")
        if tag == "":
            main_path = grew
            if not (wides and grew["sketch"] > 0 and
                    grew[narrow] + grew[wide] == len(fused) and
                    grew[wide] == len(wides) and
                    {x["reason"] for x in other} <= {"rank-join"}):
                raise AssertionError(f"routes: {len(fused)} fused, "
                                     f"{len(wides)} wide, {len(other)} "
                                     f"non-fused, {grew}")
            measured = collections.Counter()
            for x in stats:
                kind = ("nonfused" if not x["fused"] else
                        "wide" if x["wide"] else "narrow")
                measured[f"{kind}_batches"] += 1
        elif fused or grew[narrow] or grew[wide] or grew["sketch"] <= 0:
            raise AssertionError(f"MC_FUSED_CANDIDATES=0 fused {len(fused)} "
                                 f"batches, launches {grew}")
        frac = res.statistics.assigned() / n
        work = max(other, key=lambda x: x["work"] / (x["rows"] * x["width"]),
                   default=None)
        say(f"query-long-{name}{tag}", reads=n,
            reads_per_min=round(n / (res.time_ms / 60000.0)),
            seconds=round(res.time_ms / 1000, 3),
            classified_fraction=round(frac, 6), batches=len(stats),
            fused_batches=len(fused), wide_form_batches=len(wides),
            nonfused_batches=len(other),
            nonfused_reasons=dict(collections.Counter(
                x["reason"] for x in other)),
            fused_read_rows=sum(x["rows"] for x in fused),
            wide_form_read_rows=sum(x["rows"] for x in wides),
            nonfused_read_rows=sum(x["rows"] for x in other),
            sweeps=dict(collections.Counter(x["sweep"] for x in stats)),
            widest_row_slots=max(x["width"] for x in stats),
            widest_fused_row_slots=max([x["width"] for x in fused] or [0]),
            most_rows_a_launch=max(x["rows"] for x in stats),
            peak_allocated_gib=round(peak / 2**30, 3),
            nonfused_work_bytes_per_slot_max=None if work is None else round(
                work["work"] / (work["rows"] * work["width"]), 2),
            nonfused_work_gib_max=round(max([x["work"] for x in other] or
                                            [0]) / 2**30, 3),
            wide_form_work_gib_max=round(max([x["work"] for x in wides] or
                                             [0]) / 2**30, 3),
            tables_gib=round(runner.tables.nbytes() / 2**30, 3),
            staging_seconds=round(stage_s, 3),
            launches={k: v for k, v in grew.items() if v})
        if not frac > 0.5:
            raise AssertionError(f"classified fraction {frac} too low")
        if profile and tag == "":
            phase_profile(tmp, name, runner, "-long", reads="reads_long.fa",
                          share=WIDE_KERNELS)
        if ballast and tag == "":
            ballast_rank_join(os.path.join(tmp, name), name, runner,
                              rank_join)
        if tag == "":
            pred = {}
            for sigma in (0.7, 1.0, 1.5):
                pl = long_read_lengths(np.random.default_rng(8), nreads,
                                       sigma)
                pred[sigma] = predict_routes(runner, pl)
            got = {k: v for k, v in pred[1.0].items()
                   if k.endswith("_batches")}
            if got != dict(measured):
                raise AssertionError(f"predicted routes {got}, measured "
                                     f"{dict(measured)}")
            for sigma, p in pred.items():
                say(f"long-read-routes-{name}", sigma=sigma,
                    measured=sigma == 1.0, reads=nreads,
                    read_share_wide=round(p.get("wide_reads", 0) / nreads, 4),
                    read_share_nonfused=round(p.get("nonfused_reads", 0) /
                                              nreads, 4), **p)
        del res
    del runner
    torch.cuda.empty_cache()
    if lines[""] != lines["-nonfused"]:
        diff = sum(x != y for x, y in zip(lines[""], lines["-nonfused"]))
        raise AssertionError(f"MC_FUSED_CANDIDATES=0 changed {diff} of "
                             f"{nreads} mapping lines")
    say(f"long-reads-{name}-fused-vs-nonfused", mapping_lines=nreads,
        lines_equal=True)
    return main_path


def run_merge_many_target(tmp, db, genomes):
    """[query-merge-many-target]: the many-target database with -lowest
    species -maxcand 8 -allhits on 2^14 reads of 100 bp (the non-fused
    path, taxon merging, per-hit lists; one batch), reads/min; then
    three 512-row blocks of the batch's slot rows (first, middle, last)
    moved to the CPU and run through rows_to_result there, all nine
    QueryResult fields equal to the card's rows (query ids taken
    relative to the block)."""
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.ops import rows as R
    name = "many-target"
    path = os.path.join(tmp, name, "reads_merge.fa")
    write_reads(path, sample_reads(np.random.default_rng(9), genomes,
                                   MERGE_READS))
    calls, stats = [], []
    real = R.rows_to_result

    def keep(*a, **kw):
        res = real(*a, **kw)
        calls.append((a, kw, res))
        return res
    R.rows_to_result = keep
    restore = route_spy(stats)
    out_path = os.path.join(tmp, name, "merge.txt")
    kernels.reset_counts()
    try:
        with open(out_path, "w") as out:
            runner, res, stage_s = _query(
                db, path, ["-lowest", "species", "-maxcand", "8",
                           "-allhits"], out)
    finally:
        restore()
        R.rows_to_result = real
    lca = kernels.CLASSIFY_LCA.launches
    with open(out_path) as f:
        nlines = sum(1 for l in f if not l.startswith("#"))
    n = res.statistics.total()
    if n != MERGE_READS or nlines != n or any(x["fused"] for x in stats) \
            or lca != len(stats):
        raise AssertionError(f"{n} reads, {nlines} lines, routes {stats}, "
                             f"classify_lca launches {lca}")
    a, kw, got = max(calls, key=lambda c: c[0][0].shape[0])
    tgt, win, mwir = a[:3]
    b, l = tgt.shape
    blk = 512
    cpu = [x.cpu() if torch.is_tensor(x) else x for x in a[3:]]
    err = 0
    for r0 in (0, b // 2 - blk // 2, b - blk):
        sl = slice(r0, r0 + blk)
        want = real(tgt[sl].cpu(), win[sl].cpu(), mwir[sl].cpu(), *cpu,
                    **kw)
        for f in want._fields:
            g = getattr(got, f)
            if f.startswith("hit_"):
                g = g.reshape(b, l)[sl]
                if f == "hit_qid":
                    g = torch.where(g == b, blk, g - r0)
                g = g.reshape(-1)
            else:
                g = g[sl]
            err = max(err, check_equal(f"merge {f} rows {r0}", g.cpu(),
                                       getattr(want, f)))
    say("query-merge-many-target", reads=n,
        reads_per_min=round(n / (res.time_ms / 60000.0)),
        seconds=round(res.time_ms / 1000, 3),
        classified_fraction=round(res.statistics.assigned() / n, 6),
        batches=len(stats), rows=b, width=l, classify_lca_launches=lca,
        sweeps=dict(collections.Counter(x["sweep"] for x in stats)),
        card_vs_cpu_blocks=3, block_rows=blk, fields=len(got._fields),
        tolerance=0, max_abs_err=err,
        hits_listed=int((got.hit_qid < b).sum()),
        staging_seconds=round(stage_s, 3))
    del runner, res, calls, got
    torch.cuda.empty_cache()


def launch_counts() -> dict:
    from metacache_tpu_torch import kernels
    return {k: v.launches for k, v in kernels.ALL.items()}


def mapping_lines(path) -> list:
    with open(path) as f:
        return [l for l in f if not l.startswith("#")]


def phase_e2e_pairs(name, runner, m1, m2, b, escalated=False, cpu=None,
                    dev=torch.device("cuda")):
    """One stack of b pairs (two coded windows a query, mwir 2 + 200 //
    stride, the runner's sweep) through the scan step on the card and
    the plain path on CPU tensors of the same tables (``cpu``, or a copy
    made here); ``escalated``: also phase 1 (B1, B6, B4) and the redo of
    its flagged pairs (B7, B4), whose merge must equal the full-depth
    scan."""
    from metacache_tpu_torch.ops import rows as R
    b = min(b, len(m1))
    t = runner.tables
    t0 = time.time()
    cpu = t.cpu_copy() if cpu is None else cpu
    copy_s = time.time() - t0
    codes = np.full((1, b, 2, 127), 4, np.uint8)
    codes[0, :, 0, :m1.shape[1]] = m1[:b]
    codes[0, :, 1, :m2.shape[1]] = m2[:b]
    lens = np.full((1, b, 2), m1.shape[1], np.int32)
    mw = 2 + 2 * m1.shape[1] // runner.db.sketching.winstride
    mwir = np.full((1, b), mw, np.int32)
    host = [torch.from_numpy(x) for x in (codes, lens, mwir)]
    card = [x.to(dev) for x in host]
    args = (runner.hits_min, 1.0, runner.highest_rank, runner.merge_rank)
    sweep = runner._sweep_params(np.array([mw], np.int32), 2)
    kw = dict(k=16, sketchlen=16, max_candidates=2, fast_top2=True,
              pack_bits=runner._pack_bits, **sweep)
    full = R.query_step_rows_scan(*card, t, *args, windows_per_query=2,
                                  **kw).cpu()
    err = check_equal("paired scan", full, R.query_step_rows_scan(
        *host, cpu, *args, windows_per_query=2, **kw))
    extra = {}
    if escalated:
        got = [x.cpu() for x in R.query_step_rows_scan_head(*card, t, *args,
                                                             **kw)]
        want = R.query_step_rows_scan_head(*host, cpu, *args, **kw)
        err = max([err] + [check_equal(f"paired phase 1 {i}", g, w)
                           for i, (g, w) in enumerate(zip(got, want))])
        bits = got[1].numpy().reshape(-1)
        mask = ((bits[:, None] >> np.arange(32)) & 1).astype(bool)
        sel = torch.from_numpy(np.nonzero(mask.reshape(-1))[0])
        rkw = {k: v for k, v in kw.items() if k not in ("k", "sketchlen")}
        fk, ik = got[2].reshape(b, -1)[sel], got[3].reshape(b, -1)[sel]
        mws = host[2].reshape(-1)[sel]
        red = R.query_step_rows_redo(fk.to(dev), ik.to(dev), mws.to(dev), t,
                                     *args, **rkw).cpu()
        err = max(err, check_equal("paired redo", red, R.query_step_rows_redo(
            fk, ik, mws, cpu, *args, **rkw)))
        merged = got[0].reshape(-1).clone()
        merged[sel] = red
        err = max(err, check_equal("paired escalated vs full depth", merged,
                                   full.reshape(-1)))
        extra = dict(flagged=len(sel), feats_per_pair=fk.shape[1])
    say(f"e2e-parity-pairs-{name}", pairs=b, windows_per_query=2, mwir=mw,
        sweep=sweep, tolerance=0, max_abs_err=err,
        plain="CPU tensors of the same tables", cpu_copy_seconds=round(
            copy_s, 3), classified=int((full != 0).sum()), **extra)


def phase_pairs_per_read(tmp, name, db, files, runner=None, checks=()):
    """Per-read -pairfiles -tophits on the files' pairs (the subset's
    two files and its interleaved one), and with ``checks``: the summary
    of the same pairs, whose rank histogram the per-read lines' rank
    counts must equal ("summary"), -insertsize 500 ("insertsize"),
    -pairseq on the interleaved file, whose lines must be byte-identical
    ("pairseq"), and MC_FUSED_CANDIDATES=0 (``nonfused``), whose lines
    must be byte-identical ("nonfused"). Launches are counted for
    the -tophits query alone. -> (lines, launches, the summary's runner
    or ``runner``)."""
    sub = os.path.join(tmp, name)
    pair = [os.path.join(sub, f) for f in files[:2]]
    out = {}
    ran = {}

    def per_read(tag, args, paths):
        nonlocal runner
        path = os.path.join(sub, f"pairs{tag}.txt")
        with open(path, "w") as f:
            runner, res, stage_s = _query(db, paths, args, f, runner)
        lines = mapping_lines(path)
        if len(lines) != res.statistics.total():
            raise AssertionError(f"{tag}: {len(lines)} lines for "
                                 f"{res.statistics.total()} pairs")
        ran[tag or "tophits"] = dict(
            pairs_per_min=round(res.statistics.total() /
                                (res.time_ms / 60000.0)),
            seconds=round(res.time_ms / 1000, 3))
        return lines, res
    hist = None
    if "summary" in checks:
        runner, res, _s = _query(db, pair, ["-pairfiles", "-no-map"],
                                 io.StringIO(), runner)
        hist = res.statistics.assigned_.copy()
        ran["summary"] = dict(pairs_per_min=round(
            res.statistics.total() / (res.time_ms / 60000.0)))
    from metacache_tpu_torch import kernels
    kernels.reset_counts()
    out[""], res = per_read("", ["-pairfiles", "-tophits"], pair)
    grew = launch_counts()
    n = res.statistics.total()
    if hist is not None and not np.array_equal(res.statistics.assigned_,
                                               hist):
        raise AssertionError("per-read rank counts != summary histogram")
    if "insertsize" in checks:
        ins, _r = per_read("-insertsize500", ["-pairfiles", "-tophits",
                                              "-insertsize", "500"], pair)
        ran["-insertsize500"]["lines_changed"] = sum(
            x != y for x, y in zip(ins, out[""]))
    if "pairseq" in checks:
        seq, _r = per_read("-pairseq", ["-pairseq", "-tophits"],
                           [os.path.join(sub, files[2])])
        if seq != out[""]:
            raise AssertionError("-pairseq lines != -pairfiles lines")
    if "nonfused" in checks:
        with nonfused(runner):
            nf, _r = per_read("-nonfused", ["-pairfiles", "-tophits"], pair)
        if nf != out[""]:
            diff = sum(x != y for x, y in zip(nf, out[""]))
            raise AssertionError(f"MC_FUSED_CANDIDATES=0 changed {diff} "
                                 "mapping lines")
    say(f"query-pair-per-read-{name}", pairs=n, mapping_lines=len(out[""]),
        checks_passed=list(checks), runs=ran,
        launches={k: v for k, v in grew.items() if v})
    return out[""], grew, runner


@contextlib.contextmanager
def nonfused(runner):
    """MC_FUSED_CANDIDATES=0 on a runner's staged tables: the runner
    reads the variable when it stages, and nothing it stages depends on
    it, so the queries inside take the non-fused result path as a runner
    staged under the variable would."""
    was = runner._fused_candidates
    runner._fused_candidates = False
    try:
        yield runner
    finally:
        runner._fused_candidates = was


def query_lines(db, paths, args, out_path, runner=None, env=None):
    """A query's whole output, written to ``out_path``, without its
    timing lines. -> (lines, runner, results)."""
    with environ(**(env or {})), open(out_path, "w") as out:
        runner, res, _s = _query(db, paths, args, out, runner)
    with open(out_path) as f:
        lines = [l for l in f if not l.startswith(("# time:", "# speed:"))]
    return lines, runner, res


def run_covpct(tmp, name, db):
    """[query-covpct-944mbp]: the per-read phase's 2^16 reads with
    -cov-percentile 50 -tophits (mappings saved, targets below the
    coverage percentile dropped, every read classified again on the
    host), and again under MC_FUSED_CANDIDATES=0 (``nonfused``): the
    same lines. -> the runner, whose staged tables serve run_align and
    run_repl (the same hit minimum, ranks and candidates)."""
    sub = os.path.join(tmp, name)
    reads = os.path.join(sub, "reads_per_read.fa")
    args = ["-cov-percentile", "50", "-tophits"]
    got, runner, res = query_lines(db, reads, args,
                                   os.path.join(sub, "covpct.txt"))
    with nonfused(runner):
        nf, runner, _r = query_lines(
            db, reads, args, os.path.join(sub, "covpct_nonfused.txt"),
            runner)
    n = res.statistics.total()
    rows = sum("\t|\t" in l and not l.startswith("#") for l in got)
    if nf != got or rows != n or n != PAIRS_PER_READ:
        raise AssertionError(f"-cov-percentile: {rows} lines for {n} reads, "
                             f"equal under MC_FUSED_CANDIDATES=0: "
                             f"{nf == got}")
    say(f"query-covpct-{name}", reads=n, reads_per_min=round(
        n / (res.time_ms / 60000.0)), seconds=round(res.time_ms / 1000, 3),
        classified_fraction=round(res.statistics.assigned() / n, 6),
        lines_equal_nonfused=True)
    return runner


def run_align(tmp, name, db, genomes, species, nreads, runner):
    """[query-align-944mbp]: ``nreads`` reads with -align -tophits; each
    classified read's alignment re-reads its top target's record from
    the target's FASTA file (as JAX and the reference binary do), one
    file a genome here. The same output under MC_FUSED_CANDIDATES=0;
    the share of alignment blocks whose subject is the read's true
    genome, and of its species (a strain's reads fit its 0.3%-apart
    sister strains as well). ``runner``: run_covpct's. -> the runner."""
    import re
    sub = os.path.join(tmp, name)
    reads, gsel = sample_reads(np.random.default_rng(11), genomes, nreads,
                               with_genomes=True)
    path = os.path.join(sub, "reads_align.fa")
    write_reads(path, reads)
    got, runner, res = query_lines(db, path, ["-align", "-tophits"],
                                   os.path.join(sub, "align.txt"), runner)
    with nonfused(runner):
        nf, runner, _r = query_lines(
            db, path, ["-align", "-tophits"],
            os.path.join(sub, "align_nonfused.txt"), runner)
    if nf != got:
        raise AssertionError("-align: MC_FUSED_CANDIDATES=0 changed lines")
    # a block follows the mapping line of its read (header ">r<i>")
    nrows, scores, true, same_species, read = 0, [], 0, 0, -1
    for l in got:
        m = re.search(r"score\s+(-?\d+)\s+aligned to \S*GEN(\d+)\.fa #1 ",
                      l)
        if m:
            scores.append(int(m.group(1)))
            g = int(m.group(2))
            true += g == gsel[read]
            same_species += species[g] == species[gsel[read]]
        elif "\t|\t" in l and not l.startswith("#"):
            nrows += 1
            read = int(l.split("\t|\t")[0][1:])
    if not scores or nrows != nreads:
        raise AssertionError(f"-align: {len(scores)} blocks, {nrows} lines")
    blocks = scores
    say(f"query-align-{name}", reads=nreads,
        seconds=round(res.time_ms / 1000, 3),
        seconds_per_read=round(res.time_ms / 1000 / nreads, 3),
        alignment_blocks=len(blocks),
        share_aligned_to_true_genome=round(true / len(blocks), 4),
        share_aligned_to_true_species=round(same_species / len(blocks), 4),
        mean_score=round(float(np.mean(scores)), 2),
        lines_equal_nonfused=True)
    return runner


def run_repl(tmp, name, db, nreads, runner):
    """[repl-944mbp]: the query mode without read files (the interactive
    mode), fed two lines on a patched stdin, `<reads> -tophits` and
    `<reads> -lowest species`; its mapping lines equal the two direct
    queries' lines (the first on ``runner``, run_covpct's; -lowest
    species stages its own: the runner takes its merge rank when it
    stages)."""
    from metacache_tpu_torch.cli.main import main as cli
    sub = os.path.join(tmp, name)
    src = os.path.join(sub, "reads_per_read.fa")
    path = os.path.join(sub, "reads_repl.fa")
    with open(src, "rb") as f, open(path, "wb") as g:
        for _ in range(2 * nreads):
            g.write(f.readline())
    lines = [["-tophits"], ["-lowest", "species"]]
    direct = []
    for i, args in enumerate(lines):
        got, _r, _res = query_lines(db, path, args,
                                    os.path.join(sub, f"repl_{i}.txt"),
                                    runner)
        del _r, _res
        runner = None
        direct += [l for l in got if "\t|\t" in l and not l.startswith("#")]
    torch.cuda.empty_cache()
    buf = io.StringIO()
    old = sys.stdin
    sys.stdin = io.StringIO("".join(f"{path} {' '.join(a)}\n"
                                    for a in lines))
    t0 = time.time()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli(["query", db])
    finally:
        sys.stdin = old
    secs = time.time() - t0
    torch.cuda.empty_cache()
    repl = [l + "\n" for l in buf.getvalue().splitlines()
            if "\t|\t" in l and not l.startswith("#")]
    if rc != 0 or repl != direct or len(repl) != 2 * nreads:
        raise AssertionError(f"REPL: rc {rc}, {len(repl)} lines, equal to "
                             f"the direct queries: {repl == direct}")
    say(f"repl-{name}", stdin_lines=len(lines), reads=nreads,
        mapping_lines=len(repl), seconds=round(secs, 3),
        lines_equal_direct=True)


def exchange_bytes(rows: int, wq: int, sketchlen: int, runs: int,
                   nt: int, pairs: bool) -> float:
    """Bytes one position receives in the slot exchange of a data group
    of ``rows`` rows: from each of the other P - 1 shards its (rows / P,
    Wq * s * runs) int32 slots, two lanes a slot for (tgt, win) pairs;
    the grid moves P times as much a data group."""
    return rows * wq * sketchlen * runs * 4 * (nt - 1) / nt * \
        (2 if pairs else 1)


def run_shards(tmp, name, db, hist, lines, base_profile):
    """[query-shards-944mbp-t4]: -table-shards 4 on a grid of cuda:0
    repeated four times (and on four distinct cards where the host has
    them): the database cut into four feature ranges, staged two-tier
    (buckets deeper than 61 slots); the summary's 2^20 reads through the
    sharded steps (B1 on each position's quarter of a batch, B6 heads,
    the exchange, B4; the flagged reads redone through B7 and B4), the
    unsharded histogram; a profile of the first GRID_PROFILE_READS
    against the unsharded one of the same reads (``base_profile``); the
    per-read phase's 2^16 reads, byte-identical to the unsharded
    ``lines``. -> the launches of the repeated-card grid's summary."""
    from metacache_tpu_torch import kernels
    sub = os.path.join(tmp, name)
    grids = [("cuda:0x4", [torch.device("cuda", 0)] * SHARDS)]
    if torch.cuda.device_count() >= SHARDS:
        grids.append(("cuda:0-3", [torch.device("cuda", i)
                                   for i in range(SHARDS)]))
    launches = None
    for label, devs in grids:
        kernels.reset_counts()
        runner, res, stage_s = _query(
            db, os.path.join(sub, "reads.fa"),
            ["-no-map", "-table-shards", str(SHARDS)], io.StringIO(),
            devices=devs)
        grew = launch_counts()
        launches = launches or grew
        st = runner._shards
        n = res.statistics.total()
        if runner._ntab != SHARDS or not st.slot_bits or \
                st.head_slots != min(61, st.slots_per_feature - 1):
            raise AssertionError(f"shards: layout {runner.layout}")
        if not np.array_equal(res.statistics.assigned_, hist):
            raise AssertionError("-table-shards changed the rank histogram")
        if min(grew[k] for k in ("sketch", "bucket_decode", "head_decode",
                                 "full_decode", "candidates",
                                 "classify_lca")) <= 0:
            raise AssertionError(f"-table-shards launches {grew}")
        batch = runner.opt.batch_windows
        say(f"query-shards-{name}-t{SHARDS}", grid=label, reads=n,
            reads_per_min=round(n / (res.time_ms / 60000.0)),
            seconds=round(res.time_ms / 1000, 3), histogram_equal=True,
            escalated_reads=runner.esc_reads, layout=runner.layout.replace(
                " ", ""), staging_seconds=round(stage_s, 3),
            shard_gib=[round(b / 2**30, 3) for b in st.shard_bytes],
            shard_seconds=[round(x, 3) for x in st.shard_seconds],
            shard_features=[len(f) for f in st.features],
            batch_rows=batch, exchange_bytes_a_position_summary_batch=round(
                exchange_bytes(batch, 1, 16, 64, SHARDS, False)),
            max_allocated_gib=round(torch.cuda.max_memory_allocated() /
                                    2**30, 3), launches=grew)
        prof = phase_profile(tmp, name, runner, f"-shards{SHARDS}-{label}",
                             reads="reads_grid_profile.fa")
        say(f"grid-vs-unsharded-{name}", grid=label, reads=GRID_PROFILE_READS,
            wall_seconds=round(prof["wall_seconds"], 3),
            unsharded_wall_seconds=round(base_profile["wall_seconds"], 3),
            device_busy_seconds=round(prof["device_busy_seconds"], 3),
            unsharded_device_busy_seconds=round(
                base_profile["device_busy_seconds"], 3))
        out_path = os.path.join(sub, f"mapping_shards_{label}.txt")
        with open(out_path, "w") as out:
            _r, res2, _s = _query(db, os.path.join(sub, "reads_per_read.fa"),
                                  ["-table-shards", str(SHARDS)], out,
                                  runner=runner)
        got = mapping_lines(out_path)
        if got != lines:
            raise AssertionError("-table-shards changed the mapping lines")
        say(f"query-per-read-{name}-shards{SHARDS}", grid=label,
            reads=len(got), seconds=round(res2.time_ms / 1000, 3),
            lines_equal=True, exchange_bytes_a_position_batch=round(
                exchange_bytes(len(got), 1, 16, 256, SHARDS, False)),
            max_allocated_gib=round(torch.cuda.max_memory_allocated() /
                                    2**30, 3))
        del runner, _r
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return launches


def run_replicate(tmp, name, db, lines):
    """[query-replicate-944mbp-r2]: -replicate 2 over cuda:0 repeated:
    the two replicas share one staged copy of the tables, each classifies
    half of every batch (B1 and B4 on its rows); the per-read phase's
    2^16 reads, byte-identical to the unsharded lines."""
    sub = os.path.join(tmp, name)
    out_path = os.path.join(sub, "mapping_replicate.txt")
    with open(out_path, "w") as out:
        runner, res, stage_s = _query(
            db, os.path.join(sub, "reads_per_read.fa"),
            ["-replicate", str(REPLICAS)], out,
            devices=[torch.device("cuda", 0)] * REPLICAS)
    got = mapping_lines(out_path)
    shared = all(parts[0] is runner._replicas[0][1][0]
                 for _d, parts in runner._replicas)
    if runner._nrep != REPLICAS or not shared or got != lines:
        raise AssertionError(f"-replicate: {runner._nrep} replicas, one "
                             f"copy {shared}, lines equal {got == lines}")
    say(f"query-replicate-{name}-r{REPLICAS}", reads=len(got),
        seconds=round(res.time_ms / 1000, 3), lines_equal=True,
        one_staged_copy=shared, layout=runner.layout,
        staged_gib=round(runner.staged_bytes / 2**30, 3),
        staging_seconds=round(stage_s, 3))
    del runner
    torch.cuda.empty_cache()


def run_multihost():
    """[multihost-2proc]: two processes of the dryrun worker
    (metacache_tpu_torch/parallel/multihost_dryrun.py) on the card,
    joined by gloo, two positions of cuda:0 each: each runs the sharded
    step over its rows of one global batch and holds them against the
    single-device step; both must print MULTIHOST_OK."""
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root)
    env.pop("MC_TORCH_DEVICE", None)
    t0 = time.time()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "metacache_tpu_torch.parallel.multihost_dryrun",
         "--coordinator", f"localhost:{port}", "--nprocs", "2", "--pid",
         str(pid), "--local-devices", "2"], cwd=root, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    oks = [l for out, _e in outs for l in out.splitlines()
           if l.startswith("MULTIHOST_OK")]
    if any(p.returncode for p in procs) or len(oks) != 2:
        raise AssertionError("multihost dryrun failed: " + " | ".join(
            f"rc {p.returncode}: {out[-500:]} {err[-1500:]}"
            for p, (out, err) in zip(procs, outs)))
    say("multihost-2proc", processes=2, seconds=round(time.time() - t0, 3),
        lines=oks)


def k18_build_job(tmp, genomes, species) -> dict:
    """The 944 Mbp genomes and their taxonomy written for `build
    -kmerlen 18` (run_k18) -> that build as a job of ``Background``."""
    sub = os.path.join(tmp, "944mbp-k18")
    os.makedirs(sub)
    fa, tax = write_reference(sub, genomes, species)
    return {"args": ["build", os.path.join(sub, "db"), fa, "-taxonomy",
                     tax, "-kmerlen", "18"]}


def run_k18(tmp, genomes, built, profile):
    """The 944 Mbp genomes at k = 18, the repo's 64-bit configuration
    (tests/test_golden_parity.py:346-352). [build-944mbp-k18]: `build
    -kmerlen 18` (``built``: that job's result, ``k18_build_job``), the
    host table build (JAX's device builder is 32-bit only) with the
    sketches taken on the card by the 64-bit sketch kernel; the bucket
    index's bits and widest span.
    [query-summary-944mbp-k18]: 2^20 reads, -no-map, the main path of the
    64-bit sketch kernel (the runner's packed rows) and B4 on the u64
    dense rows; one stack against the plain path on CPU tensors. Per
    read: 2^14 reads with -tophits and 2^14 pairs with -pairfiles
    -tophits, byte-identical under MC_FUSED_CANDIDATES=0.
    [staging-944mbp-k18-two-tier]: a budget below the u64 dense rows
    (MC_HBM_GB) stages u64 two-tier rows, queried at full depth (JAX
    escalates no u64 rows): the same rank histogram.
    [staging-944mbp-k18-csr]: MC_DEVICE_LAYOUT=0 stages the u64 CSR
    layout, as JAX's runner does, the same rank histogram through the
    search and csr_decode (run_csr). -> the summary query's launches."""
    from metacache_tpu_torch.ops.probe import collision_free_bits64
    name = "944mbp-k18"
    sub = os.path.join(tmp, name)
    db = os.path.join(sub, "db")
    launched = built["launches"]
    if launched.get("sketch64", 0) <= 0 or launched.get("sketch") or \
            launched.get("sketch_long"):
        raise AssertionError(f"build -kmerlen 18 launches {launched}")
    os.remove(os.path.join(sub, "genomes.fa"))
    p = Database.load(db).parts[0]
    # make_bucket_index64's default width; a low-32 collision within a
    # bucket there is where JAX takes its CSR probe and the port's staging
    # widens the index (ops/table_device.py::device_layout_from_csr)
    default_bits = min(24, max(12, p.num_features.bit_length() - 2))
    free_bits = collision_free_bits64(p.unique_features)
    say(f"build-{name}", genomes=len(genomes), kmerlen=18,
        features=p.num_features, locations=p.num_locations,
        max_bucket=p.max_bucket_size, seconds=built["seconds"],
        sketch64_launches=launched["sketch64"],
        default_bucket_bits=default_bits,
        low32_collision_at_default_bits=free_bits > default_bits,
        collision_free_bits=free_bits)
    del p
    reads = sample_reads(np.random.default_rng(7), genomes, 1 << 20)
    runner, grew, res = phase_query_summary(
        tmp, name, db, reads,
        lambda r: r.layout.startswith("u64pk") and r.tables.wide,
        path_of("sketch64", DENSE, *cand_kernels()))
    hist = res.statistics.assigned_.copy()
    dense_b = runner.dense_bytes
    brows = runner.tables.bucket_rows
    say(f"staging-{name}", layout=runner.layout,
        bucket_bits=runner.tables.bucket_bits,
        bucket_index_gib=round(brows.numel() * 4 / 2**30, 3),
        bucket_max_span=int((brows[:, 1:] != -1).sum(dim=1).max()),
        staged_gib=round(runner.tables.nbytes() / 2**30, 3),
        dense_gib=round(dense_b / 2**30, 3),
        budget_gib=round(runner.budget_bytes / 2**30, 3),
        staging_seconds=round(runner.stage_s, 3))
    if profile:
        phase_profile(tmp, name, runner)
    phase_e2e(name, runner, reads)
    torch.cuda.empty_cache()
    path = os.path.join(sub, "reads_per_read.fa")
    write_reads(path, reads[:K18_PER_READ])
    m1, m2 = sample_pairs(np.random.default_rng(17), genomes, K18_PER_READ)
    pair = [os.path.join(sub, f) for f in write_pairs(sub, "pairs", m1, m2)]
    runs, out = {}, {}
    # the summary's staged tables serve every per-read query: the runner
    # reads MC_FUSED_CANDIDATES when it stages, so the non-fused queries
    # set its flag instead of staging again (the widened u64 index takes
    # about 30 s)
    for tag, fused in (("", True), ("-nonfused", False)):
        runner._fused_candidates = fused
        for kind, paths, args in (("reads", path, ["-tophits"]),
                                  ("pairs", pair, ["-pairfiles",
                                                   "-tophits"])):
            got, runner, r = query_lines(
                db, paths, args, os.path.join(sub, f"{kind}{tag}.txt"),
                runner)
            out[kind + tag] = [l for l in got if not l.startswith("#")]
            runs[kind + tag] = dict(per_min=round(
                r.statistics.total() / (r.time_ms / 60000.0)),
                seconds=round(r.time_ms / 1000, 3))
    del runner
    torch.cuda.empty_cache()
    for kind in ("reads", "pairs"):
        if out[kind] != out[kind + "-nonfused"] or \
                len(out[kind]) != K18_PER_READ:
            raise AssertionError(f"k18 {kind}: {len(out[kind])} lines, "
                                 f"equal under MC_FUSED_CANDIDATES=0: "
                                 f"{out[kind] == out[kind + '-nonfused']}")
    say(f"query-per-read-{name}", reads=K18_PER_READ,
        pairs=K18_PER_READ, lines_equal_nonfused=True, runs=runs)
    # a total whose budget (total less max(2 GiB, 20%)) holds 75% of the
    # u64 dense rows beside the bucket index, which the budget counts:
    # the builder takes two-tier rows
    index_b = brows.numel() * 4
    total_gib = (0.75 * dense_b + index_b) / 0.8 / 2**30
    with environ(MC_HBM_GB=f"{total_gib:.3f}"):
        runner, grew2, res2 = phase_query_summary(
            tmp, name, db, len(reads),
            lambda r: r.layout.startswith("('u64_two_tier'"),
            path_of("sketch64", DENSE, *cand_kernels()))
    if not np.array_equal(res2.statistics.assigned_, hist):
        raise AssertionError("u64 two-tier: the rank histogram differs")
    if runner.staged_bytes > runner.budget_bytes:
        raise AssertionError(f"u64 two-tier: {runner.staged_bytes} bytes "
                             f"staged, budget {runner.budget_bytes}")
    say(f"staging-{name}-two-tier", layout=runner.layout,
        staged_gib=round(runner.tables.nbytes() / 2**30, 3),
        layout_gib_with_index=round(runner.staged_bytes / 2**30, 3),
        bucket_index_gib=round(index_b / 2**30, 3),
        budget_gib=round(runner.budget_bytes / 2**30, 3),
        staging_seconds=round(runner.stage_s, 3), escalated_reads=0,
        histogram_equal=True)
    del runner
    torch.cuda.empty_cache()
    # MC_DEVICE_LAYOUT=0: the u64 CSR layout, as JAX's runner stages it
    # (runner.py:530-540), searched by its sign-flipped features
    run_csr(tmp, name, db, hist, ("sketch64", *cand_kernels()),
            {"MC_DEVICE_LAYOUT": "0"})
    shutil.rmtree(sub)
    return grew


def run_pairs(tmp, name, db, genomes, npairs, layout, expect, profile,
              runner=None):
    """[query-pair-<name>]: ``npairs`` read pairs of 2 x 100 bp
    (``sample_pairs``) on the summary path (-pairfiles -no-map; the main
    path of this database's kernels at two windows a query: counts zeroed
    just before it, read just after; on ``runner``'s staged tables where
    one is given), its profile, one stack against the plain path on CPU
    tensors. -> (runner, launches, results, mates)."""
    sub = os.path.join(tmp, name)
    t0 = time.time()
    m1, m2 = sample_pairs(np.random.default_rng(17), genomes, npairs)
    files = write_pairs(sub, "pairs", m1, m2)
    say(f"pairs-{name}", pairs=npairs, mate_bp=READ_LEN,
        fragment_bp="normal(300, 30) clipped to 200-500 (assumed)",
        data_gen_seconds=round(time.time() - t0, 3))
    runner, grew, res = phase_query_summary(
        tmp, name, db, npairs, layout, expect,
        pairs=[os.path.join(sub, f) for f in files], runner=runner)
    if profile:
        phase_profile(tmp, name, runner, "-pairs", reads=files)
    return runner, grew, res, (m1, m2)


def run_pairs_944(tmp, db, genomes, layout, profile, runner, cpu):
    """[query-pair-944mbp]: 2^20 pairs on the summary path through B1 and
    B4 (rows of 2 x 16 x 256 slots, runs of 256, the dedup sweep), one
    stack against the plain path, then 2^16 of them per read (-tophits,
    -insertsize 500, -pairseq, MC_FUSED_CANDIDATES=0); on the single
    reads' ``runner`` and the CPU copy ``cpu`` of its tables (run_config).
    -> the summary's launches."""
    name = "944mbp"
    runner, grew, res, (m1, m2) = run_pairs(
        tmp, name, db, genomes, PAIRS, layout,
        path_of("sketch", DENSE, *cand_kernels()), profile, runner)
    phase_e2e_pairs(name, runner, m1, m2, SCAN_BATCH, cpu=cpu)
    del cpu
    sub = os.path.join(tmp, name)
    files = write_pairs(sub, "pairs_sub", m1[:PAIRS_PER_READ],
                        m2[:PAIRS_PER_READ], interleaved=True)
    phase_pairs_per_read(tmp, name, db, files, runner,
                         ("summary", "insertsize", "pairseq", "nonfused"))
    del runner
    torch.cuda.empty_cache()
    return grew


def run_pairs_many_target(tmp, db, genomes):
    """[query-pair-many-target]: 2^16 pairs on the summary path through
    B1 and B5 ((tgt, win) pairs: the slots do not pack), 2048 of them
    against the plain path, and per read, again under
    MC_FUSED_CANDIDATES=0 with byte-identical lines. -> the summary's
    launches."""
    name = "many-target"
    runner, grew, res, (m1, m2) = run_pairs(
        tmp, name, db, genomes, PAIRS_PER_READ, "True",
        path_of("sketch", DENSE, "candidates_unpacked"), False)
    phase_e2e_pairs(name, runner, m1, m2, 2048)
    phase_pairs_per_read(tmp, name, db, write_pairs(
        os.path.join(tmp, name), "pairs", m1, m2), runner,
        ("summary", "nonfused"))
    del runner
    torch.cuda.empty_cache()
    return grew


def run_pairs_two_tier(tmp, name, db, m1, m2, layout, runner, profile):
    """[query-pair-1456mbp-two-tier]: 2^20 pairs escalated (phase 1
    through B1, B6 and B4 at two windows a query, the redo of the flagged
    pairs through B7 and B4) on ``runner``'s staged tables (the single
    reads'), the escalated share and the same histogram under
    MC_ESCALATE=0 (B7 on every batch); ``run_two_tier`` holds one
    stack's phase 1 and redo against the plain path. -> the escalated
    query's launches."""
    sub = os.path.join(tmp, name)
    files = write_pairs(sub, "pairs", m1, m2)
    paths = [os.path.join(sub, f) for f in files]
    done, esc0 = len(runner.redo_dispatches), runner.esc_reads

    def escalated(r, batches):
        return escalated_launches(r.redo_dispatches[done:], batches)
    runner, grew, res = phase_query_summary(tmp, name, db, len(m1), layout,
                                            escalated, pairs=paths,
                                            runner=runner)
    esc = runner.esc_reads - esc0
    if not (runner._escalation_ok(wq=2) and 0 < esc < len(m1)):
        raise AssertionError(f"pairs escalated {esc} of {len(m1)}")
    if profile:
        phase_profile(tmp, name, runner, "-pairs", reads=files)
    with environ(MC_ESCALATE="0"):
        from metacache_tpu_torch import kernels
        kernels.reset_counts()
        runner, res0, _s = _query(db, paths, ["-pairfiles", "-no-map"],
                                  io.StringIO(), runner)
        full = launch_counts()
    if not np.array_equal(res0.statistics.assigned_,
                          res.statistics.assigned_):
        raise AssertionError("MC_ESCALATE=0 changed the pairs' histogram")
    if full != path_of("sketch", "full_decode", *cand_kernels())(
            runner, -(-len(m1) // SCAN_BATCH)):
        raise AssertionError(f"full-depth pair launches {full}")
    # without the prefetched scan, pairs keep no phase-1 sketches to redo
    # from, so they do not escalate (JAX's runner.py:1172-1177)
    with environ(MC_PREFETCH="0"):
        from metacache_tpu_torch import kernels
        kernels.reset_counts()
        before = runner.esc_reads
        runner, res1, _s = _query(db, paths, ["-pairfiles", "-no-map"],
                                  io.StringIO(), runner)
        unpiped = launch_counts()
    if runner.esc_reads != before or unpiped != full or not np.array_equal(
            res1.statistics.assigned_, res.statistics.assigned_):
        raise AssertionError(f"MC_PREFETCH=0 pairs: escalated "
                             f"{runner.esc_reads - before}, launches "
                             f"{unpiped}")
    say(f"escalation-pair-{name}", pairs=len(m1), escalated_pairs=esc,
        escalated_share=round(esc / len(m1), 6),
        redo_batches=grew["full_decode"], launches=grew,
        full_depth_pairs_per_min=round(res0.statistics.total() /
                                       (res0.time_ms / 60000.0)),
        full_depth_launches=full, histogram_equal=True,
        prefetch_off_escalated_pairs=0,
        prefetch_off_pairs_per_min=round(res1.statistics.total() /
                                         (res1.time_ms / 60000.0)))
    del runner
    torch.cuda.empty_cache()
    return grew


def run_multipart(tmp, db, genomes):
    """[query-multipart-944mbp]: the 944 Mbp genomes built with `build
    -parts 2` (the host build): each part's layout, GiB and the staging
    seconds; 2^16 single reads and 2^16 pairs per read with -tophits
    (the multi-part step: B1 once, every part probed, B4 on the
    concatenated rows, which it sorts itself), again under
    MC_FUSED_CANDIDATES=0 with byte-identical lines; one batch of 8192
    reads against the same step on CPU tensors of both parts, all nine
    QueryResult fields (``multipart_card_vs_cpu``). -> the launches of
    the two default queries."""
    from metacache_tpu_torch import kernels
    name = "944mbp-parts2"
    sub = os.path.join(tmp, name)
    os.makedirs(sub)
    reads = sample_reads(np.random.default_rng(7), genomes, PAIRS_PER_READ)
    write_reads(os.path.join(sub, "reads.fa"), reads)
    m1, m2 = sample_pairs(np.random.default_rng(17), genomes,
                          PAIRS_PER_READ)
    pair = [os.path.join(sub, f) for f in write_pairs(sub, "pairs", m1, m2)]
    d = Database.load(db)
    lines, grew, routes, runner = {}, collections.Counter(), {}, None
    for tag in ("", "-nonfused"):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if tag:
            # MC_FUSED_CANDIDATES=0 on the same staged tables (nonfused)
            runner._fused_candidates = False
        for kind, paths, args in (
                ("reads", os.path.join(sub, "reads.fa"), ["-tophits"]),
                ("pairs", pair, ["-pairfiles", "-tophits"])):
            out_path = os.path.join(sub, f"{kind}{tag}.txt")
            stats: list = []
            kernels.reset_counts()
            restore = route_spy(stats)
            try:
                with open(out_path, "w") as out:
                    runner, res, stage_s = _query(d, paths, args, out,
                                                  runner)
            finally:
                restore()
            lines[kind + tag] = mapping_lines(out_path)
            if len(lines[kind + tag]) != PAIRS_PER_READ:
                raise AssertionError(f"{kind}{tag}: "
                                     f"{len(lines[kind + tag])} lines")
            counts = launch_counts()
            fused = sum(x["fused"] for x in stats)
            if counts["classify_lca"] != len(stats):
                raise AssertionError(f"{kind}{tag}: classify_lca "
                                     f"{counts['classify_lca']}, "
                                     f"{len(stats)} steps")
            if tag == "":
                grew.update(counts)
                if counts["sketch"] != len(stats) or \
                        counts["candidates"] != fused or not fused:
                    raise AssertionError(f"{kind}: launches {counts}, "
                                         f"routes {stats}")
            elif fused or counts["candidates"]:
                raise AssertionError(f"{kind}{tag} fused {fused}")
            if kind == "reads":
                parts = [dict(layout=str(t.dense).replace(" ", ""),
                              spf=t.spf, features=t.num_features,
                              gib=round(t.nbytes() / 2**30, 3))
                         for t in runner.parts]
                # the peak of the staging and of this 2^16-read query
                say(f"staging-{name}{tag}", parts=parts,
                    staging_seconds=round(stage_s, 3),
                    budget_gib=round(runner.budget_bytes / 2**30, 3),
                    max_allocated_gib=round(
                        torch.cuda.max_memory_allocated() / 2**30, 3))
            routes[kind + tag] = dict(
                per_min=round(res.statistics.total() /
                              (res.time_ms / 60000.0)),
                batches=len(stats), fused_batches=fused,
                widths=sorted({x["width"] for x in stats}),
                sweeps=dict(collections.Counter(x["sweep"]
                                                for x in stats)),
                launches={k: v for k, v in counts.items() if v})
        if tag == "":
            err, classified = multipart_card_vs_cpu(runner, reads)
        else:
            ballast_query(sub, name, runner, os.path.join(sub, "reads.fa"),
                          lines["reads-nonfused"])
    del runner
    torch.cuda.empty_cache()
    for kind in ("reads", "pairs"):
        if lines[kind] != lines[kind + "-nonfused"]:
            diff = sum(x != y for x, y in zip(lines[kind],
                                              lines[kind + "-nonfused"]))
            raise AssertionError(f"MC_FUSED_CANDIDATES=0 changed {diff} "
                                 f"{kind} lines")
    say("query-multipart-944mbp", parts=2, routes=routes,
        lines_equal_nonfused=True, card_vs_cpu_reads=SCAN_BATCH,
        card_vs_cpu_nonfused_reads=512, fields=9, tolerance=0,
        max_abs_err=err, classified=classified)
    return dict(grew)


def ballast_query(sub, name, runner, reads, want,
                  dev=torch.device("cuda")):
    """[nonfused-ballast-...]: the same non-fused per-read query once more
    on the runner's tables with a ballast tensor that leaves about 12 GiB
    of the card free: its 2^16-read batch must go in several launches
    (classify/runner.py::_nonfused_rows) and give the same lines. Then
    the first ALLHITS_READS reads with -allhits -tophits (per-hit lists
    kept for every slot, moved to the host launch by launch), once
    without the ballast and once beside it: several launches, the same
    lines."""
    from metacache_tpu_torch.device import free_bytes
    path = os.path.join(sub, "reads_allhits.fa")
    with open(reads, "rb") as f, open(path, "wb") as g:
        for _ in range(2 * ALLHITS_READS):
            g.write(f.readline())
    allhits = ["-allhits", "-tophits"]
    with environ(MC_FUSED_CANDIDATES="0"), \
            open(os.path.join(sub, "allhits.txt"), "w") as out:
        before = runner.row_launches
        _query(None, path, allhits, out, runner)
        alone = runner.row_launches - before
    want_all = mapping_lines(os.path.join(sub, "allhits.txt"))
    torch.cuda.empty_cache()
    keep = 12 << 30
    ballast = torch.empty(max(free_bytes(dev) - keep, 0), dtype=torch.uint8,
                          device=dev)
    free = free_bytes(dev)
    tables_b = sum(t.nbytes() for t in runner.parts)
    slots = 16 * sum(t.spf for t in runner.parts)
    runs = {}
    # the rows of a launch, as the runner sizes them
    sized = []
    real = runner._nonfused_rows
    runner._nonfused_rows = lambda *a: sized.append(real(*a)) or sized[-1]
    for tag, src, args, expect in (("tophits", reads, ["-tophits"], want),
                                   ("allhits", path, allhits, want_all)):
        torch.cuda.reset_peak_memory_stats()
        before = runner.row_launches
        sized.clear()
        out_path = os.path.join(sub, f"reads-ballast-{tag}.txt")
        with environ(MC_FUSED_CANDIDATES="0"), open(out_path, "w") as out:
            _query(None, src, args, out, runner)
        launches = runner.row_launches - before
        peak = torch.cuda.max_memory_allocated()
        got = mapping_lines(out_path)
        if got != expect or launches < 2:
            raise AssertionError(f"ballast {tag}: {launches} launches, "
                                 f"lines equal: {got == expect}")
        rows = min(len(got), max(sized))
        runs[tag] = dict(
            reads=len(got), launches=launches, rows_a_launch=rows,
            work_bytes_a_slot=round((peak - ballast.numel() - tables_b) /
                                    (rows * slots), 2),
            peak_allocated_gib=round(peak / 2**30, 3),
            peak_above_ballast_gib=round((peak - ballast.numel()) / 2**30,
                                         3))
    del runner._nonfused_rows
    ballast_b = ballast.numel()
    del ballast
    torch.cuda.empty_cache()
    say(f"nonfused-ballast-{name}", slots_a_row=slots,
        ballast_gib=round(ballast_b / 2**30, 3),
        free_gib_at_query=round(free / 2**30, 3),
        allhits_launches_without_ballast=alone, runs=runs, lines_equal=True)


def multipart_card_vs_cpu(runner, reads):
    """One batch of 8192 reads through query_step_rows_multipart on the
    card and on CPU tensors of both parts: all nine QueryResult fields;
    and its first 512 reads with -maxcand 8 (the non-fused path, with
    its per-hit lists). -> (max abs err, reads classified)."""
    from metacache_tpu_torch.ops import rows as R
    b = SCAN_BATCH
    codes = np.full((b, 1, 127), 4, np.uint8)
    codes[:, 0, :READ_LEN] = reads[:b]
    host = [torch.from_numpy(codes),
            torch.full((b, 1), READ_LEN, dtype=torch.int32),
            torch.full((b,), 2 + READ_LEN // runner.db.sketching.winstride,
                       dtype=torch.int32)]
    kw = dict(k=16, sketchlen=16, windows_per_query=1, max_candidates=2,
              walk_elems=32, fast_top2=True, pack_bits=runner._pack_bits)
    args = (runner.hits_min, 1.0, runner.highest_rank, runner.merge_rank)
    got = R.query_step_rows_multipart(*(x.cuda() for x in host),
                                      runner.parts, *args, **kw)
    cpu = [p.cpu_copy() for p in runner.parts]
    want = R.query_step_rows_multipart(*host, cpu, *args, **kw)
    if len(want._fields) != 9:
        raise AssertionError(f"fields {want._fields}")
    err = max(check_equal(f"multipart {f}", getattr(got, f).cpu(),
                          getattr(want, f)) for f in want._fields)
    kw8 = dict(kw, max_candidates=8, fast_top2=False, emit_hits=True)
    got8 = R.query_step_rows_multipart(*(x[:512].cuda() for x in host),
                                       runner.parts, *args, **kw8)
    want8 = R.query_step_rows_multipart(*(x[:512] for x in host), cpu,
                                        *args, **kw8)
    if not (want8.hit_qid < 512).any():
        raise AssertionError("the non-fused step listed no hits")
    err = max([err] + [check_equal(f"multipart -maxcand 8 {f}",
                                   getattr(got8, f).cpu(), getattr(want8, f))
                       for f in want8._fields])
    return err, int((got.cls_tax != 0).sum())


def phase_fused_crossover(rng, dev):
    """rows_to_result on 8192 unsorted packed rows (walk 32, 2
    candidates): the fused kernel (B4) against the non-fused torch path
    at the widths around the JAX runner's FUSED_MIN_SLOTS (1024), timed
    in turns, with equal results."""
    from metacache_tpu_torch.ops import rows as R
    ntgt = 1024                  # slot_rows draws targets below 952
    mt = -torch.arange(1, ntgt + 1, dtype=torch.int32, device=dev)
    lin = torch.zeros((ntgt, 21), dtype=torch.int32, device=dev)
    lin[:, 0] = mt
    lin[:, 20] = 1
    out = {}
    for l in (256, 1024, 4096):
        pk = torch.from_numpy(rng.permuted(slot_rows(rng, SCAN_BATCH, l),
                                           axis=1)).to(dev)
        mw = torch.full((SCAN_BATCH,), 2, dtype=torch.int32, device=dev)

        def run(fc, pk=pk, mw=mw):
            return R.rows_to_result(pk, pk, mw, mt, lin, 5, 1.0, 19, 0,
                                    max_candidates=2, walk_elems=32,
                                    fast_top2=True, fused_candidates=fc,
                                    pack_bits=15)
        fa, nf = run(True), run(False)
        for f in fa._fields[:6]:
            check_equal(f"fused vs non-fused {f} L={l}", getattr(fa, f),
                        getattr(nf, f))
        fms, nms, _r = turns(lambda: run(True), lambda: run(False))
        out[f"L{l}_fused_ms"] = fms
        out[f"L{l}_nonfused_ms"] = nms
    say("fused-crossover", rows=SCAN_BATCH, walk=32, candidates=2,
        results_equal=True, **out)


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
    ap.add_argument("--jobs", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if a.jobs:
        return run_jobs(a.jobs)
    from metacache_tpu_torch import kernels
    CARD = card_line()
    print(f"card: {CARD}", flush=True)
    results: dict = {}
    phase_kernels()
    phase_parity(results)
    phase_fused_crossover(np.random.default_rng(77), torch.device("cuda"))
    launches = {}
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".chip_smoke_") as tmp:
        try:
            run_configs(tmp, results, launches, a.profile)
        finally:
            stop_background()
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
    if min(r["launches"] for r in rows if r["name"] not in FOLDED) <= 0:
        raise AssertionError("a kernel of the main path never launched")
    if any(launches[k] or launches[v] <= 0 for k, v in FOLDED.items()):
        raise AssertionError("a folded kernel launched, or the kernel "
                             "that does its work did not")
    say("done", seconds=round(time.time() - T_START, 3))
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_configs(tmp, results, launches, profile):
    """The configurations in the scratch directory ``tmp``: each main
    path's launches go into ``launches``, the kernels measured on its
    tables into ``results``."""
    genomes, species, gen_s = generated(refseq_skew_genomes)
    db, maxwin = phase_build(tmp, "944mbp", genomes, species, gen_s,
                             keep_fasta=True)
    # the host builds run beside the queries up to run_long_reads, whose
    # routes follow the card's free memory
    sub = os.path.join(tmp, "944mbp")
    fa, tax = os.path.join(sub, "genomes"), os.path.join(sub, "taxonomy")
    db_parts = os.path.join(sub, "db_parts2")
    host = Background(tmp, "944mbp", [
        {"host_check": [fa, tax, db]},
        {"args": ["build", db_parts, fa, "-taxonomy", tax, "-parts", "2"]},
        k18_build_job(tmp, genomes, species)])
    layout = f"pk{(2 * maxwin).bit_length()}"
    if layout != "pk15":
        raise AssertionError(f"944 Mbp database packs as {layout}")
    keep = {}
    main_path, hist, stage_s, other = run_config(
        tmp, "944mbp", db, genomes, layout,
        ("sketch", DENSE, *cand_kernels()), profile, other_route=True,
        keep=keep, prefetch=True)
    for k in ("sketch", "candidates", DENSE, "bucket_decode", *TAIL):
        launches[k] = main_path[k]
    # B3 runs on whichever of the two routes splits
    launches["sort"] = main_path["sort"] or other["sort"]
    # the pairs on the single reads' staged tables and CPU copy
    pair_paths = [run_pairs_944(tmp, db, genomes, layout, profile,
                                keep.pop("runner"), keep.pop("cpu"))]
    torch.cuda.empty_cache()
    pair_paths.append(run_shards(tmp, "944mbp", db, hist, keep["lines"],
                                 keep["profile"]))
    run_replicate(tmp, "944mbp", db, keep["lines"])
    run_multihost()
    # one staging serves -cov-percentile, -align and the first REPL line
    run_repl(tmp, "944mbp", db, REPL_READS, run_align(
        tmp, "944mbp", db, genomes, species, ALIGN_READS,
        run_covpct(tmp, "944mbp", db)))
    classed = run_stagings(tmp, "944mbp", Database.load(db), hist,
                           stage_s, genomes, results, profile)
    for k in ("classed_bucket", "classed_decode"):
        launches[k] = classed[k]
    launches["csr_decode"] = run_csr_window(
        tmp, "944mbp", db, hist, ("sketch", *cand_kernels()),
        genomes=genomes, per_read=True)["csr_decode"]
    checked, parted, k18_built = host.wait()
    say("build-944mbp-host", host_build_seconds=checked["seconds"],
        host_build_equal=checked["host_build_equal"],
        parts2_build_seconds=parted["seconds"])
    shutil.rmtree(fa)
    long_path = run_long_reads(tmp, "944mbp", db, genomes, LONG_READS,
                               profile, "candidates", "candidates_wide",
                               ballast=True)
    launches["candidates_wide"] = long_path["candidates_wide"]
    pair_paths.append(run_multipart(tmp, db_parts, genomes))
    # the -winlen 255 builds run beside the k = 18 phases
    host = Background(tmp, "944mbp-w255",
                      long_window_jobs(tmp, genomes, species))
    k18 = run_k18(tmp, genomes, k18_built, profile)
    launches["sketch64"] = k18.pop("sketch64")
    pair_paths.append(k18)
    shutil.rmtree(os.path.join(tmp, "944mbp"))
    shutil.rmtree(os.path.join(tmp, "944mbp-parts2"))
    main_path = run_long_windows(tmp, genomes, host.wait(), profile)
    launches["sketch_long"] = main_path["sketch_long"]
    shutil.rmtree(os.path.join(tmp, "944mbp-w255"))
    del genomes, species

    genomes, species, gen_s = generated(many_target_genomes)
    db, maxwin = phase_build(tmp, "many-target", genomes, species, gen_s)
    if len(genomes) != 9217 or (2 * maxwin).bit_length() != 18:
        raise AssertionError(f"{len(genomes)} targets, max window {maxwin}")
    # slots do not pack: the dense layout of (tgt, win) lane pairs
    main_path, hist, _s, _o = run_config(
        tmp, "many-target", db, genomes, "True",
        ("sketch", DENSE, "candidates_unpacked"), profile)
    launches["candidates_unpacked"] = main_path["candidates_unpacked"]
    for k in (DENSE, "bucket_decode", *TAIL):
        launches[k] += main_path[k]
    phase_dense_limit(tmp, "many-target", db, hist)
    run_csr_window(tmp, "many-target", db, hist,
                   ("sketch", "candidates_unpacked"))
    long_path = run_long_reads(tmp, "many-target", db, genomes,
                               LONG_READS_MANY, False, "candidates_unpacked",
                               "candidates_unpacked_wide")
    launches["candidates_unpacked_wide"] = \
        long_path["candidates_unpacked_wide"]
    run_merge_many_target(tmp, db, genomes)
    pair_paths.append(run_pairs_many_target(tmp, db, genomes))
    shutil.rmtree(os.path.join(tmp, "many-target"))

    main_path, pallas, pairs = run_two_tier(tmp, profile)
    for k in ("head_decode", "full_decode"):
        launches[k] = main_path[k]
    for k in ("bucket_decode", *TAIL):
        launches[k] += main_path[k]
    launches["oidx_decode"] = pallas["oidx_decode"]
    pair_paths.append(pairs)
    # the sharded, paired and multi-part main paths' launches, each
    # counted from zero just before its own query
    for path in pair_paths:
        for k, v in path.items():
            launches[k] += v


if __name__ == "__main__":
    try:
        code = main()
    finally:
        stop_background()
    sys.exit(code)
