"""Trace the warm 944 Mbp summary query of checkouts of
metacache_tpu_torch on one CUDA card, in turns, with each trace's device
time by kernel; and time the step's tail (ranked LCA, candidate-taxon
lookup, rank histogram) alone on the summary's own inputs.

    mkdir -p chip_archive/parent
    git archive <rev> | tar -x -C chip_archive/parent
    python3 tools/torch_tail_profile.py chip_archive/parent . . \
        chip_archive/parent

Builds the 944 Mbp database (chip_smoke.refseq_skew_genomes, `build`
through this checkout's CLI) and writes 2^20 reads of 100 bp (seed 7),
as chip_smoke.py does, once. Then, for each checkout named, a process of
this script (``--trace``) imports that checkout's package, stages the
database, runs the summary query (-no-map) once, traces a second, warm
run with torch.profiler and prints its wall, the device's busy time,
its rank histogram, its kernel events, its kernels by device time with
their counts, the tail's device time a batch in the trace (lca_kernel
and rank_hist's kernels) and the gap from the end of the kernel before
each lca_kernel on its stream to that lca_kernel's start (from the
trace's timeline; negative where a programmatic dependent launch starts
it early).

A checkout with the classify_lca kernel (ops/pipeline.py::
classify_with_taxa) also keeps the first run's inputs of the tail, a
batch's candidates and a stack's classes, and
- traces the tail alone on them: the plain versions (the torch ops that
  ran the tail before the kernels, kept verbatim) against classify_lca
  and rank_hist, device time and kernels a batch, by kernel;
- times each kernel on the first batch and the first stack, and, in a
  checkout that has it, its launch floor (kernels.launch_floor: an empty
  kernel launched as the kernel is, on its grid), in turns (kernel,
  floor, floor, kernel): [device] time as a CUDA graph of 20 calls
  (chip_smoke.kernel_ms), CUDA-event time of 5 calls (cuda_ms), host
  microseconds a call (host_us).
Name the checkouts in turns (parent, change, change, parent) to compare
two builds in one call; a design kept only in another revision is
compared by unpacking that revision as a checkout. Prints the card's
name and power limit first; about a minute a checkout after the build.
"""
import io
import json
import os
import subprocess
import sys
import tempfile
import time


def _events(prof):
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _top(evs, n: int, div: float = 1.0):
    for e in sorted(evs, key=lambda e: -e.self_device_time_total)[:n]:
        print(f"  {e.self_device_time_total / 1e3 / div:10.4f} ms "
              f"{e.count / div:9.2f} x  {e.key[:90]}")


def _timeline(prof):
    """The trace's kernels, by stream, in time order: (name, start us,
    end us) from the exported Chrome trace."""
    with tempfile.NamedTemporaryFile(suffix=".json", delete=False) as f:
        path = f.name
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    streams = {}
    for e in trace.get("traceEvents", []):
        if e.get("cat") == "kernel" and "dur" in e:
            s = (e.get("args", {}).get("device"),
                 e.get("args", {}).get("stream"))
            streams.setdefault(s, []).append(
                (e["name"], float(e["ts"]), float(e["ts"]) + e["dur"]))
    return [sorted(v, key=lambda x: x[1]) for v in streams.values()]


def _tail_in_trace(prof, batches: int, stacks: int) -> dict:
    """The tail's kernels in a summary trace: lca_kernel's and
    rank_hist's device ms a batch and a stack, and the gap (us) from the
    end of the kernel before each lca_kernel on its stream to its
    start."""
    lca, hist, gaps, before = 0.0, 0.0, [], {}
    for ks in _timeline(prof):
        for i, (name, t0, t1) in enumerate(ks):
            if "lca_kernel" in name:
                lca += t1 - t0
                if i:
                    gaps.append(t0 - ks[i - 1][2])
                    prev = ks[i - 1][0].split("(")[0][:40]
                    before[prev] = before.get(prev, 0) + 1
            elif "rank_hist" in name:
                hist += t1 - t0
    gaps.sort()
    return dict(
        lca_device_ms_per_batch=round(lca / 1e3 / batches, 5),
        hist_device_ms_per_stack=round(hist / 1e3 / max(stacks, 1), 5),
        tail_device_ms_per_batch=round((lca + hist) / 1e3 / batches, 5),
        lca_gaps=len(gaps),
        gap_before_lca_us_median=round(gaps[len(gaps) // 2], 3)
        if gaps else None,
        gap_before_lca_us_mean=round(sum(gaps) / len(gaps), 3)
        if gaps else None,
        kernel_before_lca=before)


def _in_turns(cs, calls: dict) -> dict:
    """Each call's kernel_ms, cuda_ms and host_us, the calls timed in
    turns (a, b, ..., b, a), the two readings of each averaged. ``calls``:
    name -> function."""
    names = list(calls)
    got = {n: [] for n in names}
    for order in (names, names[::-1]):
        for n in order:
            fn = calls[n]
            got[n].append((cs.kernel_ms(fn), cs.cuda_ms(fn), cs.host_us(fn)))
    return {n: dict(kernel_ms=sum(r[0] for r in v) / 2,
                    event_ms=sum(r[1] for r in v) / 2,
                    host_us=sum(r[2] for r in v) / 2,
                    kernel_ms_readings=[r[0] for r in v])
            for n, v in got.items()}


def trace(root: str, db: str, reads: str) -> int:
    sys.path.insert(0, root)
    import chip_smoke as cs  # that checkout's (blocks JAX and its package)
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available() or \
            not cs.__file__.startswith(root + os.sep):
        print(__doc__, file=sys.stderr)
        return 1
    from metacache_tpu_torch import kernels
    from metacache_tpu_torch.classify import runner as run_mod
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.ops import pipeline as P
    from metacache_tpu_torch.ops import rows as R
    cs.CARD = cs.card_line()
    tail = hasattr(P, "classify_with_taxa")
    floor = hasattr(kernels, "launch_floor")
    kept = {"lca": [], "hist": []}
    if tail:
        real_lca, real_hist = R.classify_with_taxa, run_mod.rank_histogram

        def lca(*a):
            kept["lca"].append(tuple(x.clone() if torch.is_tensor(x) else x
                                     for x in a))
            return real_lca(*a)

        def hist(*a, **kw):
            kept["hist"].append((tuple(x.clone() if torch.is_tensor(x)
                                       else x for x in a),
                                 {k: None if v is None else v.clone()
                                  for k, v in kw.items()}))
            return real_hist(*a, **kw)
        R.classify_with_taxa, run_mod.rank_histogram = lca, hist
    runner, res0, stage_s = cs._query(db, reads, ["-no-map"], io.StringIO())
    if tail:
        R.classify_with_taxa, run_mod.rank_histogram = real_lca, real_hist
    res = ClassificationResults(io.StringIO(), io.StringIO(), io.StringIO())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run_mod.map_queries_to_targets([reads], runner.db, runner.opt, res,
                                       runner)
        torch.cuda.synchronize()
        wall = time.time() - t0
    evs = _events(prof)
    busy_us = sum(e.self_device_time_total for e in evs)
    batches = -(-res.statistics.total() // cs.SCAN_BATCH)
    if not (res.statistics.assigned_ == res0.statistics.assigned_).all():
        raise AssertionError("the warm query changed the rank histogram")
    cs.say("summary-profile", checkout=root, reads=res.statistics.total(),
           wall_seconds=round(wall, 4),
           device_busy_seconds=round(busy_us / 1e6, 5),
           device_idle_share=round(1 - busy_us / 1e6 / wall, 4),
           kernel_events=sum(e.count for e in evs),
           kernel_events_per_batch=round(
               sum(e.count for e in evs) / batches, 2),
           device_ms_per_batch=round(busy_us / 1e3 / batches, 5),
           staging_seconds=round(stage_s, 3),
           **_tail_in_trace(prof, batches, -(-batches // 32)),
           histogram=[int(x) for x in res.statistics.assigned_])
    print("  device ms a batch, kernels a batch, kernel:")
    _top(evs, 30, batches)
    if not tail:
        return 0
    # the tail alone on the first run's inputs: every batch's candidates
    # and every stack's classes, plain versions against the kernels
    calls = kept["lca"]
    stacks = kept["hist"]
    for form, lca_fn, hist_fn in (
            ("plain", P.classify_with_taxa_plain,
             run_mod.rank_histogram_plain),
            ("kernels", P.classify_with_taxa, run_mod.rank_histogram)):
        for a in calls[:2]:                  # warm-up
            lca_fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a in calls:
                lca_fn(*a)
            torch.cuda.synchronize()
        lev = _events(prof)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for a, kw in stacks:
                hist_fn(*a, **kw)
            torch.cuda.synchronize()
        hev = _events(prof)
        lus = sum(e.self_device_time_total for e in lev)
        hus = sum(e.self_device_time_total for e in hev)
        cs.say(f"tail-{form}", checkout=root, batches=len(calls),
               stacks=len(stacks),
               lca_device_ms_per_batch=round(lus / 1e3 / len(calls), 5),
               lca_kernels_per_batch=round(
                   sum(e.count for e in lev) / len(calls), 2),
               hist_device_ms_per_stack=round(
                   hus / 1e3 / max(len(stacks), 1), 5),
               hist_kernels_per_stack=round(
                   sum(e.count for e in hev) / max(len(stacks), 1), 2),
               tail_device_ms_per_batch=round(
                   (lus + hus) / 1e3 / len(calls), 5))
        print("  lookup + LCA, device ms a batch, kernels a batch:")
        _top(lev, 25, len(calls))
        print("  rank histogram, device ms a stack, kernels a stack:")
        _top(hev, 10, max(len(stacks), 1))
    # each kernel and its floor timed on the first batch and stack
    a, (ha, hkw) = calls[0], stacks[0]
    b, m = a[0].shape[0], ha[0].numel()
    lca_calls = {"lca": lambda: P.classify_with_taxa(*a)}
    hist_calls = {"hist": lambda: run_mod.rank_histogram(*ha, **hkw)}
    if floor:
        lca_calls["floor_lca"] = lambda: kernels.launch_floor(0, b)
        hist_calls["floor_hist"] = lambda: kernels.launch_floor(1, m)
    for what, timed in (("classify_lca", _in_turns(cs, lca_calls)),
                        ("rank_hist", _in_turns(cs, hist_calls))):
        for name, t in timed.items():
            cs.say("tail-ab", checkout=root, kernel=what, variant=name,
                   reads=b if what == "classify_lca" else m,
                   **{k: (round(v, 6) if isinstance(v, float) else
                          [round(x, 6) for x in v]) for k, v in t.items()})
    return 0


def main() -> int:
    if len(sys.argv) >= 2 and sys.argv[1] == "--trace":
        return trace(os.path.abspath(sys.argv[2]), sys.argv[3], sys.argv[4])
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, here)
    import chip_smoke as cs
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    with tempfile.TemporaryDirectory(dir=here, prefix=".tail_profile_") \
            as tmp:
        genomes, species, gen_s = cs.generated(cs.refseq_skew_genomes)
        db, _w, _p = cs.phase_build(tmp, "944mbp", genomes, species, gen_s)
        torch.cuda.empty_cache()
        reads = os.path.join(tmp, "944mbp", "reads.fa")
        cs.write_reads(reads, cs.sample_reads(np.random.default_rng(7),
                                              genomes, 1 << 20))
        del genomes, species
        for root in sys.argv[1:]:
            r = subprocess.run([sys.executable, os.path.abspath(__file__),
                                "--trace", os.path.abspath(root), db, reads],
                               cwd=os.path.abspath(root))
            if r.returncode != 0:
                return r.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
