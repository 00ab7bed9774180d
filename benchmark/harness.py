"""The benchmark of `metacache_tpu_torch`: one cell (a configuration
under a traffic mix) built, staged, queried for a window of seconds and
checked against the plain reference.

Everything that belongs to one configuration, mix, per-layer metric,
kernel or stage sits in a file of its own beside this one, found by the
name that BENCHMARK.json gives:

- ``configs/<config>.json``  the deployment (genomes, taxonomy,
  sketching, cap, classification options, environment of the program);
- ``traffic/<traffic>.json`` the read files (count, reads, lengths) and
  the query flags;
- ``metrics/<metric>.py``    a reader ``read(run) -> float | None``;
- ``kernels/<kernel>.json``  a kernel name's pattern and its stage;
- ``work/<stage>.py``        ``count(stats, cfg) -> {"bytes", "ops"}``,
  the least work of a stage, from the reference's own counts;
- ``peaks.json``             the device's peak rates by device name.

Set-up: genomes and taxonomy from the seed, the genomes as one FASTA
file, `build_database(..., device_tables=True)` (the `build+query`
route), one `QueryRunner`, the mix's read files, and one query of each
file. The program's kernels are built first and timed apart
(``compile_s``), since only a checkout's first run builds them. Window:
one closed-loop client calling `map_queries_to_targets` on the staged
runner, a file a call, cycling through the files, until the call that
crosses ``seconds`` returns. A summary mix's answer is its counts by
rank, which do not show which taxon a read went to; so after the window
a sample of its first file, drawn from the seed, is queried once with
per-read lines (the mix's ``sample``) on a runner staged from the same
database. Then the program's state is freed and the reference works out
every file's answer and the sample's lines again; each call's answer is
compared with its file's.

The FASTA file and the read files are anonymous memory files
(``memfd_create``) opened by their /proc/self/fd path, so that a run
writes no gigabytes to disk.
"""
from __future__ import annotations

import contextlib
import gc
import glob
import importlib.util
import io
import json
import os
import re
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

import gen  # noqa: E402
import devtrace  # noqa: E402
from reference import metacache as ref  # noqa: E402

#: top-level module names that may not be loaded in a run
FORBIDDEN = ("jax", "jaxlib", "flax", "metacache_tpu")


# ----------------------------------------------------------------- lookup
class Bench:
    """The manifest and the files it names, under ``root`` (the folder
    of this file, or a copy of it in a test)."""

    def __init__(self, manifest: dict, root: str = HERE):
        self.manifest = manifest
        self.root = root

    @classmethod
    def load(cls, path: str | None = None, root: str = HERE):
        path = path or os.path.join(os.path.dirname(root), "BENCHMARK.json")
        with open(path) as f:
            return cls(json.load(f), root)

    def workload(self, name: str) -> dict:
        for w in self.manifest["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in the manifest")

    def config(self, name: str) -> dict:
        for c in self.manifest["configs"]:
            if c["name"] == name:
                with open(os.path.join(os.path.dirname(self.root),
                                       c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in the manifest")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.root, "traffic", name + ".json")) as f:
            return json.load(f)

    def metric_readers(self, workload: str) -> dict:
        """name -> read(run) of each per-layer metric the cell reports."""
        out = {}
        for m in self.manifest["per_layer"]:
            if workload not in m.get("workloads", [workload]):
                continue
            out[m["name"]] = _module(os.path.join(
                self.root, "metrics", m["name"] + ".py")).read
        return out

    def kernel_stages(self) -> list:
        """[(compiled pattern, stage)] of every kernels/*.json, by name."""
        out = []
        for p in sorted(glob.glob(os.path.join(self.root, "kernels",
                                               "*.json"))):
            with open(p) as f:
                k = json.load(f)
            out.append((re.compile(k["pattern"]), k["stage"]))
        return out

    def work_counters(self) -> dict:
        """stage -> count(stats, cfg) of every work/*.py."""
        return {os.path.basename(p)[:-3]: _module(p).count
                for p in sorted(glob.glob(os.path.join(self.root, "work",
                                                       "*.py")))}

    def peaks(self, device_name: str) -> dict | None:
        with open(os.path.join(self.root, "peaks.json")) as f:
            return json.load(f).get(device_name)


def _module(path: str):
    name = "bench_" + re.sub(r"\W", "_", os.path.relpath(path, HERE))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stage_of(stages: list):
    """kernel name -> the stage of the first kernel file whose pattern
    it matches, or None."""
    def of(name: str):
        for pat, st in stages:
            if pat.search(name):
                return st
        return None
    return of


# ------------------------------------------------------------------ files
class MemFiles:
    """Anonymous memory files, each read through its /proc/self/fd path
    (re-openable and seekable like a file on disk)."""

    def __init__(self):
        self.fds: list = []

    def add(self, name: str, data: bytes) -> str:
        fd = os.memfd_create(name)
        self.fds.append(fd)
        view = memoryview(data)
        while view:
            view = view[os.write(fd, view):]
        return f"/proc/self/fd/{fd}"

    def close(self):
        for fd in self.fds:
            os.close(fd)
        self.fds = []


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def say(*a):
    print(*a, file=sys.stderr, flush=True)


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------- cell
def run_cell(bench: Bench, workload: str, seed: int, seconds: float,
             traced: bool, device="cuda", t_start: float | None = None,
             tmp_root: str | None = None) -> dict:
    """Set-up, window, reference and readings of one run -> the result
    object (without the check for forbidden modules)."""
    t_start = time.perf_counter() if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    for k, v in {**cfg.get("env", {}), **traffic.get("env", {})}.items():
        os.environ[k] = str(v)
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import (QueryRunner,
                                                     map_queries_to_targets)
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    from metacache_tpu_torch.config import SketchingOptions
    from metacache_tpu_torch.db.build import BuildOptions, build_database

    tmp = tempfile.mkdtemp(prefix="mcbench-", dir=tmp_root)
    mem = MemFiles()
    try:
        sk = cfg["sketching"]
        t0 = time.perf_counter()
        if cuda:
            from metacache_tpu_torch import kernels, native
            kernels.build()
            native.get_lib()
        compile_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        genomes, species, nodes = make_genomes(cfg, seed)
        tax_dir = os.path.join(tmp, "taxonomy")
        gen.write_taxonomy(tax_dir, nodes)
        fasta = mem.add("genomes.fa", gen.fasta_bytes(genomes, species))
        genomes_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        db = build_database(BuildOptions(
            infiles=[fasta], taxonomy_dir=tax_dir,
            sketching=SketchingOptions(sk["kmerlen"], sk["sketchlen"],
                                       sk["winlen"], sk["winstride"]),
            max_locations_per_feature=cfg["max_locations_per_feature"],
            device_tables=True))
        sync(device)
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated() if cuda else 0
        mem.close()                        # the FASTA is read

        opt, _out, _split = parse_query_options(
            Args(list(traffic["query_flags"])))
        t0 = time.perf_counter()
        runner = QueryRunner(db, opt)
        sync(device)
        stage_s = time.perf_counter() - t0
        staged_bytes = int(runner.staged_bytes)
        layout = runner.layout

        mapping = traffic["output"] == "mapping"

        def call(path, runner=runner, opt=opt, lines=mapping):
            out = io.StringIO()
            res = ClassificationResults(out, out, out)
            map_queries_to_targets([path], db, opt, res, runner)
            sync(device)
            return (res.statistics.assigned_.copy(),
                    out.getvalue() if lines else None)

        t0 = time.perf_counter()
        reads = make_reads(traffic, genomes, seed)
        paths = [mem.add(f"reads{j}.fa", gen.reads_fasta(codes, offs))
                 for j, (codes, offs) in enumerate(reads)]
        reads_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for p in paths:                    # warm-up: every file's shapes
            call(p)
        warm_s = time.perf_counter() - t0
        setup_s = time.perf_counter() - t_start

        win = window(call, paths, seconds, traced, cuda, tmp)
        sample, sample_text = None, None
        if not mapping and traffic.get("sample"):
            sample = sample_of(reads[0], traffic["sample"]["reads"], seed)
            sopt, _o, _s = parse_query_options(
                Args(list(traffic["sample"]["query_flags"])))
            srunner = QueryRunner(db, sopt)
            sample_text = call(mem.add("sample.fa", gen.reads_fasta(*sample)),
                               srunner, sopt, True)[1]
            del srunner
        mem.close()
        del runner, db
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        t0 = time.perf_counter()
        want = reference_answers(cfg, genomes, species, nodes,
                                 reads + ([sample] if sample else []),
                                 [mapping] * len(reads) + [True], device)
        ref_s = time.perf_counter() - t0
        answers = win["answers"]
        checks, failed = compare(answers, want, mapping)
        if sample is not None:
            checks.update(compare_sample(sample_text, want[-1]))
        nq = [len(o) - 1 for _c, o in reads]
        queries = sum(nq[j] for j, _a, _t in answers)
        result = {"correct": all(c["value"] <= c["limit"]
                                 for c in checks.values()),
                  "attempted": len(answers), "failed": failed}
        tr = win["trace"]
        if traced:
            run = {"queries": queries, "build_s": build_s,
                   "stage_s": stage_s, "staged_bytes": staged_bytes,
                   "trace": tr}
            result["metrics"] = per_layer(bench, workload, cfg, run, want,
                                          answers, device)
        else:
            result["metrics"] = {
                "queries_per_min": {"value": queries / win["seconds"] * 60,
                                    "unit": "queries/min"},
                "device_peak_gib": {"value": win["peak"] / 2**30,
                                    "unit": "GiB"},
                "setup_s": {"value": setup_s, "unit": "s"}}
        result["device"] = device_block(cuda, win["peak"], tr)
        if tr is not None:
            result["breakdown"] = devtrace.breakdown(
                tr, stage_of(bench.kernel_stages()))
        result["notes"] = {"setup_s": setup_s, "compile_s": compile_s,
                           "genomes_s": genomes_s,
                           "build_s": build_s, "stage_s": stage_s,
                           "reads_s": reads_s, "warm_s": warm_s,
                           "build_peak_bytes": build_peak,
                           "staged_bytes": staged_bytes, "layout": layout,
                           "window_s": win["seconds"], "reference_s": ref_s,
                           "calls": len(answers), "queries": queries,
                           "cpus": len(os.sched_getaffinity(0)),
                           "torch_threads": torch.get_num_threads(),
                           "call_s": win["call_s"],
                           "call_cpu_s": win["call_cpu_s"]}
        result["checks"] = checks
        return result
    finally:
        mem.close()
        shutil.rmtree(tmp, ignore_errors=True)


def window(call, paths, seconds: float, traced: bool, cuda: bool,
           tmp: str) -> dict:
    """The closed-loop client: ``call`` on each file in turn until the
    call that crosses ``seconds`` returns; traced, under torch.profiler
    and the Python sampler. -> answers [(file, counts, text)], seconds,
    each call's wall and CPU seconds, the device's peak bytes, trace."""
    answers, call_s, call_cpu_s = [], [], []
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    with contextlib.ExitStack() as stack:
        if traced:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU] + \
                ([ProfilerActivity.CUDA] if cuda else [])
            prof = stack.enter_context(profile(activities=acts))
            sampler = stack.enter_context(devtrace.PySampler())
        w0 = time.perf_counter()
        while True:
            j = len(answers) % len(paths)
            c0, p0 = time.perf_counter(), time.process_time()
            with torch.profiler.record_function(devtrace.WINDOW_MARK):
                answers.append((j, *call(paths[j])))
            call_s.append(time.perf_counter() - c0)
            call_cpu_s.append(time.process_time() - p0)
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    tr = None
    if traced:
        tpath = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(tpath)
        del prof
        tr = devtrace.load(tpath)
        os.remove(tpath)
        tr.add_samples(sampler.samples, w0 * 1e6)
    return {"answers": answers, "seconds": window_s, "call_s": call_s,
            "call_cpu_s": call_cpu_s, "peak": peak, "trace": tr}


def make_genomes(cfg: dict, seed: int):
    """The configuration's genomes and their species from ``seed``, and
    the taxonomy from the configuration's plan seed, the same tree in
    every run."""
    genomes, species = gen.config_genomes(cfg, seed)
    nodes = gen.make_taxonomy(int(species.max()) + 1,
                              cfg["taxonomy"]["branching"],
                              cfg["genomes"]["plan_seed"])
    return genomes, species, nodes


def make_reads(traffic: dict, genomes, seed: int) -> list:
    """The mix's read files: [(codes, offsets)]."""
    rng = np.random.default_rng([seed, 1])
    return [gen.read_file(traffic, genomes, rng, j)
            for j in range(traffic["files"])]


def sample_of(read_set, n: int, seed: int):
    """``n`` reads of one read file, drawn from ``seed`` without
    repeats, in the file's order. -> (codes, offsets)."""
    codes, offs = read_set
    total = len(offs) - 1
    pick = np.sort(np.random.default_rng([seed, 2]).choice(
        total, min(n, total), replace=False))
    lens = offs[pick + 1] - offs[pick]
    new = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    idx = np.repeat(offs[pick] - new[:-1], lens) + np.arange(new[-1])
    return codes[idx], new


def device_block(cuda: bool, peak: int, tr) -> dict:
    if cuda:
        d = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
             "count": 1, "memory_peak_bytes": int(peak)}
    else:
        d = {"platform": "cpu", "kind": "cpu", "count": 1,
             "memory_peak_bytes": 0}
    if tr is not None:
        d["busy_s"] = tr.busy_s()
        d["window_s"] = tr.window_s
    return d


# --------------------------------------------------- reference and checks
def reference_answers(cfg, genomes, species, nodes, reads, mapping: list,
                      device, feature_bits: int | None = None) -> list:
    """Each read set's answer worked out by the reference: its counts by
    rank, its ``-tophits`` mapping lines where ``mapping`` (one flag a
    set) asks for them, and the work counts of its reads.
    ``feature_bits`` (default: the configuration's) below it makes the
    control."""
    sk, cl = cfg["sketching"], cfg["classify"]
    bits = feature_bits or cfg["feature_bits"]
    table = ref.build_table(genomes, sk, cfg["max_locations_per_feature"],
                            device, bits)
    lin = torch.from_numpy(ref.lineage_table(gen.SPECIES_BASE + species,
                                                        nodes)).to(device)
    names = {t: n for t, (_p, _r, n) in nodes.items()}
    tnames = [gen.target_name(i) for i in range(len(genomes))]
    loc_bits = max(table.ntargets - 1, 1).bit_length() + \
        max(table.maxwin, 1).bit_length()
    out = []
    for (codes, offs), lines in zip(reads, mapping):
        tgt, hits, per_read, nfeat = ref.candidates(
            table, torch.from_numpy(codes).to(device), offs, sk, cl, bits)
        ranks, taxa = ref.classify(tgt, hits, lin, cl, sk["sketchlen"])
        n = per_read.double()
        out.append({
            "counts": ref.rank_counts(ranks),
            "lines": ref.mapping_lines(tgt, hits, ranks, taxa, names,
                                       tnames) if lines else None,
            "stats": {"reads": len(offs) - 1, "features": nfeat,
                      "locations": float(n.sum()),
                      "sort_ops": float((n * torch.log2(n.clamp(min=1)))
                                        .ceil().sum()),
                      "location_bytes": 4 if loc_bits <= 32 else 8,
                      "candidates": cl["max_candidates"]}})
    del table
    return out


def program_lines(text: str) -> list:
    """The per-read lines of a query's output, without comment lines."""
    return [ln for ln in text.splitlines() if ln and not ln.startswith("#")]


def compare(answers, want, mapping: bool):
    """Every call's answer against its file's reference answer.
    -> ({name: {"value", "limit"}}, calls that differ)."""
    gap = differ = failed = 0
    for j, counts, text in answers:
        g = int(np.abs(np.asarray(counts, np.int64) -
                       want[j]["counts"]).sum())
        d = 0
        if mapping:
            got, exp = program_lines(text), want[j]["lines"]
            d = sum(a != b for a, b in zip(got, exp)) + \
                abs(len(got) - len(exp))
        gap += g
        differ += d
        failed += bool(g or d)
    checks = {"rank_count_gap": {"value": gap, "limit": 0}}
    if mapping:
        checks["lines_differing"] = {"value": differ, "limit": 0}
    return checks, failed


def compare_sample(text: str, want: dict) -> dict:
    """The sample's per-read lines against the reference's."""
    got, exp = program_lines(text), want["lines"]
    d = sum(a != b for a, b in zip(got, exp)) + abs(len(got) - len(exp))
    return {"sample_lines_differing": {"value": d, "limit": 0}}


# --------------------------------------------------------- per-layer run
def per_layer(bench: Bench, workload: str, cfg: dict, run: dict, want,
              answers, device) -> dict:
    """The traced run's per-layer metrics: each reader of the cell given
    the run's readings, the device seconds of each stage's kernels and
    each stage's least work over the window's calls."""
    of = stage_of(bench.kernel_stages())
    stage_s: dict = {}
    if run["trace"] is not None:
        names, secs = run["trace"].kernels()
        for n, s in zip(names.tolist(), secs.tolist()):
            st = of(n)
            if st:
                stage_s[st] = stage_s.get(st, 0.0) + s
    stats: dict = {}
    for j, _c, _t in answers:
        for k, v in want[j]["stats"].items():
            stats[k] = v if k in ("location_bytes", "candidates") else \
                stats.get(k, 0.0) + v
    kind = torch.cuda.get_device_name(0) \
        if torch.device(device).type == "cuda" else "cpu"
    run = dict(run, stage_seconds=stage_s, peak=bench.peaks(kind),
               work={st: count(stats, cfg)
                     for st, count in bench.work_counters().items()})
    units = {m["name"]: m["unit"] for m in bench.manifest["per_layer"]}
    metrics = {}
    for name, read in bench.metric_readers(workload).items():
        v = read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": units[name]}
    return metrics


def main(argv=None, t_start: float | None = None) -> int:
    import argparse
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    bench = Bench.load()
    chips = bench.workload(a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        say(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    res = run_cell(bench, a.workload, a.seed, a.seconds, bool(a.trace),
                   "cuda", t_start)
    bad = forbidden_modules()
    if bad:
        say("modules that the run may not load: " + ", ".join(bad))
        return 3
    for k, v in res["notes"].items():
        say(f"[note] {k} {v}")
    for name, c in res["checks"].items():
        say(f"[check] {name} {c['value']} limit {c['limit']}")
    print(json.dumps(res), flush=True)     # "checks" comes last
    return 0
