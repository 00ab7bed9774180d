"""The harness's lookup, generators, trace readings and imports."""
import ast
import re
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import devtrace
import gen
import harness
from bench_tiny import BENCH, tiny_bench, tiny_genomes

REPO = os.path.dirname(BENCH)


def manifest():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


# ----------------------------------------------------------- generators
@pytest.mark.parametrize("cfg", [c["name"] for c in manifest()["configs"]])
def test_genomes_repeat_per_seed(cfg):
    with open(os.path.join(BENCH, "configs", cfg + ".json")) as f:
        c = tiny_genomes(json.load(f))
    a, sa, ta = harness.make_genomes(c, 2**31 + 5)
    b, sb, tb = harness.make_genomes(c, 2**31 + 5)
    d, sd, td = harness.make_genomes(c, 2**31 + 6)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(sa, sb) and ta == tb
    assert not all(np.array_equal(x, y) for x, y in zip(a, d))
    # every seed builds the same genomes' lengths, species and tree
    assert [len(x) for x in a] == [len(x) for x in d]
    assert np.array_equal(sa, sd) and ta == td


def test_genome_plan_shape():
    """Species sizes fall as largest / k, each species' strains share its
    length, and the plan reaches the configuration's bases."""
    with open(os.path.join(BENCH, "configs", "refseqbact-k16.json")) as f:
        spec = json.load(f)["genomes"]
    p = gen.genome_plan(spec)
    k = np.arange(1, len(p["strains"]) + 1)
    assert np.array_equal(p["strains"],
                          np.ceil(spec["species_sizes"]["largest"] / k))
    total = int((p["strains"] * p["length"]).sum())
    assert spec["total_bases"] <= total < spec["total_bases"] + \
        spec["lengths"]["max"]
    assert p["length"].min() >= spec["lengths"]["min"]
    assert p["length"].max() <= spec["lengths"]["max"]
    lo, hi = spec["operon"]["copies"]
    assert lo <= p["copies"].min() and p["copies"].max() <= hi
    assert all(r[0] == 0 and len(r) == n
               for r, n in zip(p["rates"], p["strains"].tolist()))


def test_operon_copies_pass_the_cap():
    """In a database of many genomes a conserved operon's features have
    more locations than the cap keeps (cut here to 8)."""
    from reference import metacache as ref
    with open(os.path.join(BENCH, "configs", "refseqbact-k16.json")) as f:
        c = tiny_genomes(json.load(f))
    genomes, _sp = gen.config_genomes(c, 3)
    full = ref.build_table(genomes, c["sketching"], 10**9, "cpu")
    capped = ref.build_table(genomes, c["sketching"], 8, "cpu")
    assert int(full.offs.diff().max()) > 8
    assert int(capped.offs.diff().max()) == 8


@pytest.mark.parametrize("mix", ["short100-summary", "long480-tophits"])
def test_reads_repeat_per_seed(mix):
    with open(os.path.join(BENCH, "traffic", mix + ".json")) as f:
        t = json.load(f)
    t["reads_per_file"] = 300
    genomes = [np.random.default_rng(i).integers(0, 4, 30000, dtype=np.uint8)
               for i in range(3)]
    a = harness.make_reads(t, genomes, 7)
    b = harness.make_reads(t, genomes, 7)
    c = harness.make_reads(t, genomes, 8)
    assert len(a) == t["files"]
    for (ca, oa), (cb, ob) in zip(a, b):
        assert np.array_equal(ca, cb) and np.array_equal(oa, ob)
    assert not np.array_equal(a[0][0][:1000], c[0][0][:1000])
    # every seed reads the same set of lengths, in another order
    assert np.array_equal(np.sort(np.diff(a[0][1])), np.sort(np.diff(c[0][1])))


def test_taxonomy_has_main_ranks():
    nodes = gen.make_taxonomy(77, 3, 1)
    ranks = {r for _p, r, _n in nodes.values()}
    assert {"species", "genus", "family", "order", "class", "phylum",
            "superkingdom"} <= ranks
    for t, (p, _r, _n) in nodes.items():
        assert p in nodes
    assert sum(r == "species" for _p, r, _n in nodes.values()) == 77


# ---------------------------------------------------------------- files
@pytest.mark.parametrize("cell", [w["name"] for w in manifest()["workloads"]])
def test_every_cell_names_existing_files(cell):
    bench = harness.Bench.load()
    w = bench.workload(cell)
    cfg = bench.config(w["config"])
    assert cfg["name"] == w["config"]
    t = bench.traffic(w["traffic"])
    assert t["output"] in ("summary", "mapping")
    readers = bench.metric_readers(cell)
    assert set(readers) == {m["name"] for m in bench.manifest["per_layer"]}
    assert bench.kernel_stages() and bench.work_counters()
    assert bench.peaks("NVIDIA H100 80GB HBM3")["bytes_per_s"] > 0


def test_manifest_keeps_the_contract_shapes():
    m = manifest()
    assert [e["name"] for e in m["end_to_end"]] == [
        "queries_per_min", "device_peak_gib", "setup_s"]
    names = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    units = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for e in m["end_to_end"] + m["per_layer"]:
        assert names.match(e["name"]) and units.match(e["unit"])
    layers = {e["layer"] for e in m["per_layer"]}
    assert len(m["per_layer"]) == 7 and len(layers) == 6
    assert all(w["chips"] == 1 for w in m["workloads"])
    for p in m["paths"]:
        assert os.path.isdir(os.path.join(REPO, p))


def test_lookup_finds_added_files(tmp_path):
    """A configuration, a mix, a per-layer metric, a kernel's stage and a
    stage's work are added by new files and manifest entries alone."""
    bench = tiny_bench(str(tmp_path))
    root = bench.root
    with open(os.path.join(root, "configs", "tiny.json")) as f:
        cfg = json.load(f)
    with open(os.path.join(root, "configs", "added.json"), "w") as f:
        json.dump(dict(cfg, name="added"), f)
    with open(os.path.join(root, "traffic", "added-mix.json"), "w") as f:
        json.dump({"files": 1, "reads_per_file": 10,
                   "lengths": {"kind": "fixed", "value": 100},
                   "query_flags": ["-no-map"], "output": "summary",
                   "plan_seed": 1}, f)
    with open(os.path.join(root, "metrics", "added_metric.py"), "w") as f:
        f.write("def read(run):\n    return run['queries'] * 2.0\n")
    with open(os.path.join(root, "kernels", "added_kernel.json"), "w") as f:
        json.dump({"pattern": r"\badded_kernel\b", "stage": "added"}, f)
    with open(os.path.join(root, "work", "added.py"), "w") as f:
        f.write("def count(stats, cfg):\n"
                "    return {'bytes': stats['reads'], 'ops': 0}\n")
    m = bench.manifest
    m["configs"].append({"name": "added", "source": "tests",
                         "file": "benchmark/configs/added.json",
                         "reduced": [], "why": "tests"})
    m["workloads"].append({"name": "added.added-mix", "config": "added",
                           "traffic": "added-mix", "chips": 1,
                           "why": "tests"})
    m["per_layer"].append({"name": "added_metric", "unit": "x",
                           "better": "higher", "source": "program_counter",
                           "layer": "added", "moves": "queries_per_min",
                           "workloads": ["added.added-mix"]})
    assert bench.config("added")["name"] == "added"
    assert bench.traffic("added-mix")["reads_per_file"] == 10
    assert bench.metric_readers("added.added-mix")["added_metric"](
        {"queries": 4}) == 8.0
    assert "added_metric" not in bench.metric_readers("tiny.long480-tophits")
    of = harness.stage_of(bench.kernel_stages())
    assert of("void added_kernel<4>(int*)") == "added"
    assert of("void candidates_kernel<16, 256>(int const*)") == "candidates"
    assert of("void candidates_unpacked_kernel<16>(long)") == "candidates"
    assert of("void tile_sort_kernel(int)") == "candidates"
    assert of("at::native::vectorized_elementwise_kernel") is None
    assert bench.work_counters()["added"]({"reads": 3}, cfg)["bytes"] == 3


# ---------------------------------------------------------------- trace
def synthetic_trace(path):
    """A window of 1000 us with kernels of two stages, a copy, an
    unnamed kernel, and host events over the gaps."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.call",
           "ts": 1000, "dur": 400},
          {"ph": "X", "cat": "user_annotation", "name": "bench.call",
           "ts": 1400, "dur": 600},
          {"ph": "X", "cat": "kernel", "name": "void bucket_decode_kernel<1>",
           "ts": 1100, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "void dense_decode_kernel",
           "ts": 1150, "dur": 100},           # overlaps the one before
          {"ph": "X", "cat": "kernel", "name": "void candidates_kernel<16>",
           "ts": 1500, "dur": 200},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
           "ts": 1800, "dur": 50},
          {"ph": "X", "cat": "kernel", "name": "elementwise_kernel",
           "ts": 1900, "dur": 10},
          {"ph": "X", "cat": "kernel", "name": "outside", "ts": 500,
           "dur": 10},                        # before the window
          {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1000,
           "dur": 90},
          {"ph": "X", "cat": "cuda_runtime", "name": "cudaStreamSynchronize",
           "ts": 1260, "dur": 230}]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev}, f)


def test_trace_readings(tmp_path):
    p = str(tmp_path / "t.json")
    synthetic_trace(p)
    tr = devtrace.load(p)
    assert tr.window_s == pytest.approx(1000e-6)
    # busy: [1100, 1250] + [1500, 1700] + [1800, 1850] + [1900, 1910]
    assert tr.busy_s() == pytest.approx(410e-6)
    names, secs = tr.kernels()
    assert len(names) == 4 and secs.sum() == pytest.approx(410e-6)
    bench = harness.Bench.load()
    run = {"trace": tr, "queries": 8192 * 2, "build_s": 1.5, "stage_s": 0.5,
           "staged_bytes": 2**31}
    readers = bench.metric_readers(bench.manifest["workloads"][0]["name"])
    assert readers["device_idle_share"](run) == pytest.approx(59.0)
    assert readers["kernel_events_per_8k_queries"](run) == pytest.approx(2.0)
    assert readers["staged_gib"](run) == 2.0
    assert readers["build_s"](run) == 1.5 and readers["stage_s"](run) == 0.5
    of = harness.stage_of(bench.kernel_stages())
    stage = {}
    for n, s in zip(names.tolist(), secs.tolist()):
        if of(n):
            stage[of(n)] = stage.get(of(n), 0.0) + s
    assert stage == pytest.approx({"probe": 200e-6, "candidates": 200e-6})
    peak = {"bytes_per_s": 1e9, "int_ops_per_s": 1e9}
    run.update(stage_seconds=stage, peak=peak,
               work={"probe": {"bytes": 100e3, "ops": 1e3},
                     "candidates": {"bytes": 1e3, "ops": 50e3}})
    assert readers["probe_roofline"](run) == pytest.approx(50.0)
    assert readers["candidates_roofline"](run) == pytest.approx(25.0)
    run["work"] = {}
    assert readers["probe_roofline"](run) is None
    b = devtrace.breakdown(tr, of)
    assert b["device_ops"][0] == ["candidates: candidates_kernel<16>",
                                  pytest.approx(200e-6)]
    assert ["probe: bucket_decode_kernel<1>", pytest.approx(100e-6)] in \
        b["device_ops"]
    assert any(n == "other: elementwise_kernel" for n, _s in b["device_ops"])
    gaps = dict(b["idle_gaps"])
    assert gaps["cudaStreamSynchronize"] == pytest.approx(250e-6)
    assert gaps["aten::copy_"] == pytest.approx(100e-6)
    assert gaps[devtrace.OUTSIDE_OPS] == pytest.approx(240e-6)
    assert sum(gaps.values()) == pytest.approx(590e-6)


def test_no_trace_no_device_metric():
    bench = harness.Bench.load()
    readers = bench.metric_readers(bench.manifest["workloads"][0]["name"])
    run = {"trace": None, "queries": 10, "stage_seconds": {}, "work": {},
           "peak": None}
    for name in ("device_idle_share", "kernel_events_per_8k_queries",
                 "probe_roofline", "candidates_roofline"):
        assert readers[name](run) is None


# -------------------------------------------------------------- imports
def imported_top_names(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(os.path.join(BENCH, "reference")):
        if name.endswith(".py"):
            tops = imported_top_names(os.path.join(BENCH, "reference", name))
            assert not tops & {"jax", "jaxlib", "flax", "metacache_tpu",
                               "metacache_tpu_torch"}, name
    code = ("import sys; sys.path.insert(0, %r); "
            "import reference.metacache; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    tops = set(ast.literal_eval(out.strip().splitlines()[-1]))
    assert not tops & {"jax", "jaxlib", "flax", "metacache_tpu",
                       "metacache_tpu_torch"}


def test_run_loads_no_jax(tmp_path):
    """A whole run on the CPU (tiny cell) leaves no module whose top-level
    name is jax, jaxlib, flax or metacache_tpu in its process, compared
    as whole names: metacache_tpu_torch is the program and is there."""
    tiny_bench(str(tmp_path))
    code = f"""
import os, sys
os.environ["MC_TORCH_DEVICE"] = "cpu"
sys.path[:0] = [{BENCH!r}, {REPO!r}]
import harness
b = harness.Bench.load(root={str(tmp_path / 'benchmark')!r})
r = harness.run_cell(b, "tiny.short100-summary", 3, 0.1, False, "cpu",
                     tmp_root={str(tmp_path)!r})
assert r["correct"], r
print(sorted({{m.split('.')[0] for m in sys.modules}}))
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    tops = set(ast.literal_eval(lines[-2]))
    assert "metacache_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "metacache_tpu"}
    assert ast.literal_eval(lines[-1]) == []


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "metacache_tpu_torch_x",
                        types.ModuleType("metacache_tpu_torch_x"))
    assert "metacache_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "metacache_tpu.db",
                        types.ModuleType("metacache_tpu.db"))
    assert "metacache_tpu.db" in harness.forbidden_modules()


def test_run_refuses_without_cuda(tmp_path):
    """Without the card the command exits non-zero and prints no result."""
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         manifest()["workloads"][0]["name"], "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True,
        cwd=REPO, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """In a folder that holds only the manifest and the benchmark, the
    command exits non-zero and prints no result."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         manifest()["workloads"][0]["name"], "--seed", "1", "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True,
        cwd=str(tmp_path), env=dict(os.environ, MC_TORCH_DEVICE="cpu"))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_short_names():
    n = ("void (anonymous namespace)::candidates_kernel<16, 256>(int const*, "
         "int const*, int*, int, int)")
    assert devtrace.short_name(n) == "candidates_kernel<16, 256>"
    assert devtrace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
    assert len(devtrace.short_name("x" * 500)) == 96


def test_sampler_names_gaps(tmp_path):
    """Python samples of the window's thread name the gaps where no host
    operation is open."""
    import time
    p = str(tmp_path / "t.json")
    synthetic_trace(p)
    tr = devtrace.load(p)
    with devtrace.PySampler(interval=0.001) as s:
        t_end = time.perf_counter() + 0.05
        while time.perf_counter() < t_end:
            pass
    assert len(s.samples) > 5
    assert s.samples[0][1].startswith("py: ")
    t0 = s.samples[0][0]
    tr.add_samples([(t0 + 1880 - 1000, "py: classify/runner.py:f")], t0)
    b = dict(devtrace.breakdown(tr, harness.stage_of([]))["idle_gaps"])
    assert b["py: classify/runner.py:f"] == pytest.approx(240e-6)
