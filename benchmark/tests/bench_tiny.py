"""A tiny copy of the benchmark for the CPU: the benchmark's folder with
a configuration of about 8 genomes of 20-60 kbp and its two mixes cut to a few
thousand reads, and a manifest of the two cells."""
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("tiny.short100-summary", "tiny.long480-tophits")


def tiny_genomes(cfg: dict) -> dict:
    """The configuration's genome plan cut to about 8 genomes of 20-60
    kbp (each longer than the longest long read) with operons of 500 bp."""
    g = cfg["genomes"]
    g["total_bases"] = 200000
    g["lengths"].update(median=30000, min=20000, max=60000)
    g["species_sizes"]["largest"] = 4
    g["operon"].update(length=500, copies=[1, 3])
    return cfg


def tiny_bench(tmp, short_reads: int = 2000, long_reads: int = 200):
    """-> a harness.Bench over a copy of the benchmark under ``tmp``."""
    import harness
    root = os.path.join(tmp, "benchmark")
    shutil.copytree(BENCH, root, ignore=shutil.ignore_patterns(
        "tests", "__pycache__"))
    with open(os.path.join(os.path.dirname(BENCH), "BENCHMARK.json")) as f:
        m = json.load(f)
    with open(os.path.join(root, "configs", "refseqbact-k16.json")) as f:
        cfg = json.load(f)
    tiny_genomes(cfg)
    with open(os.path.join(root, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    for name, n in (("short100-summary", short_reads),
                    ("long480-tophits", long_reads)):
        p = os.path.join(root, "traffic", name + ".json")
        with open(p) as f:
            t = json.load(f)
        t["reads_per_file"] = n
        with open(p, "w") as f:
            json.dump(t, f)
    m["configs"].append({"name": "tiny", "source": "tests",
                         "file": "benchmark/configs/tiny.json",
                         "reduced": ["genomes"], "why": "CPU tests"})
    for c in CELLS:
        m["workloads"].append({"name": c, "config": "tiny",
                               "traffic": c.split(".", 1)[1], "chips": 1,
                               "why": "CPU tests"})
    for metric in m["per_layer"]:
        metric["workloads"] = metric["workloads"] + list(CELLS)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(m, f)
    return harness.Bench.load(root=root)
