#!/usr/bin/env python3
"""The control of `correct`: the reference computed with 16-bit
features, where the configuration states 32, put in the program's place.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3

For each seed it makes the run's own inputs (genomes, taxonomy, read
files and, for a summary mix, the sample), works out every answer with
the reference at the configuration's feature width and at 16 bits on the
card, and prints, as a run compares them over one call of each file, the
numbers that decide `correct`: the gap of the counts by rank, the sample's
lines that differ and, for a mapping mix, the lines that differ. A sound
control reads above each number's limit (0) in at least one of them.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE]

import harness  # noqa: E402

#: the feature width of the control, below the configurations' 32 bits
BITS = 16


def readings(bench, workload: str, seed: int, device="cuda",
             bits: int = BITS) -> dict:
    cell = bench.workload(workload)
    cfg = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    genomes, species, nodes = harness.make_genomes(cfg, seed)
    reads = harness.make_reads(traffic, genomes, seed)
    mapping = traffic["output"] == "mapping"
    sets, lines = reads, [mapping] * len(reads)
    if not mapping and traffic.get("sample"):
        sets = reads + [harness.sample_of(reads[0],
                                          traffic["sample"]["reads"], seed)]
        lines = lines + [True]
    want = harness.reference_answers(cfg, genomes, species, nodes, sets,
                                     lines, device)
    got = harness.reference_answers(cfg, genomes, species, nodes, sets,
                                    lines, device, feature_bits=bits)
    answers = [(j, g["counts"], "\n".join(g["lines"]) if mapping else None)
               for j, g in enumerate(got[:len(reads)])]
    checks, _failed = harness.compare(answers, want, mapping)
    if len(sets) > len(reads):
        checks.update(harness.compare_sample("\n".join(got[-1]["lines"]),
                                             want[-1]))
    return {k: v["value"] for k, v in checks.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    a = p.parse_args(argv)
    bench = harness.Bench.load()
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = readings(bench, a.workload, seed)
        print(json.dumps({"workload": a.workload, "seed": seed,
                          "bits": BITS, "readings": r,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
