#!/usr/bin/env python3
"""Benchmark of metacache_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
its standard output (see harness.py); exits non-zero, printing none,
without the CUDA devices the cell asks for.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# kernel and extension caches at fixed paths inside the checkout, so that
# only a checkout's first run builds
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(CHECKOUT, "build", "benchmark", sub)
sys.path[:0] = [HERE, CHECKOUT]

import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T_START))
