"""Time kernels B9 (the bucket probe, mc_bucket_decode) and B8 (the
overflow-row id, mc_oidx_decode) of metacache_tpu_torch
(csrc/probe_decode.cu) against the same entry points built from another
revision's probe_decode.cu, and B8 against patched copies of this
checkout's source (other threads a block), on one CUDA card.

    git show <rev>:metacache_tpu_torch/csrc/probe_decode.cu > base.cu
    python3 tools/torch_b9_ab.py base.cu

The base's mc_bucket_decode may be the pair-packed-only form of a
revision before B9's widening (brows, bits, flat, n, idx, found,
stream) or the later one (told from the base's text). Both kernels
probe chip_smoke.py's 2 M-feature device-built probe table: B9 131,072
features (29% misses, 1% sentinels) on its pair-packed bucket index (18
bits), B8 the rows B9 found, on the 64-lane view of the pair-packed head
rows. Every build's outputs must equal this checkout's. Device time:
chip_smoke.kernel_ms (20 launches in a CUDA graph, replayed between
CUDA events) in turns: base, this, the variants, then the same in
reverse (B8: five such rounds); B8's launch floor
(kernels.launch_floor(2, n): an empty kernel launched as B8 is, on its
grid) beside them. B8's host time (chip_smoke.host_us) and time a call
(CUDA events over 200 unsynchronised calls), five rounds in turns: the
base's and this checkout's entry points called alike through ctypes
(so they differ only in how the kernel is launched), and this
checkout's wrapper. Then this checkout's B8 on the rows confined to the
table's first 2^12 ... 2^20 of its 2^21 (the footprint sweep: the
rows' L2 and TLB reach). Prints the card's name and power limit, then
one JSON line a kernel and measure (and a footprint). About three
minutes with the builds.
"""
import ctypes
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke as cs  # noqa: E402  (blocks JAX and the JAX package)
import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch_classed_ab as ab  # noqa: E402

from metacache_tpu_torch import kernels  # noqa: E402
from metacache_tpu_torch.ops import probe_decode as D  # noqa: E402

# this checkout's source patched into other shapes of B8 (their results
# must equal this checkout's): (text, replacement) pairs, each text found
# exactly once
VARIANTS = {
    "b8_threads128": ("constexpr int kOidxThreads = 256;",
                      "constexpr int kOidxThreads = 128;"),
    "b8_threads512": ("constexpr int kOidxThreads = 256;",
                      "constexpr int kOidxThreads = 512;"),
    "b8_threads1024": ("constexpr int kOidxThreads = 256;",
                       "constexpr int kOidxThreads = 1024;"),
}
# B8's rows confined to the first R of the table: the footprint sweep
FOOTPRINTS = (1 << 12, 1 << 15, 1 << 17, 1 << 19, 1 << 20)


def binder(path: str):
    """-> the function that sets the argument types of a build of
    ``path`` (B9's entry point in its form, and B8's)."""
    with open(path) as f:
        old9 = "mc_bucket_decode(const void* brows, int bits" in f.read()
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64

    def bind(lib):
        lib.mc_bucket_decode.argtypes = (
            [p, i, p, i64, p, p, p] if old9 else
            [p, i64, i, i, p, i, i64, i64, p, p, p])
        lib.mc_oidx_decode.argtypes = [p, i64, i, p, p, i64, p, p]
        lib.old9 = old9
    return bind


def probe_table(dev):
    """chip_smoke's probe table and 131,072 probes -> (table, flat)."""
    rng = np.random.default_rng(5)
    dt = cs.build_probe_table(cs.probe_stream(rng, cs.PROBE_FEATURES), dev)
    n = 131072
    flat = dt.uniq[torch.from_numpy(rng.integers(0, dt.nf, n)).to(dev)]
    miss = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    flat = torch.where(miss, torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev),
        flat)
    flat[::100] = -1
    return dt, flat


def b9_call(lib, dt, flat):
    """lib's B9 on the table's pair-packed index -> () -> (idx, found)."""
    n = flat.shape[0]
    idx = torch.empty((n,), dtype=torch.int32, device=flat.device)
    found = torch.empty((n,), dtype=torch.bool, device=flat.device)
    old9 = lib.old9

    def run():
        stream = torch.cuda.current_stream().cuda_stream
        if old9:
            err = lib.mc_bucket_decode(dt.brows.data_ptr(), dt.bbits,
                                       flat.data_ptr(), n, idx.data_ptr(),
                                       found.data_ptr(), stream)
        else:
            err = lib.mc_bucket_decode(
                dt.brows.data_ptr(), 1 << dt.bbits, 64, dt.bbits,
                flat.data_ptr(), 0, n, -1, idx.data_ptr(), found.data_ptr(),
                stream)
        if err != 0:
            raise RuntimeError(f"mc_bucket_decode: CUDA error {err}")
        return idx, found
    return run


def b8_call(lib, head, idx, flat):
    """lib's B8 on (head, idx, flat) -> () -> (oidx,)."""
    n = idx.shape[0]
    oidx = torch.empty((n,), dtype=torch.int32, device=idx.device)

    def run():
        err = lib.mc_oidx_decode(head.data_ptr(), head.shape[0],
                                 head.shape[1], idx.data_ptr(),
                                 flat.data_ptr(), n, oidx.data_ptr(),
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"mc_oidx_decode: CUDA error {err}")
        return (oidx,)
    return run


def in_turns(calls: dict, timer=cs.kernel_ms, rounds: int = 1) -> dict:
    """Check every call's outputs against "this", then time each with
    ``timer`` in turns (the names, then reversed, ``rounds`` times) ->
    the line's timing fields: every reading, each call's mean and
    (min, max)."""
    want = calls["this"]()
    for k, fn in calls.items():
        for g, w in zip(fn(), want):
            cs.check_equal(f"{k} vs this", g, w)
    names = list(calls)
    reads = {k: [] for k in names}
    for k in (names + names[::-1]) * rounds:
        reads[k].append(timer(calls[k]))
    return dict(equal=True, order=names + names[::-1], rounds=rounds,
                turns=reads,
                mean={k: sum(v) / len(v) for k, v in reads.items()},
                spread={k: (min(v), max(v)) for k, v in reads.items()})


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    srcs = ab.sources(sys.argv[1], VARIANTS, prefix="b9_ab")
    libs = ab.build(srcs, prefix="b9_ab", bind=lambda lib: None)
    for k, lib in libs.items():
        binder(srcs[k])(lib)
    dev = torch.device("cuda")
    dt, flat = probe_table(dev)
    n = flat.shape[0]
    calls = {"base": b9_call(libs["base"], dt, flat),
             "this": lambda: D.bucket_decode(dt.brows, flat, dt.bbits)}
    line = in_turns(calls)
    b_ms, by = cs.bound(n * (4 + 256 + 4 + 1), n * 64 * 3)
    print(json.dumps({"kernel": "B9", "probes": n, "bucket_bits": dt.bbits,
                      "base_old_form": libs["base"].old9, **line,
                      "bound_ms": b_ms, "bound_by": by}), flush=True)

    head = dt.head.view(-1, 64)
    idx = torch.clamp(D.bucket_decode(dt.brows, flat, dt.bbits)[0], 0,
                      dt.nf - 1)
    b_ms, by = cs.bound(n * (4 + 4 + 8 + 4), n * 4)
    calls = {k: b8_call(lib, head, idx, flat) for k, lib in libs.items()}
    calls["this"] = lambda: (D.oidx_decode(head, idx, flat),)
    calls = {k: calls[k] for k in ["base", "this", *VARIANTS]}
    line = in_turns(calls, rounds=5)
    floor = [cs.kernel_ms(lambda: kernels.launch_floor(2, n))
             for _ in range(4)]
    print(json.dumps({
        "kernel": "B8", "measure": "device_ms", "probes": n,
        "deep_share": float((calls["this"]()[0] > 0).float().mean()),
        **line, "floor_ms": floor, "bound_ms": b_ms, "bound_by": by,
        "bound_share": {k: b_ms / v for k, v in line["mean"].items()}
    }), flush=True)
    # the same call through ctypes from the base's build (<<<>>>) and
    # this checkout's (cudaLaunchKernelEx, programmatic dependent), and
    # this checkout's wrapper
    calls = {"base": b8_call(libs["base"], head, idx, flat),
             "this": b8_call(kernels._load(), head, idx, flat),
             "wrapper": lambda: (D.oidx_decode(head, idx, flat),)}
    for measure, timer in (("host_us", cs.host_us),
                           ("call_ms", lambda fn: cs.cuda_ms(fn, 200))):
        print(json.dumps({"kernel": "B8", "measure": measure, "probes": n,
                          **in_turns(calls, timer, rounds=5)}), flush=True)
    # this checkout's B8 on rows confined to the table's first R: where
    # the rows' sectors fit the L2 cache the time falls to the launch
    # and its chain of round trips
    for r in (*FOOTPRINTS, head.shape[0]):
        ir = torch.remainder(idx, r)
        t = [cs.kernel_ms(lambda: D.oidx_decode(head, ir, flat))
             for _ in range(2)]
        print(json.dumps({"kernel": "B8-footprint", "rows": r,
                          "distinct_rows": int(torch.unique(ir).numel()),
                          "kernel_ms": t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
