"""Peak device memory of metacache_tpu_torch's non-fused result path
(ops/rows.py::rows_to_result) a slot of a row's padded width, by sweep
(walk, dedup, rank join), on random packed slots at the row widths of
short and long reads (1 to 256 windows of 16 features of 254 slots):
alone (the allocated and the reserved peak), then beside a ballast that
leaves 1, 2 or 4 GiB free, with each width's launch sized at X bytes a
padded slot (the runner's rule, classify/runner.py::nonfused_row_bytes),
the widths in the runner's bucket order; a launch that runs out of
memory marks X too small. One JSON line a case. On an NVIDIA GPU, from
the repository root:
    python3 tools/torch_nonfused_mem.py
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402,F401  (blocks JAX and the JAX package)
import torch  # noqa: E402

from metacache_tpu_torch.device import free_bytes  # noqa: E402
from metacache_tpu_torch.ops import rows as R  # noqa: E402
from metacache_tpu_torch.ops.candidates import padded_width  # noqa: E402

NTGT = 1024
SWEEPS = {
    # sweep: (rows_to_result flags, mwir, widths in the runner's bucket
    # order: windows x 16 features x 254 slots)
    "walk": (dict(walk_elems=32), 2, [1 * 16 * 254, 2 * 16 * 254,
                                       16 * 16 * 254]),
    "dedup": (dict(dedup_walk=6), 6, [16 * 16 * 254, 64 * 16 * 254,
                                      256 * 16 * 254]),
    "rank-join": ({}, 60, [64 * 16 * 254, 128 * 16 * 254,
                           256 * 16 * 254]),
}


def rows(dev, r, l):
    """r rows of l packed slots (target < 900, window < 9000, 15 window
    bits), each filled to a random length of at least l / 2."""
    g = torch.Generator(device=dev).manual_seed(r * 7 + l)
    tgt = torch.randint(0, 900, (r, l), device=dev, generator=g,
                        dtype=torch.int32)
    win = torch.randint(0, 9000, (r, l), device=dev, generator=g,
                        dtype=torch.int32)
    n = torch.randint(l // 2, l + 1, (r, 1), device=dev, generator=g)
    keep = torch.arange(l, device=dev)[None, :] < n
    return torch.where(keep, (tgt << 15) | win, 2**31 - 1)


def call(pk, sweep, taxa):
    flags, mw, _w = SWEEPS[sweep]
    mw = torch.full((pk.shape[0],), mw, dtype=torch.int32, device=pk.device)
    return R.rows_to_result(pk, pk, mw, *taxa, 5, 1.0, 19, 0,
                            max_candidates=2, fast_top2=True,
                            fused_candidates=False, pack_bits=15, **flags)


def peak(fn, slots: int) -> tuple:
    """-> (allocated, reserved) peak bytes a slot of a call of fn."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    a0 = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.memory_stats()
    return ((s["allocated_bytes.all.peak"] - a0) / slots,
            s["reserved_bytes.all.peak"] / slots)


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_nonfused_mem: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mt = -torch.arange(1, NTGT + 1, dtype=torch.int32, device=dev)
    lin = torch.zeros((NTGT, 21), dtype=torch.int32, device=dev)
    lin[:, 0] = mt
    lin[:, 20] = 1
    print(json.dumps({"card": torch.cuda.get_device_name(0)}), flush=True)
    for sweep, (_f, _m, widths) in SWEEPS.items():
        alone = []
        for l in widths:
            for r in (4, 64):
                r = max(min(r, (1 << 28) // l), 1)
                pk = rows(dev, r, l)
                torch.cuda.empty_cache()
                a, res = peak(lambda: call(pk, sweep, (mt, lin)),
                              r * padded_width(l))
                alone.append(dict(l=l, r=r, alloc_per_slot=round(a, 2),
                                  reserved_per_slot=round(res, 2)))
                del pk
        print(json.dumps({"sweep": sweep, "alone": alone}), flush=True)
        for free_gib in (1, 2, 4):
            for x in (96, 128, 160, 192, 224, 256):
                torch.cuda.empty_cache()
                ballast = torch.empty(
                    max(free_bytes(dev) - (free_gib << 30), 0),
                    dtype=torch.uint8, device=dev)
                ok, worst = True, 0.0
                try:
                    for l in widths:
                        r = max(free_bytes(dev) // (padded_width(l) * x), 1)
                        pk = rows(dev, int(min(r, 4096)), l)
                        a, _r = peak(lambda: call(pk, sweep, (mt, lin)),
                                     pk.shape[0] * padded_width(l))
                        worst = max(worst, a)
                        del pk
                except torch.OutOfMemoryError:
                    ok = False      # X bytes a padded slot is too few
                del ballast
                print(json.dumps(dict(sweep=sweep, free_gib=free_gib, x=x,
                                      ok=ok, worst_alloc_per_slot=round(
                                          worst, 2))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
