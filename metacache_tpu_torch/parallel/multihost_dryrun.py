"""Multi-process dryrun worker: one process of a cluster of N.

Port of metacache_tpu/parallel/multihost_dryrun.py. Run from the
repository root, one process a rank:

    python -m metacache_tpu_torch.parallel.multihost_dryrun \\
        --coordinator localhost:PORT --nprocs 2 --pid I --local-devices 2

Each process joins the gloo group (parallel/multihost.py), builds the
same synthetic database (JAX's, plus the batch's own sketches, so that
its reads classify), and runs the sharded row step over its rows of
the global batch on its own (data, table) grid of ``--local-devices``
devices (the table axis within the process, the data axis across the
processes); it checks its rows against the port's single-device step on
the same rows, all processes agree through gloo, and it prints
MULTIHOST_OK. Its devices are the CPU under MC_TORCH_DEVICE=cpu, else
the CUDA devices, repeated where there are fewer than asked for.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..db.state import tables_from_numpy
from ..ops.probe import make_bucket_index
from ..ops.rows import query_step_rows
from ..ops.sketch import sketch_windows
from ..ops.table import FeatureTable, pack_locations
from . import multihost as MH
from .rows_mesh import merge_blocks, shard_row_table, sharded_query_step_rows

FIELDS = ("cand_tgt", "cand_tax", "cand_hits", "cand_beg", "cand_end",
          "cls_tax")


def _devices(n: int) -> list:
    if os.environ.get("MC_TORCH_DEVICE") == "cpu":
        return [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; set "
                           "MC_TORCH_DEVICE=cpu to run on the CPU")
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n)]


def synthetic_table(batch: np.ndarray):
    """The JAX worker's database (multihost_dryrun.py:55-67): 4096
    random features, two locations each, 64 targets; and its lineages.
    Unlike JAX's, it also holds the sketch of every read of ``batch``
    (B, 127) at two locations of the read's own target (row % 64), so
    that the reads classify."""
    rng = np.random.default_rng(11)
    feats = np.unique(rng.integers(0, 2**32, 4096,
                                   dtype=np.uint64).astype(np.uint32))
    nf = len(feats)
    ltgt = rng.integers(0, 64, nf * 2).astype(np.uint32)
    lwin = rng.integers(0, 500, nf * 2).astype(np.uint32)
    own = sketch_windows(torch.from_numpy(batch),
                         torch.full((len(batch),), 100, dtype=torch.int32),
                         16, 16).numpy().view(np.uint32)
    keep = own != 0xFFFFFFFF
    row = np.broadcast_to(np.arange(len(batch))[:, None], own.shape)[keep]
    f = np.concatenate([np.repeat(feats, 2), np.repeat(own[keep], 2)])
    t = np.concatenate([ltgt, np.repeat(row % 64, 2).astype(np.uint32)])
    w = np.concatenate([lwin, np.tile([500, 501], len(row)).astype(
        np.uint32)])
    ft = FeatureTable.build(f, pack_locations(t, w))
    lin = np.zeros((64, 21), np.int32)
    lin[:, 0] = -np.arange(64) - 1
    lin[:, 4] = rng.integers(1, 9, 64)
    lin[:, 20] = 1
    return ft, lin


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    args = ap.parse_args()
    torch.set_num_threads(2)
    MH.initialize(args.coordinator, args.nprocs, args.pid)
    try:
        return _run(args)
    finally:
        MH.shutdown()


def _run(args) -> int:
    assert MH.process_count() == args.nprocs
    devices = _devices(args.local_devices)
    ndev = args.nprocs * args.local_devices
    num_table = 2
    num_data = ndev // num_table
    B = num_data * num_table * 4          # global rows
    # every process draws the whole batch and keeps its own rows, so the
    # rows of each are fixed by their global row index
    batch = np.random.default_rng(1000).integers(0, 4, (B, 127),
                                                 dtype=np.uint8)
    ft, lin = synthetic_table(batch)
    grid = MH.make_global_mesh(num_data, num_table, devices)
    st = shard_row_table(ft, num_table, 255, grid=grid, lineages=lin,
                         merge_tax=lin[:, 0].copy())
    lo, hi = MH.process_row_range(B)
    wins = batch[lo:hi].reshape(hi - lo, 1, 127)
    valid = np.full((hi - lo, 1), 100, np.int32)
    mwir = np.full(hi - lo, 2, np.int32)
    flags = dict(max_candidates=2, walk_elems=32, fast_top2=True,
                 fused_candidates=True)
    dev = grid[0, 0]
    got = merge_blocks(sharded_query_step_rows(
        MH.global_batch(wins, grid), MH.global_batch(valid, grid),
        MH.global_batch(mwir, grid), st, 1, 1.0, 19, 0, k=16,
        sketchlen=16, **flags), dev)

    # the single-device step on this process's rows
    spf = max(ft.max_bucket_size, 1)
    brows, bits = make_bucket_index(ft.unique_features)
    tables = tables_from_numpy(ft.unique_features, ft.offsets,
                               ft.fused_rows(spf), brows, bits, lin,
                               lin[:, 0].copy(), spf, 0, dev)
    want = query_step_rows(
        torch.from_numpy(wins).to(dev), torch.from_numpy(valid).to(dev),
        torch.from_numpy(mwir).to(dev), tables, 1, 1.0, 19, 0, k=16,
        sketchlen=16, windows_per_query=1, **flags)
    bad = [f for f in FIELDS if not np.array_equal(
        MH.local_values(getattr(got, f)), MH.local_values(getattr(want, f)))]
    classified = int((got.cls_tax != 0).sum())
    if not MH.all_ok(not bad and classified == hi - lo):
        print(f"MULTIHOST_FAIL pid={args.pid}: fields {bad} differ, "
              f"{classified} of {hi - lo} rows classified here, or a fault "
              "on another process", file=sys.stderr)
        return 1
    on = ",".join(sorted(set(map(str, devices))))
    print(f"MULTIHOST_OK pid={args.pid} procs={MH.process_count()} "
          f"devices={ndev} grid={grid.shape} on={on} rows=[{lo},{hi}) "
          f"classified={classified}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
