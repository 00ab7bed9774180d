"""A grid of devices, and the sharded build sketch step.

Port of metacache_tpu/parallel/mesh.py. JAX lays its devices out as a
``jax.sharding.Mesh`` with the axes ("data", "table"); here the grid is
a (num_data, num_table) array of ``torch.device`` that one process
drives, position by position:

- "data" (the reference's thread data-parallelism over reads, P1, and
  replication, P4): read batches split across data groups;
- "table" (database parts over GPUs, P2/P3, src/query_batch.cu:464-527):
  feature-range shards of one part, whose query step is
  parallel/rows_mesh.py's.

A device may repeat in the grid: two positions on one card run their
work one after the other there and share what is staged for both. The
CPU tests stand eight ``cpu`` entries for the eight virtual devices of
the JAX package's tests; on one card ``cuda:0`` repeated stands for
several.

``sharded_build_step`` is the build side: every position sketches its
slice of the windows, and the (feature, target, window) triples come
back in window order.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch

from ..ops.sketch import sketch_windows


def default_devices() -> list:
    """Every CUDA device of the process, or the CPU alone under
    MC_TORCH_DEVICE=cpu; raises without either, as device.get_device."""
    if os.environ.get("MC_TORCH_DEVICE") == "cpu":
        return [torch.device("cpu")]
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    raise RuntimeError(
        "no CUDA device is available; set MC_TORCH_DEVICE=cpu to run the "
        "plain PyTorch versions of the kernels on the CPU")


def _canonical(dev) -> torch.device:
    """``dev`` with its index: "cuda" is the current CUDA device."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(num_data: int, num_table: int, devices=None) -> np.ndarray:
    """(num_data, num_table) object array of torch.device, filled row by
    row from ``devices`` (default: ``default_devices()``), as JAX's
    make_mesh reshapes ``jax.devices()`` (mesh.py:31-38)."""
    devices = list(devices) if devices is not None else default_devices()
    need = num_data * num_table
    if len(devices) < need:
        raise ValueError(f"need {need} devices, have {len(devices)}")
    grid = np.empty(need, dtype=object)
    grid[:] = [_canonical(d) for d in devices[:need]]
    return grid.reshape(num_data, num_table)


def distinct(devices) -> list:
    """The distinct devices of a grid or list, in first-seen order."""
    seen = []
    for d in np.asarray(devices, dtype=object).reshape(-1):
        if d not in seen:
            seen.append(d)
    return seen


def on_device(dev: torch.device):
    """Make ``dev`` the current CUDA device for the block (the kernels
    launch on the current device's stream); nothing on the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def sharded_build_step(windows, valid, tgt_ids, win_ids, mesh, k: int,
                       sketchlen: int):
    """Sharded database-build sketch step (mesh.py:41-66): position i of
    the grid, in row order, sketches the i-th of its equal slices of the
    (N, W) windows on its device; -> (features (N*s,), targets (N*s,),
    windows (N*s,)) in window order on the first position's device,
    features as sketch_windows gives them (int32 u32 bit patterns; int64
    for k > 16).

    Reference counterpart: the N-producer build pipeline and its per-part
    inserter threads (src/building.cpp:337-461)."""
    flat = list(np.asarray(mesh, dtype=object).reshape(-1))
    n = windows.shape[0]
    if n % len(flat):
        raise ValueError(f"{n} windows do not split over {len(flat)} "
                         "grid positions")
    per = n // len(flat)
    out = flat[0]
    feats, tgts, wins = [], [], []
    for i, dev in enumerate(flat):
        rows = slice(i * per, (i + 1) * per)
        with on_device(dev):
            f = sketch_windows(windows[rows].to(dev, non_blocking=True),
                               valid[rows].to(dev, non_blocking=True), k,
                               sketchlen)
            t = tgt_ids[rows].to(dev)[:, None].expand(f.shape)
            w = win_ids[rows].to(dev)[:, None].expand(f.shape)
        feats.append(f.reshape(-1).to(out, non_blocking=True))
        tgts.append(t.reshape(-1).to(out, non_blocking=True))
        wins.append(w.reshape(-1).to(out, non_blocking=True))
    return torch.cat(feats), torch.cat(tgts), torch.cat(wins)
