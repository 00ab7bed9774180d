"""Multi-process scaffolding on torch.distributed.

Port of metacache_tpu/parallel/multihost.py. The reference has no
in-framework multi-node story (its only one is offline partition +
merge of result files, src/mode_merge.cpp:80-293). The JAX package
joins N processes into one runtime whose mesh lays the data axis across
the processes and the table axis within each, so that no tensor crosses
a process boundary: each process reads its own rows of every global
batch and runs the sharded steps on its own devices.

Here each process drives its own rows of that grid (``make_global_mesh``)
with the steps of parallel/rows_mesh.py, and ``torch.distributed`` joins
the processes for coordination only -- a barrier and small Python
objects over the gloo backend, on the CPU and on cards alike. No NCCL
communicator is made, so two processes may share a card. JAX's
``replicated`` has no counterpart: ``shard_row_table`` places the
tables on the grid. A worker joins the group with ``initialize``
(parallel/multihost_dryrun.py takes its coordinator, process count and
id as arguments).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .mesh import default_devices, make_mesh


def initialize(coordinator: str, num_processes: int,
               process_id: int) -> None:
    """Join the process group (gloo, ``tcp://coordinator``)."""
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def make_global_mesh(num_data: int, num_table: int, devices=None):
    """This process's rows of the global (num_data, num_table) grid,
    whose data groups are filled process by process (multihost.py:
    54-67): a (num_data / processes, num_table) grid of ``devices``
    (default: ``default_devices()``), so that each data group's table
    shards are devices of one process."""
    p = process_count()
    if num_data % p:
        raise ValueError(f"{num_data} data groups do not split over {p} "
                         "processes")
    return make_mesh(num_data // p, num_table,
                     default_devices() if devices is None else devices)


def process_row_range(total_rows: int) -> tuple[int, int]:
    """Rows of a global batch this process owns (its data groups)."""
    p, i = process_count(), process_index()
    per = total_rows // p
    return i * per, (i + 1) * per if i + 1 < p else total_rows


def global_batch(local_rows: np.ndarray, grid) -> torch.Tensor:
    """This process's contiguous rows of a global batch, as the sharded
    steps take them (they place each position's rows on its device);
    the rows must split evenly over the grid's positions."""
    n = np.asarray(grid, dtype=object).size
    if len(local_rows) % n:
        raise ValueError(f"{len(local_rows)} local rows do not split over "
                         f"{n} grid positions")
    return torch.from_numpy(np.ascontiguousarray(local_rows))


def local_values(x) -> np.ndarray:
    """This process's rows of a result (a tensor, or the blocks of a
    sharded step in order), in row order, on the host."""
    if isinstance(x, torch.Tensor):
        return x.cpu().numpy()
    return np.concatenate([b.cpu().numpy() for b in x])


def all_ok(ok: bool) -> bool:
    """True when every process reports ``ok`` (a gloo all_gather of one
    small object each)."""
    if not dist.is_initialized():
        return ok
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, bool(ok))
    return all(got)
