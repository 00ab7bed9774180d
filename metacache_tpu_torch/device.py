"""Device selection, the device-memory budget for the database, and the
streams and host buffers of the summary path's pipeline.

Counterpart of metacache_tpu/utils/platform.py. ``get_device`` returns
the CUDA device when one is present; without one it raises unless
``MC_TORCH_DEVICE=cpu`` asks for the CPU (the counterpart of
``MC_JAX_PLATFORM``), so that no run silently falls back to the CPU.
``SideStream`` and ``Infeed`` take the place of what XLA schedules by
itself for JAX: the work of one dispatch beside another, and host to
device copies beside device compute.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


def get_device() -> torch.device:
    if os.environ.get("MC_TORCH_DEVICE") == "cpu":
        return torch.device("cpu")
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "no CUDA device is available; set MC_TORCH_DEVICE=cpu to run the "
        "plain PyTorch versions of the kernels on the CPU")


def hbm_budget_bytes(device: torch.device | None = None) -> int:
    """Device memory available for the database tables: the card's total
    memory minus a reserve of max(2 GiB, 20%) for batch working sets, the
    rule of metacache_tpu/utils/platform.py:81. MC_HBM_GB overrides the
    total (platform.py:55-61). On the CPU the total is taken as 16 GiB,
    so that layout choices in tests match the JAX package's CPU runs."""
    total = _total_bytes(device)
    reserve = max(2 << 30, total // 5)
    return max(total - reserve, 64 << 20)


def _total_bytes(device: torch.device | None) -> int:
    try:
        total = int(float(os.environ.get("MC_HBM_GB", "")) * 2**30)
    except ValueError:
        total = 0
    if total:
        return total
    if device is not None and device.type == "cuda":
        return torch.cuda.mem_get_info(device)[1]
    return 16 << 30


def free_bytes(device: torch.device) -> int:
    """Device memory a batch's working set can take now: on the card, the
    free memory plus what PyTorch's allocator holds unused; on the CPU,
    the reserve the budget above keeps for batch working sets (of 16 GiB,
    or MC_HBM_GB)."""
    if device.type == "cuda":
        free, _total = torch.cuda.mem_get_info(device)
        return free + torch.cuda.memory_reserved(device) - \
            torch.cuda.memory_allocated(device)
    return _total_bytes(device) - hbm_budget_bytes(device)


class SideStream:
    """A second stream of one device, for work that may run beside the
    current stream's: stage 1 (sketch + bucket probe) of the next batch
    of the pipelined scan, and phase 2 of the fused escalation dispatch
    (ops/rows.py). The two streams are ordered by events, and a tensor
    that one stream makes and the other reads is recorded for the reader
    (``Tensor.record_stream``), so that the caching allocator hands its
    memory out again only after the reader is done with it. On the CPU
    there is no stream: the same calls leave the work in issue order."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

    def run(self):
        """A context whose work goes to the side stream."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def follow(self, *tensors: torch.Tensor) -> None:
        """The side stream waits for the work issued so far on the current
        stream; ``tensors``, made there, are recorded for the side."""
        if self.stream is None:
            return
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        for t in tensors:
            t.record_stream(self.stream)

    def mark(self):
        """An event after the work issued so far on the side stream (None
        on the CPU)."""
        return None if self.stream is None else self.stream.record_event()

    def join(self, event, *tensors: torch.Tensor) -> None:
        """The current stream waits for ``event`` (``mark``); ``tensors``,
        made on the side stream, are recorded for the current one."""
        if self.stream is None:
            return
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(event)
        for t in tensors:
            t.record_stream(cur)


_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.int64): torch.int64}


class Infeed:
    """Host arrays to one device through a ring of ``slots`` host
    buffers: ``stage`` hands out numpy views into the next buffer, which
    the caller fills (stacking straight into them), and ``send`` copies
    the buffer's used bytes to the device in one non-blocking copy on a
    copy stream, which the current stream waits for by an event. On a
    CUDA device the buffers are pinned, so that the copy overlaps the
    device's compute instead of waiting for its stream, and a buffer is
    written again only after its last copy's event has completed. On the
    CPU the device tensors are views of the buffers themselves: work runs
    in issue order there, and a buffer comes round again only ``slots``
    stagings later."""

    ALIGN = 256         # bytes: every array starts at a multiple

    def __init__(self, device: torch.device, slots: int):
        self.device = torch.device(device)
        self.copy = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._bufs: list = [None] * slots
        self._copied: list = [None] * slots   # each buffer's last copy
        self._next = 0
        self._staged = None

    def stage(self, *specs) -> list:
        """(shape, numpy dtype) pairs -> numpy views of the next buffer,
        one an array, to be filled before ``send``."""
        specs = [(tuple(shape), np.dtype(dt)) for shape, dt in specs]
        sizes = [int(np.prod(shape, dtype=np.int64)) * dt.itemsize
                 for shape, dt in specs]
        offs = np.cumsum([0] + [-(-n // self.ALIGN) * self.ALIGN
                                for n in sizes]).tolist()
        j = self._next
        self._next = (j + 1) % len(self._bufs)
        if self._copied[j] is not None:
            self._copied[j].synchronize()     # its last copy has been read
            self._copied[j] = None
        buf = self._bufs[j]
        if buf is None or buf.numel() < offs[-1]:
            buf = self._bufs[j] = torch.empty(
                max(offs[-1], self.ALIGN), dtype=torch.uint8,
                pin_memory=self.copy is not None)
        host = buf.numpy()
        self._staged = (j, offs, sizes, specs)
        return [host[o:o + n].view(dt).reshape(shape)
                for o, n, (shape, dt) in zip(offs, sizes, specs)]

    def send(self) -> tuple:
        """The views of the last ``stage`` as tensors on the device."""
        j, offs, sizes, specs = self._staged
        self._staged = None
        buf = self._bufs[j]
        if self.copy is None:
            dev = buf
        else:
            cur = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy):
                dev = torch.empty(offs[-1], dtype=torch.uint8,
                                  device=self.device)
                dev.copy_(buf[:offs[-1]], non_blocking=True)
                self._copied[j] = self.copy.record_event()
            cur.wait_event(self._copied[j])
            dev.record_stream(cur)
        return tuple(dev[o:o + n].view(_TORCH_DTYPES[dt]).reshape(shape)
                     for o, n, (shape, dt) in zip(offs, sizes, specs))

    def put(self, *arrays: np.ndarray) -> tuple:
        """Arrays (any strides) -> the same on the device, in one copy."""
        for v, a in zip(self.stage(*((a.shape, a.dtype) for a in arrays)),
                        arrays):
            np.copyto(v, a)
        return self.send()
