"""Batched sketching of reference windows for database builds.

Copied from metacache_tpu/db/sketch_exec.py:92-164 (``SketchAccumulator``)
onto the port's sketcher: targets are batched across in queue order, so
the emitted (feature, location) stream stays ascending in (tgt, win),
which FeatureTable.build's presorted path relies on, and each batch is
sketched on the card by kernel B1, or B2 for windows wider than 128
characters (their plain versions on the CPU). ``DeviceSketchAccumulator``
(sketch_exec.py:167-269) keeps the (feature, target, window) stream on
the card for the device table builder (ops/table_device.py).
"""
from __future__ import annotations

import collections

import numpy as np
import torch

from ..device import get_device
from ..ops.sketch import sketch_windows
from ..ops.table import pack_locations

_BATCH = 65536  # windows per device call (sketch_exec.py:23)


def sketch_windows_batched(wm: np.ndarray, vl: np.ndarray, k: int,
                           sketchlen: int, device: torch.device,
                           batch: int = _BATCH) -> np.ndarray:
    """(n, winlen) u8 windows + (n,) valid lengths -> (n, sketchlen) u32
    sketches, ``batch`` windows per device call."""
    out = np.empty((len(wm), sketchlen), np.uint32)
    for beg in range(0, len(wm), batch):
        end = min(beg + batch, len(wm))
        w = torch.from_numpy(np.ascontiguousarray(wm[beg:end])).to(device)
        v = torch.from_numpy(np.ascontiguousarray(vl[beg:end],
                                                  np.int32)).to(device)
        out[beg:end] = sketch_windows(w, v, k, sketchlen).cpu().numpy() \
            .view(np.uint32)
    return out


class SketchAccumulator:
    """Accumulates per-target window matrices and sketches them in large
    cross-target device batches. ``device`` None means get_device() at
    the first batch."""

    def __init__(self, k: int, sketchlen: int,
                 device: torch.device | None = None, batch: int = _BATCH):
        self.k = k
        self.sketchlen = sketchlen
        self.device = device
        self.batch = batch
        # queue of (windows, valid, target_id, first_window_id)
        self._q: collections.deque = collections.deque()
        self._nwin = 0
        self.features: list[np.ndarray] = []   # u32 chunks
        self.locations: list[np.ndarray] = []  # u64 chunks

    def add_target(self, wm: np.ndarray, vl: np.ndarray, tid: int):
        """Queue one target's window matrix (nw, winlen)."""
        if len(wm) == 0:
            return
        self._q.append((wm, vl, tid, 0))
        self._nwin += len(wm)
        while self._nwin >= self.batch:
            self._flush(self.batch)

    def _flush(self, nw: int):
        """Sketch exactly nw queued windows (nw <= self._nwin)."""
        take = []
        left = nw
        while left:
            wm, vl, tid, win0 = self._q.popleft()
            if len(wm) <= left:
                take.append((wm, vl, tid, win0))
                left -= len(wm)
            else:
                take.append((wm[:left], vl[:left], tid, win0))
                self._q.appendleft((wm[left:], vl[left:], tid, win0 + left))
                left = 0
        self._nwin -= nw
        self._sketch_and_emit(take)

    def _sketch_and_emit(self, take):
        if self.device is None:
            self.device = get_device()
        wm = np.concatenate([t[0] for t in take], axis=0)
        vl = np.concatenate([t[1] for t in take])
        feats = sketch_windows_batched(wm, vl, self.k, self.sketchlen,
                                       self.device, self.batch)
        beg = 0
        for m, _v, tid, win0 in take:
            cnt = len(m)
            f = feats[beg:beg + cnt]
            beg += cnt
            wid = np.broadcast_to(
                (win0 + np.arange(cnt, dtype=np.uint32))[:, None], f.shape)
            mask = f != f.dtype.type(np.iinfo(f.dtype).max)
            self.features.append(f[mask])
            self.locations.append(pack_locations(
                np.full(int(mask.sum()), tid, np.uint32), wid[mask]))

    def finish(self):
        """Sketch remaining windows; -> (features u32, locations u64)."""
        if self._nwin:
            self._flush(self._nwin)
        if self.features:
            f = np.concatenate(self.features)
            l = np.concatenate(self.locations)
        else:
            f = np.zeros(0, np.uint32)
            l = np.zeros(0, np.uint64)
        self.features, self.locations = [], []
        return f, l


# sketch_exec.py:167-269: the SketchAccumulator above, its stream left on
# the card
class DeviceSketchAccumulator(SketchAccumulator):
    """SketchAccumulator whose (feature, tgt, win) stream stays on the
    device, for ops/table_device.py::build_device_table_chunked: a
    build never copies its sketches or its probe rows through the host.
    Sentinel feature slots (empty sketch lanes) are kept; the builder
    drops them."""

    def __init__(self, k: int, sketchlen: int,
                 device: torch.device | None = None, batch: int = _BATCH):
        super().__init__(k, sketchlen, device, batch)
        self.chunks: list = []    # (features, tgt, win) flat int32 tensors

    def _sketch_and_emit(self, take):
        if self.device is None:
            self.device = get_device()
        wm = np.concatenate([t[0] for t in take], axis=0)
        vl = np.concatenate([t[1] for t in take]).astype(np.int32)
        tid = np.concatenate([np.full(len(m), t_, np.int32)
                              for (m, _v, t_, _w0) in take])
        wid = np.concatenate([w0 + np.arange(len(m), dtype=np.int32)
                              for (m, _v, _t, w0) in take])
        s = self.sketchlen

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
        f = sketch_windows(dev(wm), dev(vl), self.k, s)
        self.chunks.append((f.reshape(-1),
                            dev(tid).repeat_interleave(s),
                            dev(wid).repeat_interleave(s)))

    def finish_chunks(self) -> list:
        """Sketch the remaining windows; -> the list of (features int32
        bit patterns, tgt int32, win int32) flat device chunks. Never
        concatenates: the builder consumes the list chunk by chunk."""
        if self._nwin:
            self._flush(self._nwin)
        chunks, self.chunks = self.chunks, []
        return chunks
