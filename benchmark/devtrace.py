"""Reading of a torch.profiler trace: what ran on the device, when it
was idle, and what the host was doing then.

The trace is the profiler's Chrome-trace export. Device activity is
every kernel, copy and fill ("kernel", "gpu_memcpy", "gpu_memset"); host
activity every operator, runtime call and annotation on the host. The
traced window runs from the start of the first ``WINDOW_MARK``
annotation to the end of the last.

The profiler records no Python, so ``PySampler`` samples the window's
thread beside it: the innermost frame of the program's package every
few milliseconds. An idle gap is named by the host operation open at
its middle, or where none is, by the sample nearest to it.
"""
from __future__ import annotations

import json
import os
import re
import sys
import threading
import time
from dataclasses import dataclass

import numpy as np

WINDOW_MARK = "bench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
#: the host event a gap is named by when none but the window mark is open
#: and no sample of the Python stack is near
OUTSIDE_OPS = "host work outside torch operations"
PACKAGE = "metacache_tpu_torch"


class PySampler:
    """Samples a thread's Python stack every ``interval`` seconds from a
    helper thread: (time in us on the perf_counter clock, the innermost
    frame of ``PACKAGE`` as "py: <file>:<function>", or of any file where
    none is)."""

    def __init__(self, interval: float = 0.002):
        self.interval = interval
        self.tid = threading.get_ident()
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=10)

    def _run(self):
        sep = os.sep + PACKAGE + os.sep
        while not self._stop.wait(self.interval):
            f = sys._current_frames().get(self.tid)
            if f is None:
                continue
            t = time.perf_counter() * 1e6
            first, label = f, None
            while f is not None:
                fn = f.f_code.co_filename
                if sep in fn:
                    label = fn.split(sep, 1)[1] + ":" + f.f_code.co_name
                    break
                f = f.f_back
            if label is None:
                label = os.path.basename(first.f_code.co_filename) + ":" + \
                    first.f_code.co_name
            self.samples.append((t, "py: " + label))


def short_name(name: str, limit: int = 96) -> str:
    """A device operation's name without its argument list, return type
    and namespaces of no meaning, at most ``limit`` characters."""
    n = name
    for junk in ("void ", "(anonymous namespace)::", "at_cuda_detail::",
                 "at::native::"):
        n = n.replace(junk, "")
    depth, cut = 0, len(n)
    for i, ch in enumerate(n):
        if ch in "<":
            depth += 1
        elif ch in ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i and n[i - 1] != " ":
            cut = i
            break
    n = re.sub(r"\s+", " ", n[:cut])
    return n if len(n) <= limit else n[:limit - 3] + "..."


@dataclass
class Trace:
    lo: float                  # window start (us, the trace's clock)
    hi: float                  # window end
    dev_name: np.ndarray       # device activities: name, category, start,
    dev_cat: np.ndarray        # duration (us), those within the window
    dev_ts: np.ndarray
    dev_dur: np.ndarray
    host_name: np.ndarray      # host events, by start
    host_ts: np.ndarray
    host_end: np.ndarray
    py_ts: np.ndarray = None   # Python stack samples on the trace's clock
    py_name: np.ndarray = None

    def add_samples(self, samples: list, t_mark_us: float) -> None:
        """Samples of ``PySampler``, whose clock read ``t_mark_us`` when
        the first window mark opened (the trace's ``lo``)."""
        off = self.lo - t_mark_us
        self.py_ts = np.array([t + off for t, _n in samples], float)
        self.py_name = np.array([n for _t, n in samples], object)

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def kernels(self):
        """(names, durations in seconds) of the window's kernels."""
        k = self.dev_cat == "kernel"
        return self.dev_name[k], self.dev_dur[k] / 1e6

    def busy_intervals(self) -> np.ndarray:
        """The union of device activity clipped to the window, as sorted
        disjoint (start, end) rows."""
        s = np.clip(self.dev_ts, self.lo, self.hi)
        e = np.clip(self.dev_ts + self.dev_dur, self.lo, self.hi)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        if len(s) == 0:
            return np.zeros((0, 2))
        reach = np.maximum.accumulate(e)
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > reach[:-1]
        group = np.cumsum(new) - 1
        starts = s[new]
        ends = np.zeros(len(starts))
        np.maximum.at(ends, group, e)
        return np.stack([starts, ends], 1)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6

    def gaps(self) -> np.ndarray:
        """Idle (start, end) intervals of the window."""
        iv = self.busy_intervals()
        starts = np.concatenate([[self.lo], iv[:, 1]])
        ends = np.concatenate([iv[:, 0], [self.hi]])
        keep = ends > starts
        return np.stack([starts[keep], ends[keep]], 1)

    def host_at(self, t: np.ndarray, depth: int = 64,
                near_us: float = 5000.0) -> np.ndarray:
        """The name of the latest-started host event open at each time in
        ``t`` (the innermost one of its thread, as a rule); where only the
        window mark is open, the Python sample nearest in time (within
        ``near_us``), else OUTSIDE_OPS."""
        out = np.full(len(t), OUTSIDE_OPS, dtype=object)
        if self.py_ts is not None and len(self.py_ts):
            # the nearer of the samples on either side of each time
            hi = np.clip(np.searchsorted(self.py_ts, t), 0,
                         len(self.py_ts) - 1)
            lo = np.maximum(hi - 1, 0)
            j = np.where(np.abs(self.py_ts[lo] - t) <
                         np.abs(self.py_ts[hi] - t), lo, hi)
            near = np.abs(self.py_ts[j] - t) <= near_us
            out[near] = self.py_name[j[near]]
        if len(self.host_ts) == 0:
            return out
        i = np.searchsorted(self.host_ts, t, side="right") - 1
        found = np.zeros(len(t), bool)
        for d in range(depth):
            j = i - d
            ok = ~found & (j >= 0)
            jj = np.where(ok, j, 0)
            hit = ok & (self.host_end[jj] > t) & \
                (self.host_name[jj] != WINDOW_MARK)
            out[hit] = self.host_name[jj[hit]]
            found |= hit
        return out


def load(path: str) -> Trace:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    marks = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == WINDOW_MARK]
    if not marks:
        raise ValueError(f"the trace holds no {WINDOW_MARK!r} annotation")
    lo, hi = min(m[0] for m in marks), max(m[1] for m in marks)
    dev = [e for e in events if e.get("ph") == "X" and
           e.get("cat") in DEVICE_CATS and
           e["ts"] < hi and e["ts"] + e.get("dur", 0) > lo]
    host = sorted((e for e in events if e.get("ph") == "X" and
                   e.get("cat") in HOST_CATS),
                  key=lambda e: e["ts"])

    def arr(evs, key, dtype=float):
        return np.array([e.get(key, 0) for e in evs], dtype=dtype)

    return Trace(lo=float(lo), hi=float(hi),
                 dev_name=arr(dev, "name", object),
                 dev_cat=arr(dev, "cat", object),
                 dev_ts=arr(dev, "ts"), dev_dur=arr(dev, "dur"),
                 host_name=arr(host, "name", object),
                 host_ts=arr(host, "ts"),
                 host_end=arr(host, "ts") + arr(host, "dur"))


def top(names: np.ndarray, seconds: np.ndarray, n: int = 10) -> list:
    """[[name, seconds], ...]: the ``n`` names with the most seconds."""
    tot: dict = {}
    for a, s in zip(names.tolist(), seconds.tolist()):
        tot[a] = tot.get(a, 0.0) + s
    return [[a, s] for a, s in sorted(tot.items(), key=lambda x: -x[1])[:n]]


def breakdown(tr: Trace, stage_of) -> dict:
    """The device operations that took most time (kernels by stage where
    a kernel file names them, "other: <name>" where none does, copies and
    fills by name), and the idle time by what the host was doing during
    it."""
    names = np.array([(f"{stage_of(n)}: " if stage_of(n) else "other: ") +
                      short_name(n) if c == "kernel" else short_name(n)
                      for n, c in zip(tr.dev_name, tr.dev_cat)], object)
    g = tr.gaps()
    mid = (g[:, 0] + g[:, 1]) / 2
    return {"device_ops": top(names, tr.dev_dur / 1e6),
            "idle_gaps": top(tr.host_at(mid), (g[:, 1] - g[:, 0]) / 1e6)}
