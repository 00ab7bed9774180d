# copied from metacache_tpu/utils/progress.py
"""Progress reporting for long-running build/load phases.

The reference shows a live progress bar during database construction
(concurrent_progress + show_progress_indicator, src/cmdline_utility.cpp:
99-122). Here a single-line bar is rewritten in place when stderr is a
terminal, and coarse milestone lines are printed otherwise (so logs from
batch jobs stay readable).
"""
from __future__ import annotations

import sys


class ProgressBar:
    """`update(done, total)` renders `[=====>    ] 42%` on stderr."""

    def __init__(self, label: str = "", stream=None, width: int = 40):
        self.label = label
        self.stream = stream if stream is not None else sys.stderr
        self.width = width
        self._last_pct = -1
        self._tty = hasattr(self.stream, "isatty") and self.stream.isatty()

    def update(self, done: int, total: int):
        total = max(total, 1)
        pct = int(100 * min(done, total) / total)
        if pct == self._last_pct:
            return
        self._last_pct = pct
        if self._tty:
            filled = self.width * pct // 100
            arrow = ">" if filled < self.width else "="
            bar = "=" * filled + arrow + " " * (self.width - filled)
            self.stream.write(f"\r{self.label}[{bar}] {pct:3d}%")
            if pct >= 100:
                self.stream.write("\n")
            self.stream.flush()
        elif pct % 10 == 0:
            self.stream.write(f"{self.label}{pct}%\n")
            self.stream.flush()

    def finish(self):
        self.update(1, 1)
