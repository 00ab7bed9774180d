# copied from metacache_tpu/utils/info.py
"""Runtime status verbosity (reference: info_level, src/io_options.hpp:
27-33 — silent / moderate / verbose, set by -silent / -verbose).

Gates stderr status chatter only (load/save/progress messages), never
classification output: the reference likewise routes infoLevel to its
status stream (src/mode_query.cpp:57-60, building.cpp:198).
"""
from __future__ import annotations

import sys

SILENT, MODERATE, VERBOSE = 0, 1, 2
_level = MODERATE
_show_errors = True


def set_level(level: int) -> None:
    global _level
    _level = level


def set_show_errors(on: bool) -> None:
    """-no-err / -noerr / -no-errors (reference: output.showErrors,
    src/options.cpp:1268)."""
    global _show_errors
    _show_errors = on


def error(msg: str) -> None:
    """One error/warning line on stderr unless -no-err."""
    if _show_errors:
        print(msg, file=sys.stderr, flush=True)


def level() -> int:
    return _level


def show_info() -> bool:
    return _level != SILENT


def status(msg: str) -> None:
    """One status line on stderr unless -silent."""
    if _level != SILENT:
        print(msg, file=sys.stderr, flush=True)
