# copied from metacache_tpu/native/__init__.py; the library is built from
# this package's own sources into the build directory, not beside them
"""Native (C++) host runtime: fast FASTA/FASTQ parsing, encoding,
windowing and per-read line formatting.

``get_lib`` compiles fastx.cpp and format.cpp with g++ at first use into
``build/metacache_tpu_torch/libfastx_<hash>.so`` (the directory of the
CUDA kernels, which git ignores), named by a hash of the sources and
flags so that an edit rebuilds, and loads it with ctypes. The Python
readers in seqio/ remain the portable fallback when it cannot be built.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys

import numpy as np

from ..kernels import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
SOURCES = ("fastx.cpp", "format.cpp")
# -l:libz.so.1 links the runtime library by its file name, so a host
# without the unversioned libz.so development link builds too
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
LIBS = ("-l:libz.so.1",)

_lib = None
_tried = False


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(_HERE, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(CXX_FLAGS + LIBS).encode())
    return os.path.join(BUILD_DIR, f"libfastx_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the reader if the library for these sources is missing;
    returns its path. Raises with the compiler's output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native reader cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, *[os.path.join(_HERE, s) for s in SOURCES],
           "-o", tmp, *LIBS]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"g++ failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, path)
    return path


def get_lib():
    """Load (building if needed) the native library; None if unavailable.
    MC_NATIVE=0 disables it (tests A/B the Python fallback paths)."""
    global _lib, _tried
    if os.environ.get("MC_NATIVE") == "0":
        return None
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        print(f"metacache_tpu_torch: native reader unavailable ({e}); "
              "using the Python readers", file=sys.stderr)
        return None
    lib.fastx_open.restype = ctypes.c_void_p
    lib.fastx_open.argtypes = [ctypes.c_char_p]
    lib.fastx_open_range.restype = ctypes.c_void_p
    lib.fastx_open_range.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                     ctypes.c_int64]
    lib.fastx_close.argtypes = [ctypes.c_void_p]
    lib.fastx_read_batch.restype = ctypes.c_int64
    lib.fastx_read_batch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.fastx_read_packed.restype = ctypes.c_int64
    lib.fastx_read_packed.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_void_p, ctypes.c_void_p]
    lib.encode_ascii.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                 ctypes.c_void_p]
    lib.fastx_scan.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                               ctypes.c_void_p]
    lib.extract_windows.restype = ctypes.c_int64
    lib.extract_windows.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    lib.format_map_lines.restype = ctypes.c_int64
    lib.format_map_lines.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,   # headers,n,hcap
        ctypes.c_int64,                                    # qid0 (-1 off)
        ctypes.c_void_p, ctypes.c_void_p,                  # best_sidx,skip
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, # cand s/f/h
        ctypes.c_int32, ctypes.c_int32,                    # k, show_tophits
        ctypes.c_void_p, ctypes.c_void_p,                  # strtab, stroff
        ctypes.c_void_p, ctypes.c_int64,                   # sep, sep_len
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]   # out,cap,bound
    _lib = lib
    return _lib


def format_map_lines(headers: np.ndarray, qid0: int,
                     best_sidx: np.ndarray, skip,
                     cand_sidx: np.ndarray, cand_flag: np.ndarray,
                     cand_hits: np.ndarray, show_tophits: bool,
                     strtab: bytes, stroff: np.ndarray,
                     sep: bytes) -> bytes | None:
    """Emit per-read mapping lines (MappingLineWriter.line layout) from
    string-table indices. qid0 = printed id of row 0, or -1 to omit the
    query-id column. Returns None when the native library is missing or
    the conservative size bound was exceeded (caller falls back)."""
    lib = get_lib()
    if lib is None:
        return None
    n, hcap = headers.shape
    k = cand_sidx.shape[1] if cand_sidx.ndim == 2 else 0
    maxstr = int(np.diff(stroff).max()) if len(stroff) > 1 else 0
    bound = (hcap + 4 * len(sep) + (maxstr + 24) * (k + 2) + 64)
    out = np.empty(n * bound + 64, np.uint8)
    headers = np.ascontiguousarray(headers)
    skip_p = (np.ascontiguousarray(skip, np.uint8).ctypes
              .data_as(ctypes.c_void_p)) if skip is not None else None
    wrote = lib.format_map_lines(
        headers.ctypes.data_as(ctypes.c_void_p), n, hcap,
        qid0,
        np.ascontiguousarray(best_sidx, np.int32).ctypes
          .data_as(ctypes.c_void_p),
        skip_p,
        np.ascontiguousarray(cand_sidx, np.int32).ctypes
          .data_as(ctypes.c_void_p),
        np.ascontiguousarray(cand_flag, np.uint8).ctypes
          .data_as(ctypes.c_void_p),
        np.ascontiguousarray(cand_hits, np.int32).ctypes
          .data_as(ctypes.c_void_p),
        k, int(show_tophits),
        strtab,
        np.ascontiguousarray(stroff, np.int64).ctypes
          .data_as(ctypes.c_void_p),
        sep, len(sep),
        out.ctypes.data_as(ctypes.c_void_p), out.nbytes, bound)
    if wrote < 0:
        return None
    return out[:wrote].tobytes()


def scan_file(path: str):
    """One-pass native scan -> (record_count, max_sequence_length)."""
    lib = get_lib()
    if lib is None:
        return None
    cnt = ctypes.c_int64(0)
    mx = ctypes.c_int64(0)
    lib.fastx_scan(path.encode(), ctypes.byref(cnt), ctypes.byref(mx))
    return int(cnt.value), int(mx.value)


def decode_header(row: np.ndarray) -> str:
    b = row.tobytes()
    end = b.find(b"\0")
    return (b[:end] if end >= 0 else b).decode(errors="replace")


class NativeFastxReader:
    """Batch reader over one FASTA/FASTQ(.gz) file using the C++ parser.

    ``start``/``end`` open a byte range of an uncompressed file for the
    parallel-reader partition (-threads): records whose first byte lies
    in [start, end). Raises ValueError when the range cannot be opened
    (compressed input, or no record boundary found)."""

    def __init__(self, path: str, max_len: int = 1024,
                 header_cap: int = 256, start: int = 0, end: int = -1):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self.lib = lib
        if start > 0 or end >= 0:
            self.h = lib.fastx_open_range(path.encode(), start, end)
            if not self.h:
                raise ValueError(
                    f"cannot open byte range [{start}, {end}) of {path}")
        else:
            self.h = lib.fastx_open(path.encode())
            if not self.h:
                raise FileNotFoundError(path)
        self.max_len = max_len
        self.header_cap = header_cap

    def read_batch_raw(self, max_reads: int):
        """-> (codes (n, max_len) u8, lens (n,) i32,
               raw_headers (n, header_cap) u8 NUL-terminated).

        Headers stay as raw bytes — decode lazily with decode_header()
        only when a read's header is actually printed.
        """
        codes = np.empty((max_reads, self.max_len), np.uint8)
        lens = np.empty(max_reads, np.int32)
        headers = np.empty((max_reads, self.header_cap), np.uint8)
        n = self.lib.fastx_read_batch(
            self.h, max_reads, self.max_len,
            codes.ctypes.data_as(ctypes.c_void_p),
            lens.ctypes.data_as(ctypes.c_void_p),
            headers.ctypes.data_as(ctypes.c_void_p), self.header_cap)
        n = int(n)
        return codes[:n], lens[:n], headers[:n]

    def read_batch(self, max_reads: int):
        """-> (codes, lens, headers list[str])."""
        codes, lens, headers = self.read_batch_raw(max_reads)
        return codes, lens, [decode_header(h) for h in headers]

    def read_batch_packed(self, max_reads: int, winlen: int,
                          side_cap: int = 4096):
        """Summary-fast-path read: clean short reads arrive 2-bit packed
        (the exact device infeed layout), long/ambiguous reads arrive
        unpacked in a side stream for the generic path.

        -> (packed (np, ceil(winlen/4)) u8, plens (np,) i32,
            scodes (ns, max_len) u8, slens (ns,) i32,
            sheaders (ns, header_cap) u8, consumed int).
        consumed == 0 signals EOF."""
        ps = (winlen + 3) // 4
        packed = np.empty((max_reads, ps), np.uint8)
        plens = np.empty(max_reads, np.int32)
        scodes = np.empty((side_cap, self.max_len), np.uint8)
        slens = np.empty(side_cap, np.int32)
        sheaders = np.empty((side_cap, self.header_cap), np.uint8)
        onp = ctypes.c_int64(0)
        ons = ctypes.c_int64(0)
        consumed = self.lib.fastx_read_packed(
            self.h, max_reads, winlen,
            packed.ctypes.data_as(ctypes.c_void_p),
            plens.ctypes.data_as(ctypes.c_void_p),
            side_cap, self.max_len,
            scodes.ctypes.data_as(ctypes.c_void_p),
            slens.ctypes.data_as(ctypes.c_void_p),
            sheaders.ctypes.data_as(ctypes.c_void_p), self.header_cap,
            ctypes.byref(onp), ctypes.byref(ons))
        n, s = int(onp.value), int(ons.value)
        return (packed[:n], plens[:n], scodes[:s], slens[:s],
                sheaders[:s], int(consumed))

    def close(self):
        if self.h:
            self.lib.fastx_close(self.h)
            self.h = None

    def __del__(self):
        self.close()


def extract_windows_batch(codes: np.ndarray, lens: np.ndarray,
                          winlen: int, stride: int, kmerlen: int,
                          cap_windows: int):
    """Native window extraction -> (windows, valid, qid, count)."""
    lib = get_lib()
    n, max_len = codes.shape
    windows = np.empty((cap_windows, winlen), np.uint8)
    valid = np.empty(cap_windows, np.int32)
    qid = np.empty(cap_windows, np.int32)
    codes = np.ascontiguousarray(codes)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    cnt = lib.extract_windows(
        codes.ctypes.data_as(ctypes.c_void_p),
        lens.ctypes.data_as(ctypes.c_void_p), n, max_len,
        winlen, stride, kmerlen,
        windows.ctypes.data_as(ctypes.c_void_p),
        valid.ctypes.data_as(ctypes.c_void_p),
        qid.ctypes.data_as(ctypes.c_void_p), cap_windows)
    return windows, valid, qid, int(cnt)
