"""Build, load and launch the hand-written Hopper kernels.

The CUDA sources under ``csrc/`` expose a plain C interface. At first
use each source is compiled with ``nvcc`` for ``sm_90a`` to an object,
all of them at once in parallel, and the objects are linked into one
shared library under ``build/metacache_tpu_torch/`` beside the package
(a directory git ignores), named by a hash of the sources and headers so
that an edit rebuilds, and loaded with ``ctypes``. Nothing here is
imported or built until a kernel is launched on a CUDA tensor.

Every C entry point returns ``cudaGetLastError()`` after its launch; a
non-zero code raises. Each kernel keeps a plain-integer launch count,
which ``chip_smoke.py`` reads to show that the main path ran through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
SOURCES = ("sketch.cu", "candidates.cu", "candidates_unpacked.cu",
           "probe_decode.cu")
HEADERS = ("block.cuh", "row_sort.cuh")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "metacache_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(cand):
            exe = cand
    if exe is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return exe


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libmc_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> str:
    """Compile the kernels if the library for these sources is missing;
    returns its path. Raises with the compiler's output on failure."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{os.path.splitext(s)[0]}.o" for s in SOURCES]
    procs = []
    for src, obj in zip(SOURCES, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", os.path.join(CSRC, src), "-o", obj]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for src, proc in procs:
        _out, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src} ({proc.returncode}):\n{err}")
        elif verbose and err:
            print(err)
    if not errors:
        r = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                           capture_output=True, text=True)
        if r.returncode != 0:
            errors.append(f"nvcc link failed ({r.returncode}):\n{r.stderr}")
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    if errors:
        raise RuntimeError("\n".join(errors))
    os.replace(tmp, path)
    return path


def _load():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.mc_sketch_windows.argtypes = [p, p, p, i64, i, i, i, i, p]
            lib.mc_sketch_windows_long.argtypes = [p, p, p, i64, i, i64, i,
                                                   i, p]
            lib.mc_sort_packed.argtypes = [p, p, i64, i, i, p]
            lib.mc_candidates_packed.argtypes = [p, p, p, i64, i, i, i, i,
                                                 i, i, p]
            lib.mc_candidates_unpacked.argtypes = [p, p, p, p, i64, i, i, i,
                                                   i, i, p]
            lib.mc_head_decode.argtypes = [p, i64, i, p, p, i64, i, i, i, p,
                                           p, p]
            lib.mc_full_decode.argtypes = [p, i64, i, p, i64, i, p, p, p,
                                           i64, i, i, i, i, p, p]
            lib.mc_oidx_decode.argtypes = [p, i64, i, p, p, i64, p, p]
            lib.mc_bucket_decode.argtypes = [p, i, p, i64, p, p, p]
            for fn in (lib.mc_sketch_windows, lib.mc_sketch_windows_long,
                       lib.mc_sort_packed,
                       lib.mc_candidates_packed,
                       lib.mc_candidates_unpacked, lib.mc_head_decode,
                       lib.mc_full_decode, lib.mc_oidx_decode,
                       lib.mc_bucket_decode):
                fn.restype = ctypes.c_int
            lib.mc_error_string.argtypes = [i]
            lib.mc_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def _stream_getter():
    """-> a function giving the current CUDA stream of the current device
    as an int (what torch.cuda.current_stream().cuda_stream gives,
    without building a Stream object a launch)."""
    import torch
    raw, device = torch._C._cuda_getCurrentRawStream, torch._C._cuda_getDevice
    return lambda: raw(device())


class Kernel:
    """One C entry point of the kernel library plus its launch count."""

    def __init__(self, symbol: str, replaces: str, source: str):
        self.symbol = symbol
        self.replaces = replaces
        self.source = source
        self.launches = 0
        self._fn = None
        self._stream = None

    def _bind(self):
        """Load the library (built at first use) and keep this entry
        point and the stream getter; later launches take no lock."""
        self._stream = _stream_getter()
        self._fn = getattr(_load(), self.symbol)
        return self._fn

    def __call__(self, *args) -> None:
        """Launch on the current CUDA stream (appended as the last
        argument); tensors pass as ``data_ptr()`` ints."""
        fn = self._fn or self._bind()
        err = fn(*args, self._stream())
        if err != 0:
            raise RuntimeError(
                f"{self.symbol} failed: CUDA error {err} "
                f"({_lib.mc_error_string(err).decode()})")
        self.launches += 1


SKETCH = Kernel("mc_sketch_windows",
                "metacache_tpu/ops/sketch_pallas.py:247",
                "metacache_tpu_torch/csrc/sketch.cu")
SKETCH_LONG = Kernel("mc_sketch_windows_long",
                     "metacache_tpu/ops/sketch_pallas.py:200",
                     "metacache_tpu_torch/csrc/sketch.cu")
SORT = Kernel("mc_sort_packed",
              "metacache_tpu/ops/candidates_pallas.py:395",
              "metacache_tpu_torch/csrc/candidates.cu")
CANDIDATES = Kernel("mc_candidates_packed",
                    "metacache_tpu/ops/candidates_pallas.py:429",
                    "metacache_tpu_torch/csrc/candidates.cu")
CANDIDATES_UNPACKED = Kernel("mc_candidates_unpacked",
                             "metacache_tpu/ops/candidates_pallas.py:264",
                             "metacache_tpu_torch/csrc/candidates_unpacked.cu")
HEAD_DECODE = Kernel("mc_head_decode",
                     "metacache_tpu/ops/probe_pallas.py:279",
                     "metacache_tpu_torch/csrc/probe_decode.cu")
FULL_DECODE = Kernel("mc_full_decode",
                     "metacache_tpu/ops/probe_pallas.py:356",
                     "metacache_tpu_torch/csrc/probe_decode.cu")
OIDX_DECODE = Kernel("mc_oidx_decode",
                     "metacache_tpu/ops/probe_pallas.py:209",
                     "metacache_tpu_torch/csrc/probe_decode.cu")
BUCKET_DECODE = Kernel("mc_bucket_decode",
                       "metacache_tpu/ops/probe_pallas.py:151",
                       "metacache_tpu_torch/csrc/probe_decode.cu")
ALL = {"sketch": SKETCH, "sketch_long": SKETCH_LONG, "sort": SORT,
       "candidates": CANDIDATES, "candidates_unpacked": CANDIDATES_UNPACKED,
       "head_decode": HEAD_DECODE, "full_decode": FULL_DECODE,
       "bucket_decode": BUCKET_DECODE, "oidx_decode": OIDX_DECODE}


def reset_counts() -> None:
    for k in ALL.values():
        k.launches = 0
