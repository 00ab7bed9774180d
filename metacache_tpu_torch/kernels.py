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
           "candidates_wide.cu", "probe_decode.cu", "classify.cu")
HEADERS = ("block.cuh", "row_sort.cuh", "launch.cuh")
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
            f32 = ctypes.c_float
            lib.mc_sketch_windows.argtypes = [p, p, p, i64, i, i, i, i, p]
            lib.mc_sketch_windows_long.argtypes = [p, p, p, i64, i, i64, i,
                                                   i, p]
            lib.mc_sketch_windows64.argtypes = [p, p, p, i64, i, i64, i, i,
                                                i, p]
            lib.mc_sort_packed.argtypes = [p, p, i64, i, i, p]
            lib.mc_candidates_packed.argtypes = [p, p, p, i64, i, i, i, i,
                                                 i, i, p]
            lib.mc_candidates_unpacked.argtypes = [p, p, p, p, i64, i, i, i,
                                                   i, i, p]
            lib.mc_candidates_packed_wide.argtypes = [p, p, p, p, i64, i, i,
                                                      i, i, i, i, p]
            lib.mc_candidates_unpacked_wide.argtypes = [p, p, p, p, p, i64,
                                                        i, i, i, i, i, p]
            lib.mc_candidates_wide_work.argtypes = [i64, i, i, i]
            lib.mc_candidates_wide_work.restype = ctypes.c_size_t
            lib.mc_candidates_wide_cluster_info.argtypes = [i, i, i, p]
            lib.mc_candidates_wide_cluster_info.restype = ctypes.c_int
            lib.mc_sketch64_info.argtypes = [i, i, p]
            lib.mc_sketch64_info.restype = ctypes.c_int
            lib.mc_head_decode.argtypes = [p, i64, i, p, p, i64, i, i, i, p,
                                           p, p]
            lib.mc_full_decode.argtypes = [p, i64, i, p, i64, i, p, p, p,
                                           i64, i, i, i, i, p, p]
            lib.mc_oidx_decode.argtypes = [p, i64, i, p, p, i64, p, p]
            lib.mc_bucket_decode.argtypes = [p, i64, i, i, p, i, i64, i64,
                                             p, p, p]
            lib.mc_classed_bucket.argtypes = [p, i64, i, p, i64, p, p, p]
            lib.mc_classed_decode.argtypes = [p, i64, p, i64, i, p, p, i64,
                                              i, i, i, i, i, i, i, p, p, p,
                                              p]
            lib.mc_csr_decode.argtypes = [p, p, p, i64, p, p, i64, i64, i,
                                          i, i, i, p, p, p]
            lib.mc_dense_decode.argtypes = [p, i64, i, p, i64, i, p, p, i,
                                            i64, i, i, i, i, i, i, p, p, p]
            lib.mc_classify_lca.argtypes = [p, p, p, p, i64, p, i64, i, i64,
                                            i64, i, i, f32, i, i, p, p, p]
            lib.mc_rank_hist.argtypes = [p, i64, i64, p, i64, p, p, i, p, p,
                                         p]
            lib.mc_rank_hist_scratch_bytes.argtypes = []
            lib.mc_rank_hist_scratch_bytes.restype = i64
            lib.mc_launch_floor.argtypes = [i, i64, p]
            lib.mc_oidx_launch_floor.argtypes = [i64, p]
            for fn in (lib.mc_sketch_windows, lib.mc_sketch_windows_long,
                       lib.mc_sketch_windows64, lib.mc_sort_packed,
                       lib.mc_candidates_packed,
                       lib.mc_candidates_unpacked,
                       lib.mc_candidates_packed_wide,
                       lib.mc_candidates_unpacked_wide, lib.mc_head_decode,
                       lib.mc_full_decode, lib.mc_oidx_decode,
                       lib.mc_bucket_decode, lib.mc_classed_bucket,
                       lib.mc_classed_decode, lib.mc_csr_decode,
                       lib.mc_dense_decode, lib.mc_classify_lca,
                       lib.mc_rank_hist, lib.mc_launch_floor,
                       lib.mc_oidx_launch_floor):
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
# no TPU counterpart: JAX's k > 16 sketch is XLA (sketch_jax.py:103-152)
SKETCH64 = Kernel("mc_sketch_windows64",
                  "metacache_tpu/ops/sketch_jax.py:103",
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
CANDIDATES_WIDE = Kernel("mc_candidates_packed_wide",
                         "metacache_tpu/ops/candidates_pallas.py:429",
                         "metacache_tpu_torch/csrc/candidates_wide.cu")
CANDIDATES_UNPACKED_WIDE = Kernel(
    "mc_candidates_unpacked_wide",
    "metacache_tpu/ops/candidates_pallas.py:264",
    "metacache_tpu_torch/csrc/candidates_wide.cu")
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
# no TPU counterpart: JAX's classed bucket probe and classed cell decode
# are XLA ops (probe.py:167-212, rows.py:469-575)
CLASSED_BUCKET = Kernel("mc_classed_bucket",
                        "metacache_tpu/ops/probe.py:167",
                        "metacache_tpu_torch/csrc/probe_decode.cu")
CLASSED_DECODE = Kernel("mc_classed_decode", "metacache_tpu/ops/rows.py:469",
                        "metacache_tpu_torch/csrc/probe_decode.cu")
# no TPU counterpart: JAX's CSR probe gathers its slots with XLA
# (rows.py:784-838)
CSR_DECODE = Kernel("mc_csr_decode", "metacache_tpu/ops/rows.py:784",
                    "metacache_tpu_torch/csrc/probe_decode.cu")
# no TPU counterpart: JAX decodes its dense and two-tier lane rows with
# XLA ops (rows.py:624-838)
DENSE_DECODE = Kernel("mc_dense_decode", "metacache_tpu/ops/rows.py:624",
                      "metacache_tpu_torch/csrc/probe_decode.cu")
# no TPU counterpart: JAX's ranked LCA and its candidate-taxon lookup
# are XLA ops (pipeline.py:317-361, rows.py:171-173)
CLASSIFY_LCA = Kernel("mc_classify_lca",
                      "metacache_tpu/ops/pipeline.py:317",
                      "metacache_tpu_torch/csrc/classify.cu")
# no TPU counterpart: JAX's summary rank histogram is XLA ops
# (classify/runner.py:76-128)
RANK_HIST = Kernel("mc_rank_hist", "metacache_tpu/classify/runner.py:76",
                   "metacache_tpu_torch/csrc/classify.cu")
ALL = {"sketch": SKETCH, "sketch_long": SKETCH_LONG, "sketch64": SKETCH64,
       "sort": SORT,
       "candidates": CANDIDATES, "candidates_unpacked": CANDIDATES_UNPACKED,
       "candidates_wide": CANDIDATES_WIDE,
       "candidates_unpacked_wide": CANDIDATES_UNPACKED_WIDE,
       "head_decode": HEAD_DECODE, "full_decode": FULL_DECODE,
       "bucket_decode": BUCKET_DECODE, "oidx_decode": OIDX_DECODE,
       "classed_bucket": CLASSED_BUCKET, "classed_decode": CLASSED_DECODE,
       "csr_decode": CSR_DECODE, "dense_decode": DENSE_DECODE,
       "classify_lca": CLASSIFY_LCA, "rank_hist": RANK_HIST}


def rank_hist_scratch_bytes() -> int:
    """Device bytes of one scratch of rank_hist (csrc/classify.cu)."""
    return int(_load().mc_rank_hist_scratch_bytes())


def launch_floor(kind: int, n: int) -> None:
    """Launch an empty kernel on the current stream as classify_lca
    (kind 0) or rank_hist (1) at ``n`` reads, or B8 (2, oidx_decode) at
    ``n`` probes, is launched, the same grid and launch attributes: the
    launch floor of each kernel. Counts no launch of any kernel."""
    import torch
    dev = torch.cuda.current_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    lib = _load()
    err = (lib.mc_oidx_launch_floor(int(n), stream) if kind == 2 else
           lib.mc_launch_floor(int(kind), int(n), stream))
    if err != 0:
        raise RuntimeError(f"launch floor {kind} failed: CUDA error {err} "
                           f"({_lib.mc_error_string(err).decode()})")


def wide_work_bytes(b: int, l2: int, pairs: bool, kk: int) -> int:
    """Device bytes of the work space of B4's or B5's wide form
    (csrc/candidates_wide.cu) for (b, l2) rows and kk candidates."""
    return int(_load().mc_candidates_wide_work(b, l2, int(pairs), kk))


def wide_cluster_info(pairs: bool, clusters: int, kk: int = 2) -> dict:
    """The wide form's cluster kernel (csrc/candidates_wide.cu) for kk
    candidates at ``clusters`` blocks a cluster: the clusters the card
    can hold at once (cudaOccupancyMaxActiveClusters), registers and
    local (spill) bytes a thread, shared bytes a block."""
    info = (ctypes.c_int * 4)()
    err = _load().mc_candidates_wide_cluster_info(int(pairs), clusters, kk,
                                                  info)
    if err != 0:
        msg = _lib.mc_error_string(err).decode()
        raise RuntimeError(f"mc_candidates_wide_cluster_info failed: CUDA "
                           f"error {err} ({msg})")
    return dict(max_active_clusters=info[0], registers=info[1],
                local_bytes=info[2], shared_bytes=info[3])


def sketch64_info(packed: bool, multi: bool = False) -> dict:
    """The 64-bit sketch kernel (csrc/sketch.cu) on packed or coded rows,
    the coded ones of one chunk or (``multi``) of several: registers and
    local (spill) bytes a thread, static shared bytes a block."""
    info = (ctypes.c_int * 3)()
    err = _load().mc_sketch64_info(int(packed), int(multi), info)
    if err != 0:
        msg = _lib.mc_error_string(err).decode()
        raise RuntimeError(f"mc_sketch64_info failed: CUDA error {err} "
                           f"({msg})")
    return dict(registers=info[0], local_bytes=info[1],
                shared_bytes=info[2])


def reset_counts() -> None:
    for k in ALL.values():
        k.launches = 0
