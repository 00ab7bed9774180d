"""Time B4's and B5's wide form (metacache_tpu_torch's
csrc/candidates_wide.cu) of this checkout against the same C entry
points built from another revision's source, on one CUDA card, and
split the cluster kernel's time by timing two patched copies of it.

    git show <rev>:metacache_tpu_torch/csrc/candidates_wide.cu > base.cu
    python3 tools/torch_wide_ab.py base.cu

Both take chip_smoke.py's wide parity rows: packed rows of 65,536,
131,072 and 262,144 slots in alternating runs of 256 (dedup 16, 32 and
48) and pairs of 32,768, 65,536 and 131,072 (dedup 6), K = 2. The
base's results must equal this checkout's. Each call is timed with
chip_smoke.kernel_ms (the base's work space allocated once, outside
the graph) in turns: base, this, this, base. Then this checkout's source
is copied and patched twice, without its merge levels and without its
sweep (timing ablations whose results are wrong); their differences
from the whole kernel split its time. Prints the card's name and power
limit, then one line a shape.
"""
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (blocks JAX and the JAX package)
import numpy as np  # noqa: E402
import torch  # noqa: E402

from metacache_tpu_torch import kernels  # noqa: E402
from metacache_tpu_torch.ops import candidates as C  # noqa: E402

# this checkout's kernel patched for the timing ablations: (text, its
# replacement), each text found exactly once
ABLATIONS = {
    "no_levels": ("  if (r < l2) {\n    constexpr int H = T / 2;",
                  "  if (false) {\n    constexpr int H = T / 2;"),
    "no_sweep": ("for (int c = c0 + tid; c < c1; c += NT) {",
                 "for (int c = c1; c < c1; c += NT) {"),
}


def sources(base: str) -> dict:
    """name -> the source file to build: the base, and this checkout's
    kernel copied and patched once for each ablation."""
    own = os.path.join(kernels.CSRC, "candidates_wide.cu")
    with open(own) as f:
        text = f.read()
    out = {"base": base}
    for name, (old, new) in ABLATIONS.items():
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {own} once")
        path = os.path.join(kernels.BUILD_DIR, f"wide_{name}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        out[name] = path
    return out


def build(srcs: dict) -> dict:
    """Each source built as kernels.py builds the port's, beside this
    checkout's headers, one nvcc each, in parallel -> name -> library
    with the wide entry points' argument types set."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
         "-shared", src, "-o",
         os.path.join(kernels.BUILD_DIR, f"wide_{name}.so")])
        for name, src in srcs.items()}
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} build")
        lib = ctypes.CDLL(os.path.join(kernels.BUILD_DIR, f"wide_{name}.so"))
        lib.mc_candidates_packed_wide.argtypes = [p, p, p, p, i64, i, i, i,
                                                  i, i, i, p]
        lib.mc_candidates_unpacked_wide.argtypes = [p, p, p, p, p, i64, i,
                                                    i, i, i, i, p]
        lib.mc_candidates_wide_work.argtypes = [i64, i, i, i]
        lib.mc_candidates_wide_work.restype = ctypes.c_size_t
        libs[name] = lib
    return libs


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    libs = build(sources(sys.argv[1]))
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(1234)
    r, kk = 256, 2

    def launch(fn, *args):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"wide form launch failed: CUDA error {err}")

    cases = []
    for b, f, m in ((512, 256, 16), (128, 512, 32), (64, 1024, 48)):
        pk = torch.from_numpy(cs.alternating_runs(rng, b, f, r)).to(dev)
        cases.append(("B4", pk, None, m))
    for b, f in ((512, 128), (128, 256), (64, 512)):
        tt, ww = (torch.from_numpy(x).to(dev)
                  for x in cs.alternating_pairs(rng, b, f, r))
        cases.append(("B5", tt, ww, 6))
    for name, x, y, m in cases:
        b, l2 = x.shape
        mw = torch.full((b,), m, dtype=torch.int32, device=dev)
        work = torch.empty(libs["base"].mc_candidates_wide_work(
            b, l2, y is not None, kk), dtype=torch.uint8, device=dev)
        res = torch.empty((b, kk, 4), dtype=torch.int32, device=dev)
        if y is None:
            def run(lib):
                launch(lib.mc_candidates_packed_wide, x.data_ptr(),
                       mw.data_ptr(), res.data_ptr(), work.data_ptr(), b,
                       l2, r, 15, 0, m, kk)

            def this():
                return C.candidates_packed(x, mw, 15, dedup_walk=m,
                                           max_candidates=kk, presorted=r)
        else:
            def run(lib):
                launch(lib.mc_candidates_unpacked_wide, x.data_ptr(),
                       y.data_ptr(), mw.data_ptr(), res.data_ptr(),
                       work.data_ptr(), b, l2, r, 0, m, kk)

            def this():
                return C.candidates_unpacked(x, y, mw, dedup_walk=m,
                                             max_candidates=kk, presorted=r)

        def base():
            run(libs["base"])
        base()
        cs.check_equal(f"{name} wide {b}x{l2} base vs this", res,
                       torch.stack(this(), 2))
        t = [cs.kernel_ms(base, reps=5), cs.kernel_ms(this, reps=5),
             cs.kernel_ms(this, reps=5), cs.kernel_ms(base, reps=5)]
        parts = {f"this_{k}_ms": cs.kernel_ms(lambda k=k: run(libs[k]),
                                              reps=5) for k in ABLATIONS}
        cs.say(f"wide-ab-{name}", shape=(b, l2), dedup=m, K=kk,
               route=C.wide_route(l2, y is not None), results_equal=True,
               base_ms=(t[0] + t[3]) / 2, this_ms=(t[1] + t[2]) / 2,
               turns=t, base_work_bytes=work.numel(), **parts)
        del work
    return 0


if __name__ == "__main__":
    sys.exit(main())
