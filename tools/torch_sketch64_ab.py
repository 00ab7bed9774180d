"""Time the 64-bit sketch kernel (metacache_tpu_torch's csrc/sketch.cu,
mc_sketch_windows64) of this checkout against the same C entry point
built from another revision's source, on one CUDA card, and split its
time by timing two patched copies of it.

    git show <rev>:metacache_tpu_torch/csrc/sketch.cu > base.cu
    python3 tools/torch_sketch64_ab.py base.cu

Both take chip_smoke.py's sketch64 parity rows (sketch64_shapes) at
k = 18, s = 16: the build's (65536, 128) coded windows, the summary
path's packed rows (8192, 28 bytes), 250 bp windows (8192, 256), and
windows of several 128-start chunks, (8192, 511) and (2048, 1024),
each beside its bound (sketch64_work). The base's results must
equal this checkout's. Each call is timed with chip_smoke.kernel_ms in
turns: base, this, this, base. Then this checkout's source is copied and
patched twice, without the selection (each lane stores the xor of its 4
hashes instead of the rounds) and without the k-mer hashing (a constant
of the start instead of the canonical k-mer's hash); these are timing
ablations whose results are wrong, and their differences from the whole
kernel split its time. Prints the card's name and power limit, this
kernel's registers and spill bytes, then one line a shape.
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

K, S = 18, 16
# this checkout's kernel patched for the timing ablations: name -> list
# of (text, its replacement), each text found exactly once
ABLATIONS = {
    "no_select": [
        ("    select64<false>(v, run, lane, s, dst);\n",
         "    if (lane < s) dst[lane] = v[0] ^ v[1] ^ v[2] ^ v[3];\n"),
        ("      select64<true>(v, run, lane, s, dst);\n",
         "      run[0] ^= v[0] ^ v[1] ^ v[2] ^ v[3];\n")],
    "no_hash": [
        ("v[j] = ok ? murmur3_fmix64(fw < rc ? fw : rc) : kSent64;",
         "v[j] = ok ? (uint64_t)(lo + 4 * lane + j + 1) * "
         "0x9E3779B97F4A7C15ull : kSent64;")],
}


def sources(base: str) -> dict:
    """name -> the source file to build: the base, this checkout's
    kernel, and its copies patched once for each ablation."""
    own = os.path.join(kernels.CSRC, "sketch.cu")
    with open(own) as f:
        text = f.read()
    out = {"base": base, "this": own}
    for name, patches in ABLATIONS.items():
        patched = text
        for old, new in patches:
            if patched.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not in {own} once")
            patched = patched.replace(old, new)
        path = os.path.join(kernels.BUILD_DIR, f"sketch64_{name}.cu")
        with open(path, "w") as f:
            f.write(patched)
        out[name] = path
    return out


def build(srcs: dict) -> dict:
    """Each source built as kernels.py builds the port's, one nvcc each,
    in parallel -> name -> library with mc_sketch_windows64's argument
    types set."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src, "-o",
         os.path.join(kernels.BUILD_DIR, f"sketch64_{name}.so")])
        for name, src in srcs.items()}
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} build")
        lib = ctypes.CDLL(os.path.join(kernels.BUILD_DIR,
                                       f"sketch64_{name}.so"))
        lib.mc_sketch_windows64.argtypes = [p, p, p, i64, i, i64, i, i, i, p]
        lib.mc_sketch_windows64.restype = ctypes.c_int
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
    cs.say("sketch64-ab-kernel", **cs.sketch64_resources())
    dev = torch.device("cuda")
    shapes = cs.sketch64_shapes(np.random.default_rng(64))
    for name, (hc, hv, packed) in shapes.items():
        c, v = torch.from_numpy(hc).to(dev), torch.from_numpy(hv).to(dev)
        n, w = c.shape
        res = {lib: torch.empty((n, S), dtype=torch.int64, device=dev)
               for lib in libs}

        def run(lib):
            err = libs[lib].mc_sketch_windows64(
                c.data_ptr(), v.data_ptr(), res[lib].data_ptr(), n, w,
                c.stride(0), K, S, int(packed),
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"{lib}: CUDA error {err}")
        run("base")
        run("this")
        cs.check_equal(f"sketch64 {name} base vs this", res["base"],
                       res["this"])
        t = [cs.kernel_ms(lambda: run("base")),
             cs.kernel_ms(lambda: run("this")),
             cs.kernel_ms(lambda: run("this")),
             cs.kernel_ms(lambda: run("base"))]
        parts = {f"this_{a}_ms": cs.kernel_ms(lambda a=a: run(a))
                 for a in ABLATIONS}
        b_ms, by = cs.bound(*cs.sketch64_work(hc, hv, packed, S))
        cs.say(f"sketch64-ab-{name}", k=K, s=S, results_equal=True,
               base_ms=(t[0] + t[3]) / 2, this_ms=(t[1] + t[2]) / 2,
               turns=t, bound_ms=b_ms, bound_by=by, **parts)
    return 0


if __name__ == "__main__":
    sys.exit(main())
