"""Time kernel B9 (metacache_tpu_torch's bucket probe, csrc/probe_decode.cu,
mc_bucket_decode) of this checkout against the pair-packed-only B9 of a
revision before its widening, on one CUDA card.

    git show <rev>:metacache_tpu_torch/csrc/probe_decode.cu > base.cu
    python3 tools/torch_b9_ab.py base.cu

The base's entry point is mc_bucket_decode(brows, bits, flat, n, idx,
found, stream): pair-packed rows and u32 features only. Both probe the
same 131,072 features (29% misses, 1% sentinels) of chip_smoke.py's
2 M-feature device-built probe table (its pair-packed bucket index, 18
bits), and the base's output must equal this checkout's. Each is timed
with chip_smoke.kernel_ms (20 launches in a CUDA graph, replayed
between CUDA events) in turns: base, this, this, base. Prints the card's
name and power limit, then one line with both times and the bound.
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
from metacache_tpu_torch.ops import probe_decode as D  # noqa: E402


def build_base(src: str):
    """The base source alone, built as kernels.py builds the port's, ->
    its mc_bucket_decode with argument types set."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, "b9_base.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src,
                    "-o", so], check=True)
    fn = ctypes.CDLL(so).mc_bucket_decode
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, i, p, i64, p, p, p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    base = build_base(sys.argv[1])
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    dt = cs.build_probe_table(cs.probe_stream(rng, cs.PROBE_FEATURES), dev)
    n = 131072
    flat = dt.uniq[torch.from_numpy(rng.integers(0, dt.nf, n)).to(dev)]
    miss = torch.from_numpy(rng.random(n) < 0.3).to(dev)
    flat = torch.where(miss, torch.from_numpy(rng.integers(
        -2**31, 2**31 - 1, n, dtype=np.int64).astype(np.int32)).to(dev),
        flat)
    flat[::100] = -1
    idx = torch.empty((n,), dtype=torch.int32, device=dev)
    found = torch.empty((n,), dtype=torch.bool, device=dev)

    def run_base():
        err = base(dt.brows.data_ptr(), dt.bbits, flat.data_ptr(), n,
                   idx.data_ptr(), found.data_ptr(),
                   torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"base mc_bucket_decode: CUDA error {err}")

    def run_this():
        return D.bucket_decode(dt.brows, flat, dt.bbits)
    run_base()
    got = run_this()
    cs.check_equal("B9 idx base vs this", idx, got[0])
    cs.check_equal("B9 found base vs this", found, got[1])
    t = [cs.kernel_ms(run_base), cs.kernel_ms(run_this),
         cs.kernel_ms(run_this), cs.kernel_ms(run_base)]
    b_ms, by = cs.bound(n * (4 + 256 + 4 + 1), n * 64 * 3)
    cs.say("b9-ab", probes=n, bucket_bits=dt.bbits, results_equal=True,
           base_ms=(t[0] + t[3]) / 2, this_ms=(t[1] + t[2]) / 2, turns=t,
           bound_ms=b_ms, bound_by=by)
    return 0


if __name__ == "__main__":
    sys.exit(main())
