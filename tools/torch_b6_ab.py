"""Time kernel B6 (metacache_tpu_torch's head decode) of this checkout
against the same C entry point built from another revision's
probe_decode.cu, on one CUDA card.

    git show <rev>:metacache_tpu_torch/csrc/probe_decode.cu > base.cu
    python3 tools/torch_b6_ab.py base.cu

Both decode the same 131,072 probes of a 2 M-feature two-tier table,
made as chip_smoke.py's B6 phase makes them (hsl 61, rl 64, f 16), and
the base's output must equal this checkout's. Each is timed with
chip_smoke.kernel_ms (20 launches in a CUDA graph, replayed between
CUDA events) in turns: base, this, this, base. Prints the card's name
and power limit, then one JSON line.
"""
import ctypes
import json
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
    its mc_head_decode with argument types set."""
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    so = os.path.join(kernels.BUILD_DIR, "b6_base.so")
    subprocess.run([kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", src,
                    "-o", so], check=True)
    fn = ctypes.CDLL(so).mc_head_decode
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [p, i64, i, p, p, i64, i, i, i, p, p, p]
    return fn


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    base_fn = build_base(sys.argv[1])
    dev = torch.device("cuda")
    n, f, hsl, rl = 131072, 16, 61, 64
    rng = np.random.default_rng(1234)
    feats, head_np, _ovf = cs.two_tier_table(rng, 1 << 21)
    idx_np, flat_np = cs.decode_probes(rng, feats, n)
    head, idx, flat = (torch.from_numpy(a).to(dev) for a in
                       (head_np, idx_np, flat_np))

    def base():
        pk = torch.empty((n, rl), dtype=torch.int32, device=dev)
        cnt = torch.empty((n,), dtype=torch.int32, device=dev)
        err = base_fn(head.data_ptr(), head.shape[0], head.shape[1],
                      idx.data_ptr(), flat.data_ptr(), n, hsl, rl, f,
                      pk.data_ptr(), cnt.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"base mc_head_decode: CUDA error {err}")
        return pk, cnt

    def this():
        return D.head_decode(head, idx, flat, hsl, rl, f)

    (bpk, bcnt), (tpk, tcnt) = base(), this()
    torch.cuda.synchronize()
    equal = torch.equal(bpk, tpk) and torch.equal(bcnt, tcnt)
    reads = [cs.kernel_ms(base), cs.kernel_ms(this), cs.kernel_ms(this),
             cs.kernel_ms(base)]
    print(cs.card_line())
    print(json.dumps({
        "probes": n, "rl": rl, "f": f, "hsl": hsl, "equal": equal,
        "turns_base_this_this_base_ms": reads,
        "base_ms": (reads[0] + reads[3]) / 2,
        "this_ms": (reads[1] + reads[2]) / 2}))
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
