"""Time classed_bucket and classed_decode (metacache_tpu_torch's
size-classed probe, csrc/probe_decode.cu, mc_classed_bucket and
mc_classed_decode) of this checkout against the same C entry points
built from another revision's probe_decode.cu, and against patched
copies of this checkout's source (other lane counts and steps), on one
CUDA card.

    git show <rev>:metacache_tpu_torch/csrc/probe_decode.cu > base.cu
    python3 tools/torch_classed_ab.py base.cu

The shapes are chip_smoke.py's [parity-classed_*-944mbp] lines': the
944 Mbp RefSeq-skew database built on the card (about 20 s), staged as
size-classed cells (MC_DENSE_LIMIT=1 MC_CLASSED=1: 21 bucket bits, hsl
61, c 254), and 131,072 probes from B1's sketches of 8192 reads;
classed_decode's head form at rl 64, f 16 (escalation phase 1), its full
form at rl 256, f 16 (the redo). Every build's outputs must equal this
checkout's. Each form is timed with chip_smoke.kernel_ms (20 launches in
a CUDA graph, replayed between CUDA events) in turns: base, this, the
variants, then the same in reverse. Prints the card's name and power
limit, then one JSON line a form. About two minutes.
"""
import ctypes
import json
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402  (blocks JAX and the JAX package)
import torch  # noqa: E402

from metacache_tpu_torch import kernels  # noqa: E402
from metacache_tpu_torch.ops import probe_decode as D  # noqa: E402

# this checkout's source patched into other designs of the same kernels
# (their results must equal this checkout's): (text, its replacement),
# each text found exactly once
VARIANTS = {
    # this checkout's own source, built as the others are: a control
    "bucket_same": ("constexpr int kCBSteps = 2;",
                    "constexpr int kCBSteps = 2;  // rebuilt"),
    "bucket_lanes32": ("constexpr int kCBLanes = 8;",
                       "constexpr int kCBLanes = 32;"),
    "bucket_lanes16": ("constexpr int kCBLanes = 8;",
                       "constexpr int kCBLanes = 16;"),
    "bucket_lanes4": ("constexpr int kCBLanes = 8;",
                      "constexpr int kCBLanes = 4;"),
    "bucket_steps1": ("constexpr int kCBSteps = 2;",
                      "constexpr int kCBSteps = 1;"),
    "bucket_steps4": ("constexpr int kCBSteps = 2;",
                      "constexpr int kCBSteps = 4;"),
    "head_steps4": ("constexpr int kCHSteps = 8;",
                    "constexpr int kCHSteps = 4;"),
    "head_steps16": ("constexpr int kCHSteps = 8;",
                     "constexpr int kCHSteps = 16;"),
}


def sources(base: str, variants: dict = VARIANTS,
            prefix: str = "classed") -> dict:
    """name -> the source to build: the base, and this checkout's
    probe_decode.cu copied and patched once for each variant (a (text,
    replacement) pair)."""
    own = os.path.join(kernels.CSRC, "probe_decode.cu")
    with open(own) as f:
        text = f.read()
    os.makedirs(kernels.BUILD_DIR, exist_ok=True)
    out = {"base": base}
    for name, (old, new) in variants.items():
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not in {own} once")
        path = os.path.join(kernels.BUILD_DIR, f"{prefix}_{name}.cu")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
        out[name] = path
    return out


def bind_classed(lib) -> None:
    """Set the classed entry points' argument types."""
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.mc_classed_bucket.argtypes = [p, i64, i, p, i64, p, p, p]
    lib.mc_classed_decode.argtypes = [p, i64, p, i64, i, p, p, i64, i, i, i,
                                      i, i, i, i, p, p, p, p]


def build(srcs: dict, prefix: str = "classed", bind=bind_classed) -> dict:
    """Each source built alone as kernels.py builds the port's (its
    headers from this checkout's csrc/), one nvcc each, in parallel ->
    name -> library, passed to ``bind`` (which sets argument types)."""
    procs = {name: subprocess.Popen(
        [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
         "-shared", src, "-o",
         os.path.join(kernels.BUILD_DIR, f"{prefix}_{name}.so")])
        for name, src in srcs.items()}
    libs = {}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on the {name} build")
        lib = ctypes.CDLL(os.path.join(kernels.BUILD_DIR,
                                       f"{prefix}_{name}.so"))
        bind(lib)
        libs[name] = lib
    return libs


def classed_runner(tmp):
    """The 944 Mbp database built on the card, staged as size-classed
    cells -> (runner, genomes)."""
    from metacache_tpu_torch.classify.runner import QueryRunner
    from metacache_tpu_torch.cli.main import Args, parse_query_options
    genomes, species, gen_s = cs.generated(cs.refseq_skew_genomes)
    db, _w, _p = cs.phase_build(tmp, "944mbp", genomes, species, gen_s)
    opt, _, _ = parse_query_options(Args(["-no-map"]))
    with cs.environ(MC_DENSE_LIMIT="1", MC_CLASSED="1"):
        runner = QueryRunner(cs.Database.load(db), opt)
    if not runner.tables.classed:
        raise AssertionError(f"staged {runner.layout}, not classed cells")
    return runner, genomes


def launcher(lib, t, flat, pidx, rl, head):
    """lib's form of the call the wrapper makes -> a function giving
    (outputs...)."""
    n, dev = flat.shape[0], flat.device
    hsl, c, sb = t.head_slots, t.spf, t.slot_bits

    def stream():  # the current one: a graph captures on its own
        return torch.cuda.current_stream().cuda_stream
    if pidx is None:
        def bucket():
            out = (torch.empty((n,), dtype=torch.int32, device=dev),
                   torch.empty((n,), dtype=torch.bool, device=dev))
            err = lib.mc_classed_bucket(
                t.bucket_rows.data_ptr(), 1 << t.bucket_bits, t.bucket_bits,
                flat.data_ptr(), n, out[0].data_ptr(), out[1].data_ptr(),
                stream())
            if err:
                raise RuntimeError(f"mc_classed_bucket: CUDA error {err}")
            return out
        return bucket

    def decode():
        pk = torch.empty((n, rl), dtype=torch.int32, device=dev)
        cnt = torch.empty((n,), dtype=torch.int32, device=dev)
        err = lib.mc_classed_decode(
            t.fused_rows.data_ptr(), t.fused_rows.shape[0] * 2,
            t.ovf_rows.data_ptr(), t.ovf_rows.shape[0], t.ovf_rows.shape[1],
            pidx.data_ptr(), flat.data_ptr(), n, hsl, c, rl, 16, sb, sb,
            int(head), pk.data_ptr(), None, cnt.data_ptr() if head else None,
            stream())
        if err:
            raise RuntimeError(f"mc_classed_decode: CUDA error {err}")
        return (pk, cnt) if head else (pk,)
    return decode


def this_call(t, flat, pidx, form, rl):
    """This checkout's wrapper call of ``form`` -> a function giving its
    outputs as a tuple."""
    if form == "bucket":
        return lambda: D.classed_bucket(t.bucket_rows, flat, t.bucket_bits)
    head = form == "head"
    return lambda: tuple(D.classed_decode(
        t.fused_rows, t.ovf_rows, pidx, flat, t.head_slots, t.spf, rl, 16,
        t.slot_bits, t.slot_bits, head))


def main() -> int:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 1
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    libs = build(sources(sys.argv[1]))
    with tempfile.TemporaryDirectory(dir=os.getcwd(),
                                     prefix=".classed_ab_") as tmp:
        runner, genomes = classed_runner(tmp)
        t = runner.tables
        flat = cs.main_path_probes(runner, genomes)
    n = flat.shape[0]
    pidx, _found = D.classed_bucket(t.bucket_rows, flat, t.bucket_bits)
    hsl, c = t.head_slots, t.spf
    for form, rl in (("bucket", None), ("head", 64), ("full", 256)):
        head = form == "head"
        names = ["base", "this"] + [v for v in VARIANTS
                                    if v.startswith(form)]
        calls = {k: launcher(libs[k], t, flat, None if form == "bucket"
                             else pidx, rl, head)
                 for k in names if k != "this"}
        calls["this"] = this_call(t, flat, pidx, form, rl)
        this = calls["this"]
        want = this()
        for k, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            for g, w in zip(got, want):
                cs.check_equal(f"{form} {k} vs this", g, w)
        order = names + names[::-1]
        reads = {k: [] for k in names}
        for k in order:
            reads[k].append(cs.kernel_ms(calls[k]))
        if form == "bucket":
            nbytes, nops = n * (4 + 256 + 4 + 1), n * 122 * 4
        else:
            kept = int(torch.clamp(D.classed_decode(
                t.fused_rows, t.ovf_rows, pidx, flat, hsl, c, 64, 16,
                t.slot_bits, t.slot_bits, True)[1], 0,
                hsl if head else c).sum())
            nbytes = n * (4 + 4 + 12 + 4 * rl + (4 if head else 0)) + \
                4 * kept
            nops = n * rl
        b_ms, by = cs.bound(nbytes, nops)
        print(json.dumps({
            "form": form, "probes": n, "rl": rl, "f": 16, "hsl": hsl,
            "c": c, "bucket_bits": t.bucket_bits, "equal": True,
            "order": order, "turns_ms": reads,
            "mean_ms": {k: sum(v) / len(v) for k, v in reads.items()},
            "bound_ms": b_ms, "bound_by": by,
            "bound_share": {k: b_ms / (sum(v) / len(v))
                            for k, v in reads.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
