"""Profile metacache_tpu_torch's long-read query of one checkout (this
one, or another revision unpacked with git archive) on one CUDA card:
the query's wall time, the device's busy time, and the device time of
B4's and B5's wide form (csrc/candidates_wide.cu, either route) in it.

    mkdir old && git archive <rev> | tar -x -C old
    python3 tools/torch_long_profile.py old
    python3 tools/torch_long_profile.py .

It runs that checkout's chip_smoke.py helpers with their own data: the
944 Mbp reference (refseq_skew_genomes) built through the CLI, and
chip_smoke.LONG_READS long reads (sample_long_reads, seed 8) queried
with -tophits; the query runs once, then a second, warm query of the
same reads is traced with torch.profiler, as chip_smoke.py --profile
traces it. Prints the card's name and power limit, then one line, then
the 20 kernels with the most device time.
"""
import io
import os
import sys
import tempfile
import time

# the wide form's kernels in every revision: the cluster route's one
# kernel and the multi-pass route's
WIDE_KERNELS = ("wide_cluster_kernel", "tile_sort_kernel",
                "merge_pass_kernel", "run_count_kernel", "tile_scan_kernel",
                "compact_kernel", "sweep_kernel", "pick_kernel",
                "copy_keys_kernel")


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    root = os.path.abspath(sys.argv[1])
    sys.path.insert(0, root)
    import chip_smoke as cs  # that checkout's (blocks JAX and its package)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available() or \
            not cs.__file__.startswith(root + os.sep):
        print(__doc__, file=sys.stderr)
        return 1
    from metacache_tpu_torch.classify.options import ClassificationResults
    from metacache_tpu_torch.classify.runner import map_queries_to_targets
    cs.CARD = cs.card_line()
    print(f"card: {cs.CARD}", flush=True)
    with tempfile.TemporaryDirectory(dir=root, prefix=".long_profile_") \
            as tmp:
        genomes, species, gen_s = cs.generated(cs.refseq_skew_genomes)
        db, _w, _p = cs.phase_build(tmp, "944mbp", genomes, species, gen_s)
        path = os.path.join(tmp, "944mbp", "reads_long.fa")
        codes, offs = cs.sample_long_reads(np.random.default_rng(8), genomes,
                                           cs.LONG_READS)
        cs.write_long_reads(path, codes, offs)
        del codes, genomes, species
        runner, _res, _s = cs._query(db, path, ["-tophits"], io.StringIO())
        res = ClassificationResults(io.StringIO(), io.StringIO(),
                                    io.StringIO())
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            map_queries_to_targets([path], runner.db, runner.opt, res,
                                   runner)
            torch.cuda.synchronize()
            wall = time.time() - t0
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in evs)
    wide = [e for e in evs if any(k in e.key for k in WIDE_KERNELS)]
    wide_us = sum(e.self_device_time_total for e in wide)
    cs.say("long-profile", checkout=root, reads=cs.LONG_READS,
           bases=int(offs[-1]), wall_seconds=wall,
           device_busy_seconds=busy_us / 1e6,
           device_idle_share=1 - busy_us / 1e6 / wall,
           wide_form_device_seconds=wide_us / 1e6,
           wide_form_launches=sum(e.count for e in wide),
           wide_form_share_of_device_time=wide_us / max(busy_us, 1))
    evs.sort(key=lambda e: -e.self_device_time_total)
    for e in evs[:20]:
        print(f"  {e.self_device_time_total / 1e3:10.3f} ms "
              f"{e.count:7d} x  {e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
