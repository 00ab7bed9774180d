"""A stage's share of its roofline: the least time its work needs (the
larger of its bytes over the peak bandwidth and its integer operations
over the peak rate, from work/<stage>.py) over the device time of the
kernels that kernels/*.json give to the stage, in the same window."""


def share(run, stage):
    t = run["stage_seconds"].get(stage)
    w = run["work"].get(stage)
    peak = run["peak"]
    if not t or not w or not peak:
        return None
    least = max(w["bytes"] / peak["bytes_per_s"],
                w["ops"] / peak["int_ops_per_s"])
    return 100.0 * least / t
