"""Kernels the device ran in the traced window per 8,192 queries, the
queries counted by the benchmark (reads of the files it queried)."""


def read(run):
    tr = run["trace"]
    if tr is None or not run["queries"]:
        return None
    names, _secs = tr.kernels()
    if len(names) == 0:
        return None
    return len(names) / run["queries"] * 8192
