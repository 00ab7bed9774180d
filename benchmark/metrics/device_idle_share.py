"""Share of the traced window in which nothing ran on the device: one
minus the union of its kernels, copies and fills over the window."""


def read(run):
    tr = run["trace"]
    if tr is None or tr.window_s <= 0 or len(tr.dev_ts) == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
