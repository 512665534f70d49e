"""The device's idle share of the traced window: 100 (1 - busy / window),
busy the union of the trace's device intervals, the window on the host
clock."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / ctx["window_s"])
