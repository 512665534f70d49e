"""Launches a step of the port's own kernels over the traced window: the
trace's device intervals in the six port-kernel categories of the
trace's table, over the window's steps."""

from benchmark.trace import PORT_KERNELS


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    n = sum(tr["launches_by_category"].get(c, 0) for c in PORT_KERNELS)
    return n / ctx["window_steps"] if n > 0 else None
