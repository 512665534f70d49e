"""Device ms a step of the port's own kernels (the six port-kernel
categories of the trace's table)."""

from benchmark.trace import PORT_KERNELS


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    ms = [tr["by_category_s"][c] for c in PORT_KERNELS
          if c in tr["by_category_s"]]
    return sum(ms) * 1e3 / ctx["window_steps"] if ms else None
