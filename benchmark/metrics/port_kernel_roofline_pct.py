"""The port's kernels' share of their roofline over the traced window:
100 x the sum over ``kernel:`` spans of their least time (the larger of
their bytes at the memory peak and their operations at the f32 peak,
counted by ``costs/kernels.py`` from each call's operands as the span
records them) over the sum of their device ms.  A share outside (0, 100]
means a count or a time is wrong, and raises."""

from benchmark.costs.kernels import call_work
from benchmark.peaks import peaks_of
from benchmark.program_spans import window_steps


def read(ctx):
    steps = window_steps(ctx)
    if steps is None:
        return None
    rows = [(p.rsplit("/", 1)[-1][len("kernel:"):], t)
            for s in steps for p, t in s.items()
            if p.rsplit("/", 1)[-1].startswith("kernel:")]
    ms = sum(t["ms"] for _, t in rows)
    if not rows or ms <= 0:
        return None
    peaks = peaks_of(ctx["device_name"])
    least_s = 0.0
    for kernel, t in rows:
        for args, calls in t["args"].items():
            nbytes, flops = call_work(kernel, args)
            least_s += calls * max(nbytes / peaks["hbm_bytes_per_s"],
                                   flops / peaks["f32_flops_per_s"])
    pct = 100.0 * least_s * 1e3 / ms
    if not 0.0 < pct <= 100.0:
        raise ValueError(f"port_kernel_roofline_pct {pct} is outside "
                         "(0, 100]: a kernel's count or its time is wrong")
    return pct
