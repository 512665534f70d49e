"""The whole step's share of the card's published peaks: 100 x the
step's least time, the larger of its operations at the f32 peak and its
bytes at the memory peak (``costs/<family>.py``), over the window's mean
step time.  A share over 100% means the count or the time is wrong, and
raises."""

from benchmark.peaks import peaks_of


def read(ctx):
    peaks = peaks_of(ctx["device_name"])
    cost = ctx["cost"]
    least = max(cost["flops"] / peaks["f32_flops_per_s"],
                cost["bytes"] / peaks["hbm_bytes_per_s"])
    pct = 100.0 * least * ctx["window_steps"] / ctx["window_s"]
    if not 0.0 < pct <= 100.0:
        raise ValueError(f"step_mfu_pct {pct} is outside (0, 100]: the "
                         "step's count or its time is wrong")
    return pct
