"""Simple-HGN's attention op's share of its roofline over the traced
window: 100 x its least bytes a step (``costs/simple_hgn.py``, counted
from the graph's sizes) at the memory peak, over the device ms a step
under its ``agg:simple_hgn_attention`` spans, forward and backward.  A
share outside (0, 100] means the count or the time is wrong, and
raises."""

from benchmark.peaks import peaks_of
from benchmark.program_spans import window_steps

SPAN = "agg:simple_hgn_attention"


def read(ctx):
    steps = window_steps(ctx)
    cost = ctx["cost"] or {}
    if steps is None or "agg_bytes" not in cost:
        return None
    ms = sum(t["ms"] for s in steps for p, t in s.items()
             if p.rsplit("/", 1)[-1] == SPAN) / len(steps)
    if ms <= 0:
        return None
    least_s = cost["agg_bytes"] / peaks_of(ctx["device_name"])[
        "hbm_bytes_per_s"]
    pct = 100.0 * least_s * 1e3 / ms
    if not 0.0 < pct <= 100.0:
        raise ValueError(f"hgn_agg_roofline_pct {pct} is outside (0, 100]: "
                         "the op's count or its time is wrong")
    return pct
