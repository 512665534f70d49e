"""Device ms a step under the port's ``res_attn`` spans: Simple-HGN's
residual attention (the attention a layer hands on, written; the next
layer's mix of it into its own, forward and in the backward's
recomputation; the backward's scaling), over the traced window's
steps."""

from benchmark.program_spans import window_steps

SPAN = "res_attn"


def read(ctx):
    steps = window_steps(ctx)
    if steps is None:
        return None
    rows = [t["ms"] for s in steps for p, t in s.items()
            if p.rsplit("/", 1)[-1] == SPAN]
    return sum(rows) / len(steps) if rows else None
