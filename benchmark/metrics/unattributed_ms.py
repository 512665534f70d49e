"""Device ms a step inside the loop's forward and backward phases that no
op span covers (glue, the loss, the multiply-first weights' einsum and
cat): the two phases' spans less the outermost ``agg:`` and ``linear:``
spans, over the traced window's steps."""

from benchmark.program_spans import (BACKWARD, FORWARD, family_ms,
                                     window_steps)


def read(ctx):
    steps = window_steps(ctx)
    if steps is None:
        return None
    phases = sum(s[p]["ms"] for s in steps for p in (FORWARD, BACKWARD)
                 if p in s) / len(steps)
    return phases - family_ms(ctx, "agg:") - family_ms(ctx, "linear:")
