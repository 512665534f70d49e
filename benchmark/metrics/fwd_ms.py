"""The median over the window of a step's forward ms: the harness's CUDA
events around the model and the loss in ``step_loss``."""

import statistics


def read(ctx):
    fwd = ctx["forward_ms"]
    return statistics.median(fwd) if fwd else None
