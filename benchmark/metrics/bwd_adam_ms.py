"""The median over the window of a step's ms from the loss to the end of
Adam: the backward and the update (the harness's CUDA events, the loss's
in ``step_loss`` and Adam's in an optimizer hook)."""

import statistics


def read(ctx):
    rest = ctx["backward_adam_ms"]
    return statistics.median(rest) if rest else None
