"""Device ms a step of the port's outermost ``linear:`` spans (the typed
linears of ``ops/linear.py``), forward and backward, over the traced
window's steps."""

from benchmark.program_spans import family_ms


def read(ctx):
    return family_ms(ctx, "linear:")
