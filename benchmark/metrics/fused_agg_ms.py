"""Device ms a step of the port's outermost ``agg:`` spans (the fused
attention and aggregation ops of ``ops/spmm.py``), forward and backward,
over the traced window's steps."""

from benchmark.program_spans import family_ms


def read(ctx):
    return family_ms(ctx, "agg:")
