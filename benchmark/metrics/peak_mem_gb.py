"""``torch.cuda.max_memory_allocated()`` from the first training step to
the window's end, in GB (1e9 bytes)."""


def read(ctx):
    return None if ctx["peak_bytes"] is None else ctx["peak_bytes"] / 1e9
