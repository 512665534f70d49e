"""Device ms a step of the trace's "matmul" kernels (cuBLAS)."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or "matmul" not in tr["by_category_s"]:
        return None
    return tr["by_category_s"]["matmul"] * 1e3 / ctx["window_steps"]
