"""Device ms a step of the trace's "gather / index" kernels."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or "gather / index" not in tr["by_category_s"]:
        return None
    return tr["by_category_s"]["gather / index"] * 1e3 / ctx["window_steps"]
