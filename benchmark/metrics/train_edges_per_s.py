"""The graph's edges times the training steps completed in the window,
over the window's seconds on the host clock."""


def read(ctx):
    return ctx["edges"] * ctx["window_steps"] / ctx["window_s"]
