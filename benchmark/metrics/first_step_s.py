"""Host seconds of the training loop's first step (the port's set-up span
``step.first``: its phases and every first use of a shape), where the run
took one, less the kernel libraries' loads inside it
(``kernels.load.*``), which build the libraries only on a checkout's
first run and would otherwise make the reading depend on the run's
place in its checkout."""

from benchmark.program_spans import registry, setup_s


def read(ctx):
    reg = registry()
    t = None if reg is None else reg.setup.get("step.first")
    if t is None or t["calls"] != 1:
        return None
    return t["s"] - (setup_s("step.first/", "kernels.load.") or 0.0)
