"""What the port's span registry (``het_tpu_torch/utils/spans.py``) holds
after a run, for the readers of ``metrics/`` that read it.

The registry keeps, a traced step, totals by span path (``calls``,
``ms``: device ms on the card, ``self_ms``, and a ``kernel:`` span's
``launches``, ``bytes``, ``flops`` and ``args``, its calls by operands,
from which ``costs/kernels.py`` counts the work), and, for set-up,
totals by path in host seconds (``calls``, ``s``).  A program without
the registry (an older commit) gives None, and so does every reader.  The readers of a
step's spans hold only when the registry holds exactly the window's
traced steps: the profiler is on over the window, and only there.
"""

from __future__ import annotations

from typing import Dict, List, Optional

FAMILIES = ("agg:", "linear:")
FORWARD, BACKWARD = "step/het.forward", "step/het.backward"


def registry():
    """The program's registry, or None where the program has none."""
    try:
        from het_tpu_torch.utils.spans import REGISTRY
    except ImportError:
        return None
    return REGISTRY


def window_steps(ctx) -> Optional[List[Dict[str, Dict[str, float]]]]:
    """The traced steps' totals by path, where there are exactly as many
    as the window's steps; None otherwise."""
    reg = registry()
    if reg is None or not reg.steps or \
            len(reg.steps) != ctx["window_steps"]:
        return None
    return reg.steps


def family(path: str) -> Optional[str]:
    """The op family that owns a path: its outermost family span's (a
    ``linear:`` span inside an ``agg:`` span counts as ``agg:``)."""
    for part in path.split("/"):
        if part.startswith(FAMILIES):
            return part.split(":", 1)[0] + ":"
    return None


def outermost(path: str) -> bool:
    """Whether the path's last span is the outermost op span on it."""
    parts = path.split("/")
    return parts[-1].startswith(FAMILIES) and not any(
        p.startswith(FAMILIES) for p in parts[:-1])


def family_ms(ctx, fam: str) -> Optional[float]:
    """Device ms a step of the outermost ``fam`` spans, forward and
    backward."""
    steps = window_steps(ctx)
    if steps is None:
        return None
    return sum(t["ms"] for s in steps for p, t in s.items()
               if outermost(p) and family(p) == fam) / len(steps)


def setup_s(prefix: str, leaf: str) -> Optional[float]:
    """Host seconds of the set-up spans under ``prefix`` whose name
    starts with ``leaf``; None where there is none."""
    reg = registry()
    if reg is None:
        return None
    found = [t["s"] for p, t in reg.setup.items()
             if p.startswith(prefix) and p.rsplit("/", 1)[-1].startswith(
                 leaf)]
    return sum(found) if found else None
