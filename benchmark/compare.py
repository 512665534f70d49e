"""The numbers that decide ``correct``: a training step's readings on
the program against the plain reference's on the same inputs.

Each side gives its loss at each of the first steps, the norm of each
leaf's first gradient, and the norm of each leaf's change after the last
of those steps.  A leaf's gap is the difference of the two sides' norms
(not the norm of their difference) over the reference's norm of that
leaf or of the median leaf, whichever is larger, since some gradients are
all but zero.  A leaf whose reference gradient is under ``NEGLIGIBLE`` of
the median leaf's moves under Adam by round-off alone, so its change is
not compared.  The numbers:

* ``loss_gap``: the largest of each step's loss gap, relative to the
  reference's loss;
* ``grad_gap`` / ``grad_gap_median``: the worst / the median leaf's gap
  of the first gradient;
* ``change_gap`` / ``change_gap_median``: the worst / the median leaf's
  gap of the change.

A cell's file (``cells/<cell>.json``) gives the limit of each number it
compares; the others are readings only.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Mapping

NEGLIGIBLE = 1e-3
NUMBERS = ("loss_gap", "grad_gap", "grad_gap_median",
           "change_gap", "change_gap_median")


def _gap(p: float, r: float, scale: float) -> float:
    if not (math.isfinite(p) and math.isfinite(r)):
        return math.inf
    return abs(p - r) / scale if scale > 0 else (0.0 if p == r else math.inf)


def _leaf_gaps(prog: Mapping[str, float], ref: Mapping[str, float],
               leaves: List[str]) -> List[float]:
    if set(prog) != set(ref):
        return [math.inf]
    med = statistics.median(ref[n] for n in leaves)
    return [_gap(prog[n], ref[n], max(ref[n], med)) for n in leaves]


def uncompared(ref: Mapping) -> List[str]:
    """The leaves whose change is not compared."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    return sorted(n for n, v in g.items() if v < NEGLIGIBLE * med)


def gaps(prog: Mapping, ref: Mapping) -> Dict[str, float]:
    """Every number of the module's list, of ``prog``'s readings against
    ``ref``'s."""
    losses = [_gap(p, r, abs(r)) for p, r in zip(prog["losses"],
                                                 ref["losses"])]
    if not losses or len(prog["losses"]) != len(ref["losses"]):
        losses.append(math.inf)
    skip = set(uncompared(ref))
    grad = _leaf_gaps(prog["grad_norms"], ref["grad_norms"],
                      sorted(ref["grad_norms"]))
    change = _leaf_gaps(prog["change_norms"], ref["change_norms"],
                        [n for n in sorted(ref["change_norms"])
                         if n not in skip])
    return {"loss_gap": max(losses),
            "grad_gap": max(grad), "grad_gap_median": statistics.median(grad),
            "change_gap": max(change),
            "change_gap_median": statistics.median(change)}
