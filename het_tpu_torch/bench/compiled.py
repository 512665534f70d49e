"""The compiled models (``--use_compiler``) against the hand-written ones,
a family at a time (counterpart of ``scripts/bench_compiled.py``).

    python -m het_tpu_torch.bench.compiled [--scale 0.018]
        [--cases rgat rgat+flags ...] [--warmup 3] [--steps 10]
        [--device cuda|cpu] [--out FILE]

``bench_compiled.py``'s six cases: RGAT plain and compact +
multiply-first, HGT plain and compact, RGCN plain and compact, on
synthetic ogbn-mag at 0.018 with 64 input features, hidden 64 and 8
classes.  The compiled model (``train/compiled.py``: H = 1, the raw
softmax, as the DSL expresses it) and the hand-written model at H = 1
with the same flags, softmax, hidden width (64 for HGT too, where
``bench_compiled.py`` gives the hand-written HGT 8) and layers, each
from the seeded parameters every compared run of the port loads
(``common.seeded_state``).  A step is ``bench.step``'s; each model's
kernel step is held at its first step to its plain versions' (rtol
1e-4), and a disagreement raises.  One JSON line a case: both step
times, their ratio, peak memory and launches a step.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Sequence

import torch

from . import common, step

# case -> (family, compact, multiply-first)
CASES = {
    "rgat": ("RGAT", False, False),
    "rgat+flags": ("RGAT", True, True),
    "hgt": ("HGT", False, False),
    "hgt+compact": ("HGT", True, False),
    "rgcn": ("RGCN", False, False),
    "rgcn+compact": ("RGCN", True, False),
}


def _model(data, impl: str, case: str, compiled: bool) -> torch.nn.Module:
    family, compact, mf = CASES[case]
    net = common.model_of(
        data, impl, model=family, n_infeat=step.F_IN, hidden=64,
        num_classes=step.CLASSES, num_heads=1, num_layers=1,
        compact=compact, multiply_first=mf, dropout=0.0,
        stable_softmax="raw", use_compiler=compiled)
    net.load_state_dict(common.seeded_state(net))
    return net


def measure_case(case: str, data, g, x, labels, dev: torch.device, *,
                 warmup: int, steps: int) -> Dict[str, Any]:
    row: Dict[str, Any] = {"case": case}
    for kind, compiled in (("compiled", True), ("handwritten", False)):
        runs = {}
        for impl in ("kernel", "plain"):
            net = _model(data, impl, case, compiled).to(dev).train()
            runs[impl] = common.measure_step(
                net, g, x, labels, dev, "float32",
                warmup=warmup if impl == "kernel" else 0,
                steps=steps if impl == "kernel" else 1)
            del net
            common.free(dev)
        k = runs["kernel"]
        row.update({
            f"{kind}_ms": k["timing"]["median_ms"],
            f"{kind}_spread": k["timing"]["spread"],
            f"{kind}_peak_mem_mb": k["peak_mem_mb"],
            f"{kind}_launches_a_step": k["launches_a_step"],
            f"{kind}_kernel_vs_plain_max_rel": common.hold(
                f"{case} {kind}", k["first"], runs["plain"]["first"],
                "float32"),
        })
    row["ratio"] = row["compiled_ms"] / row["handwritten_ms"]
    return row


def run(scale: float = step.DEFAULT_SCALE, device: str = "cuda", *,
        cases: Sequence[str] = tuple(CASES), warmup: int = 3,
        steps: int = 10, out=None) -> List[Dict[str, Any]]:
    dev = common.setup(device)
    data, g, x, labels = step.load(scale, dev)
    card, clock = common.card_line(dev), common.clock_name(dev)
    rows = []
    for case in cases:
        row = dict(measure_case(case, data, g, x, labels, dev,
                                warmup=warmup, steps=steps),
                   edges=data.graph.num_edges, scale=scale,
                   config={"H": 1, "f_in": step.F_IN, "hidden": 64,
                           "layers": 1},
                   card=card, clock=clock)
        common.emit(row, out)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.compiled",
        description="Compiled against hand-written models "
                    "(bench_compiled.py's).")
    p.add_argument("--scale", type=float, default=step.DEFAULT_SCALE)
    p.add_argument("--cases", nargs="+", default=list(CASES),
                   choices=list(CASES))
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    args = common.parse(p, argv)
    run(args.scale, args.device, cases=args.cases, warmup=args.warmup,
        steps=args.steps, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
