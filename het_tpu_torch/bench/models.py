"""Forward + backward step time of every model family, in f32 and in bf16
(counterpart of ``scripts/bench_models.py``).

    python -m het_tpu_torch.bench.models [--scale 0.018]
        [--cases RGAT HGT ...] [--warmup 3] [--steps 10]
        [--device cuda|cpu] [--out FILE]

``bench_models.py``'s seven cases (RGAT, RGAT+flags, HGT, HGT+compact,
RGCN, RGCN+compact, GAT) on synthetic ogbn-mag at 0.018: 4 heads, 64
input features, hidden 64, 8 classes, 1 layer (RGCN and GAT take the
trainer's 2), dropout 0, the clipped softmax.  A step is ``bench.step``'s
(the forward and the backward into the parameters, on standard normal
inputs), through the kernels in f32 and in bf16 (the port's mixed
precision), each with its peak device memory; each is held at its first
step to the plain versions' from the same parameters (PERF.md §2's
limits), and a disagreement raises.  One JSON line a case, then one with
the graph's sizes and ``compact_duplication_src`` (edges per unique
(relation, source) row, the factor the compact flag's cost turns on).
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Sequence

import torch

from . import common, step

# case -> the trainer's fields beyond the shared ones
CASES = {
    "RGAT": dict(model="RGAT"),
    "RGAT+flags": dict(model="RGAT", compact=True, multiply_first=True),
    "HGT": dict(model="HGT"),
    "HGT+compact": dict(model="HGT", compact=True),
    "RGCN": dict(model="RGCN"),
    "RGCN+compact": dict(model="RGCN", compact=True),
    "GAT": dict(model="GAT"),
}
SHARED = dict(n_infeat=step.F_IN, hidden=64, num_classes=step.CLASSES,
              num_heads=step.HEADS, num_layers=1, dropout=0.0,
              stable_softmax="clip")


def measure_case(name: str, data, g, x, labels, dev: torch.device, *,
                 warmup: int, steps: int,
                 dtypes: Sequence[str] = ("float32", "bfloat16")
                 ) -> Dict[str, Any]:
    """One case in each of ``dtypes``: the kernels' step (timed, its
    memory and launches) held to the plain versions' first step."""
    row: Dict[str, Any] = {"case": name}
    E = data.graph.num_edges
    for dtype in dtypes:
        runs = {}
        for impl in ("kernel", "plain"):
            net = common.model_of(data, impl, **SHARED,
                                  **CASES[name]).to(dev).train()
            runs[impl] = common.measure_step(
                net, g, x, labels, dev, dtype,
                warmup=warmup if impl == "kernel" else 0,
                steps=steps if impl == "kernel" else 1)
            del net
            common.free(dev)
        gap = common.hold(f"{name} {dtype}", runs["kernel"]["first"],
                          runs["plain"]["first"], dtype)
        k = runs["kernel"]
        pre = "" if dtype == "float32" else "bf16_"
        ms = k["timing"]["median_ms"]
        row.update({
            f"{pre}ms": ms,
            f"{pre}Medges_per_s": E / ms / 1e3,
            f"{pre}spread": k["timing"]["spread"],
            f"{pre}peak_mem_mb": k["peak_mem_mb"],
            f"{pre}launches_a_step": k["launches_a_step"],
            f"{pre}kernel_vs_plain_max_rel": gap,
        })
    return row


def run(scale: float = step.DEFAULT_SCALE, device: str = "cuda", *,
        cases: Sequence[str] = tuple(CASES), warmup: int = 3,
        steps: int = 10, out=None) -> List[Dict[str, Any]]:
    """Each case's row (printed as it finishes), then the summary."""
    dev = common.setup(device)
    data, g, x, labels = step.load(scale, dev)
    card, clock = common.card_line(dev), common.clock_name(dev)
    rows = []
    for name in cases:
        row = dict(measure_case(name, data, g, x, labels, dev,
                                warmup=warmup, steps=steps),
                   card=card, clock=clock)
        common.emit(row, out)
        rows.append(row)
    summary = {
        "edges": data.graph.num_edges, "nodes": data.graph.num_nodes,
        "scale": scale,
        "config": {"H": step.HEADS, "f_in": step.F_IN, "hidden": 64,
                   "classes": step.CLASSES, "warmup": warmup,
                   "steps": steps},
        "compact_duplication_src": data.graph.compact_duplication("src"),
        "cases": list(cases), "card": card, "clock": clock}
    common.emit(summary, out)
    return rows + [summary]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.models",
        description="Step time of every model family (bench_models.py's).")
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
