"""The reference's sweep grid through the port's trainer (counterpart of
``scripts/benchmark_all.py``).

    python -m het_tpu_torch.bench.sweep [--grid quick|mid|full]
        [--dataset_scale 0.1] [--num_epochs 5] [--max_cases N]
        [--device cuda|cpu] [--out FILE]

The grids and their skips are ``benchmark_all.py``'s: models x datasets
x feature widths x heads x (compact, multiply-first), RGCN without heads
or multiply-first, GAT without the relational flags, HGT at the grid's
last head count.  Each case trains 1 layer (``TrainConfig``: n_infeat
and hidden the width, 2 warm-up and ``--num_epochs`` timed Adam steps,
dropout 0; ``--backend`` has no counterpart) through the kernels and
again through the plain versions from the same seed, the two held step
for step within rtol 1e-4.  A row has the trainer's forward, backward and
step means, its peak memory (``max_memory_usage (mb)``), train and test
accuracy, the plain run's step mean and the worst gap.  A case that fails
or disagrees is recorded as a row with its ``error`` and the sweep goes
on, as the reference's sweep shell does; the last line counts the cases
and the failures, and the process exits non-zero if any failed.
``--max_cases`` runs the grid's first cases only.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import traceback
from typing import Any, Dict, List, Optional

from ..data.loaders import load_dataset
from ..train.config import TrainConfig
from ..train.driver import train
from . import common

FULL_GRID = {
    "model": ["RGAT", "HGT", "RGCN", "GAT"],
    "dataset": ["aifb", "mutag", "bgs", "mag", "fb15k"],
    "n_infeat": [32, 64, 128],
    "heads": [1, 4],
    "flags": [(False, False), (True, False), (True, True)],
}
MID_GRID = {
    "model": ["RGAT", "HGT", "RGCN", "GAT"],
    "dataset": ["aifb", "mag"],
    "n_infeat": [64, 128],
    "heads": [1, 4],
    "flags": [(False, False), (True, False), (True, True)],
}
QUICK_GRID = {
    "model": ["RGAT", "HGT", "RGCN"],
    "dataset": ["aifb", "mag"],
    "n_infeat": [64],
    "heads": [4],
    "flags": [(False, False), (True, True)],
}
GRIDS = {"quick": QUICK_GRID, "mid": MID_GRID, "full": FULL_GRID}


def cases(grid: Dict[str, list]):
    """``(model, dataset, width, heads, compact, multiply_first)`` of the
    grid, with ``benchmark_all.py``'s skips."""
    for model, ds, dim, heads, (compact, mult) in itertools.product(
            grid["model"], grid["dataset"], grid["n_infeat"], grid["heads"],
            grid["flags"]):
        if mult and model == "RGCN":
            continue
        if model == "GAT" and (compact or mult):
            continue  # homogeneous GAT has no relational flags
        if model == "RGCN" and heads != grid["heads"][0]:
            continue  # RGCN has no head axis
        if model == "HGT" and heads != grid["heads"][-1]:
            continue  # the HGT axis at the standard head count
        yield model, ds, dim, heads, compact, mult


def tag(model, ds, dim, heads, compact, mult) -> str:
    return f"{model}/{ds}/d{dim}/h{heads}/c{int(compact)}m{int(mult)}"


def run_case(case, data, dataset_scale: float, num_epochs: int,
             device: str) -> Dict[str, Any]:
    """One case through the kernels and the plain versions; raises where
    they disagree."""
    model, ds, dim, heads, compact, mult = case
    cfg = TrainConfig(
        model=model, dataset=ds, dataset_scale=dataset_scale, n_infeat=dim,
        hidden=dim, num_heads=heads if model != "RGCN" else 1,
        num_layers=1, num_epochs=num_epochs, warmup_epochs=2,
        compact=compact, multiply_first=mult, dropout=0.0, device=device)
    m = {impl: train(cfg, data, impl=impl, log=lambda s: None)
         for impl in ("kernel", "plain")}
    worst = 0.0
    for i, (a, b) in enumerate(zip(m["kernel"]["loss_list"],
                                   m["plain"]["loss_list"])):
        gap = abs(a - b) / abs(b) if b else abs(a - b)
        worst = max(worst, gap)
        if not gap <= common.TRAIN_RTOL:
            raise common.BenchFailure(f"step {i}: kernel loss {a} against "
                                      f"plain {b}")
    k = m["kernel"]
    return {
        "mean_forward_time": k["mean_forward_time"],
        "mean_backward_time": k["mean_backward_time"],
        "mean_training_time": k["mean_training_time"],
        "train_acc": k["train_acc"],
        "test_acc": k["test_acc"],
        "max_memory_usage (mb)": k["max_memory_usage (mb)"],
        "edges": k["num_edges"],
        "plain_mean_training_time": m["plain"]["mean_training_time"],
        "kernel_vs_plain_max_rel": worst,
    }


def run(grid: str = "full", dataset_scale: float = 0.1,
        num_epochs: int = 5, device: str = "cuda", *,
        max_cases: Optional[int] = None, out=None) -> List[Dict[str, Any]]:
    """Every case of the grid (the first ``max_cases``); returns the rows
    and the summary, whose ``failed`` counts the rows with an error."""
    dev = common.setup(device)
    card, clock = common.card_line(dev), common.clock_name(dev)
    datasets = {}
    rows = []
    for case in itertools.islice(cases(GRIDS[grid]), max_cases):
        row: Dict[str, Any] = {"case": tag(*case)}
        try:
            ds = case[1]
            if ds not in datasets:
                datasets[ds] = load_dataset(ds, scale=dataset_scale,
                                            num_classes=8, seed=0, tile=128)
            row.update(run_case(case, datasets[ds], dataset_scale,
                                num_epochs, str(dev)))
        except Exception as e:  # recorded; the sweep goes on
            row["error"] = f"{type(e).__name__}: {e}"
            traceback.print_exc()
        row.update(card=card, clock=clock)
        common.emit(row, out)
        rows.append(row)
    summary = {"grid": grid, "dataset_scale": dataset_scale,
               "num_epochs": num_epochs, "cases": len(rows),
               "failed": sum("error" in r for r in rows), "card": card,
               "clock": clock}
    common.emit(summary, out)
    return rows + [summary]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.sweep",
        description="The sweep grid through the trainer "
                    "(benchmark_all.py's).")
    p.add_argument("--grid", default="full", choices=list(GRIDS))
    p.add_argument("--dataset_scale", type=float, default=0.1)
    p.add_argument("--num_epochs", type=int, default=5)
    p.add_argument("--max_cases", type=int, default=None)
    args = common.parse(p, argv)
    rows = run(args.grid, args.dataset_scale, args.num_epochs, args.device,
               max_cases=args.max_cases, out=args.out)
    if rows[-1]["failed"]:
        print(f"{rows[-1]['failed']} of {rows[-1]['cases']} cases failed",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
