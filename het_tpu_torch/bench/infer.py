"""ms/infer of every model family's forward (counterpart of
``scripts/bench_infer.py``).

    python -m het_tpu_torch.bench.infer [--scale 0.018]
        [--cases RGAT GAT ...] [--warmup 3] [--steps 20]
        [--device cuda|cpu] [--out FILE]

``bench_infer.py``'s five cases (RGAT, RGAT+flags, HGT+compact,
RGCN+compact, GAT; ``bench.models``' configuration) on synthetic
ogbn-mag at 0.018: the forward in eval mode under ``torch.no_grad()``
through the kernels, timed after warm-up calls, with its peak device
memory and its launches a call, beside the plain versions' time.  The
reference's ``check_equal`` role (``np.allclose`` at rtol 1e-3) is the
kernel forward against the plain forward from the same parameters, at
rtol 1e-3 and atol 1e-5; a disagreement raises.  One JSON line a case.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Sequence

import torch

from ..ops import kernels
from . import common, models, step

CASES = ("RGAT", "RGAT+flags", "HGT+compact", "RGCN+compact", "GAT")
RTOL, ATOL = 1e-3, 1e-5  # the reference's check_equal


def measure_case(name: str, data, g, x, dev: torch.device, *, warmup: int,
                 steps: int) -> Dict[str, Any]:
    outs, row = {}, {"case": name}
    for impl in ("kernel", "plain"):
        net = common.model_of(data, impl, **models.SHARED,
                              **models.CASES[name]).to(dev).eval()

        def forward():
            with torch.no_grad():
                return net(g, x)

        common.reset_peak(dev)
        before = kernels.launch_counts()
        outs[impl] = forward()
        timing = common.time_steps(forward, dev, warmup=warmup, steps=steps)
        pre = "" if impl == "kernel" else "plain_"
        row[f"{pre}ms_per_infer"] = timing["median_ms"]
        row[f"{pre}spread"] = timing["spread"]
        row[f"{pre}peak_mem_mb"] = common.peak_mb(dev)
        if impl == "kernel":
            row["launches_a_call"] = common.launches_between(
                before, 1 + warmup + steps, name)
        del net
        common.free(dev)
    got, want = outs["kernel"].double(), outs["plain"].double()
    row["share_of_limit"] = common.within(name, got, want,
                                          ATOL + RTOL * want.abs())
    row["allclose_vs_plain"] = True
    row["max_abs_diff"] = float((got - want).abs().max())
    row["Medges_per_s"] = data.graph.num_edges / row["ms_per_infer"] / 1e3
    return row


def run(scale: float = step.DEFAULT_SCALE, device: str = "cuda", *,
        cases: Sequence[str] = CASES, warmup: int = 3, steps: int = 20,
        out=None) -> List[Dict[str, Any]]:
    dev = common.setup(device)
    data, g, x, _ = step.load(scale, dev)
    card, clock = common.card_line(dev), common.clock_name(dev)
    rows = []
    for name in cases:
        row = dict(measure_case(name, data, g, x, dev, warmup=warmup,
                                steps=steps),
                   edges=data.graph.num_edges, scale=scale,
                   metric="ms/infer (forward, kernels)", card=card,
                   clock=clock)
        common.emit(row, out)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.infer",
        description="ms/infer of every model family (bench_infer.py's).")
    p.add_argument("--scale", type=float, default=step.DEFAULT_SCALE)
    p.add_argument("--cases", nargs="+", default=list(CASES),
                   choices=list(CASES))
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=20)
    args = common.parse(p, argv)
    run(args.scale, args.device, cases=args.cases, warmup=args.warmup,
        steps=args.steps, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
