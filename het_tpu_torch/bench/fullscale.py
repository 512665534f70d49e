"""The published size on one card: RGAT compact + multiply-first in bf16
on synthetic ogbn-mag at 21.1M edges (counterpart of
``scripts/bench_fullscale.py``).

    python -m het_tpu_torch.bench.fullscale [--scale 1.0] [--warmup 2]
        [--steps 5] [--device cuda|cpu] [--out FILE]

``bench.step``'s model and step (4 heads, 64 input features, 8 classes,
1 layer, the clipped softmax) in the port's mixed precision, through the
kernels: the graph's build seconds (synthesis and host build), the median
step ms, edges/s, peak device memory, the kernel launches a step and the
step's shares of its bf16 bounds (``utils/profiling.py``).  The kernel
step is held at its first step to the plain versions' (rtol 1e-2, PERF.md
§2's bf16 limit), and a disagreement raises.  ``bench_fullscale.py``'s
``chunks`` argument has no counterpart: ``train/chunked.py`` is not
ported (a TPU layout workaround).
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional

from . import common, step

NAME = "kernel_bf16_compact_multfirst"


def run(scale: float = 1.0, device: str = "cuda", *, warmup: int = 2,
        steps: int = 5, peaks: Optional[Dict[str, float]] = None,
        out=None) -> Dict[str, Any]:
    dev = common.setup(device)
    t0 = time.perf_counter()
    data, g, x, labels = step.load(scale, dev)
    build_s = time.perf_counter() - t0
    plain = step.run_variant(NAME.replace("kernel", "plain", 1), data, g,
                             x, labels, dev, warmup=0, steps=1)
    k = step.run_variant(NAME, data, g, x, labels, dev, warmup=warmup,
                         steps=steps)
    gap = common.hold(NAME, k["first"], plain["first"], "bfloat16")
    ms = k["timing"]["median_ms"]
    b = step.bounds(g, common.peaks_of(dev, peaks))
    E = data.graph.num_edges
    row = {
        "scale": scale, "edges": E, "nodes": data.graph.num_nodes,
        "dtype": "bfloat16", "step_ms": ms, "spread": k["timing"]["spread"],
        "Medges_per_s": E / ms / 1e3, "graph_build_s": build_s,
        "peak_mem_mb": k["peak_mem_mb"],
        "launches_a_step": k["launches_a_step"],
        "kernel_vs_plain_max_rel": gap,
        "plain_step_ms": plain["timing"]["median_ms"],
        "pct_of_roofline_strict_bf16": common.share_pct(
            b["strict_bf16"], ms, NAME),
        "pct_of_traffic_bound_bf16": common.share_pct(
            b["traffic_bf16"], ms, NAME),
        "bound_ms": {"strict_bf16": b["strict_bf16"],
                     "traffic_bf16": b["traffic_bf16"]},
        "card": common.card_line(dev), "clock": common.clock_name(dev),
    }
    common.emit(row, out)
    return row


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.fullscale",
        description="RGAT compact + multiply-first in bf16 at the published "
                    "size (bench_fullscale.py's).")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--steps", type=int, default=5)
    args = common.parse(p, argv)
    run(args.scale, args.device, warmup=args.warmup, steps=args.steps,
        out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
