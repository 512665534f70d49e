"""The sorted segment sum under degree skew (counterpart of
``scripts/bench_skew.py``).

    python -m het_tpu_torch.bench.skew [--kinds uniform zipf one_hub]
        [--nodes 100000] [--edges 1000000] [--reps 20]
        [--device cuda|cpu] [--out FILE]

``bench_skew.py``'s graphs (``make``): uniform, zipf (exponent 1.3) and
one-hub (half of all edges into node 0) destinations over the same edge
count, 4 relations, tile 128, no compact rows.  Each sums 128 standard
normal lanes a canonical edge over ``in_row_ptr`` with ``seg_sum_sorted``
(kernel 1) and with its plain version; the kernel is held to the plain
sum within PERF.md §2's limit (rtol 1e-5, atol 1e-5 of the largest sum),
and a disagreement raises.  A row: the largest in-degree, the kernel's
and the plain version's median ms (single calls after an L2 flush), the
bound (``OpCost``: each real edge's row read once, each sum written once)
and the kernel's share of it.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..graph.build import build_heterograph
from ..ops.kernels import seg_sum_sorted
from ..utils.profiling import OpCost
from . import common

KINDS = ("uniform", "zipf", "one_hub")
LANES = 128
RTOL = 1e-5  # PERF.md §2's limit of the segment sum against its plain sum


def make(kind: str, n: int = 100_000, e: int = 1_000_000, seed: int = 0):
    """``bench_skew.py``'s graph of ``kind`` with ``e`` edges on ``n``
    nodes."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    if kind == "uniform":
        dst = rng.integers(0, n, e)
    elif kind == "zipf":
        dst = (rng.zipf(1.3, e) % n).astype(np.int64)
    elif kind == "one_hub":  # half of all edges land on node 0
        dst = np.where(rng.random(e) < 0.5, 0, rng.integers(0, n, e))
    else:
        raise ValueError(kind)
    rel = rng.integers(0, 4, e)
    return build_heterograph(src, dst, rel, n, 4, tile=128,
                             build_compact=False)


def bound_ms(g, peaks: Dict[str, float]) -> float:
    """Each real edge's row read once, the row pointer and each sum
    written once, in f32; one add a lane an edge."""
    E, N = g.num_edges, g.num_nodes
    nbytes = E * LANES * 4 + (N + 1) * 4 + N * LANES * 4
    return OpCost("seg_sum_sorted", E * LANES, nbytes).time_ms(peaks)


def bench_kind(kind: str, dev: torch.device, *, n: int, e: int, reps: int,
               peaks: Dict[str, float]) -> Dict[str, Any]:
    g = make(kind, n, e).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    vals = torch.randn(g.num_padded_edges, LANES, generator=gen, device=dev)
    ptr = g.in_row_ptr

    def kernel():
        return seg_sum_sorted(vals, ptr, impl="kernel")

    def plain():
        return seg_sum_sorted(vals, ptr, impl="plain")

    got, want = kernel(), plain()
    gap = float((got - want).abs().max())
    common.within(kind, got, want,
                  RTOL * want.abs() + RTOL * float(want.abs().max()))
    common.reset_peak(dev)
    ms = common.time_call_ms(kernel, dev, reps)
    plain_ms = common.time_call_ms(plain, dev, reps)
    b = bound_ms(g, peaks)
    row = {
        "kind": kind, "edges": g.num_edges, "nodes": g.num_nodes,
        "max_in_degree": int(g.in_deg.max()), "lanes": LANES,
        "reduce_ms": ms, "plain_ms": plain_ms, "bound_ms": b,
        "pct_of_bound": common.share_pct(b, ms, kind),
        "max_abs_diff": gap, "peak_mem_mb": common.peak_mb(dev),
    }
    del g, vals, got, want
    common.free(dev)
    return row


def run(device: str = "cuda", *, kinds: Sequence[str] = KINDS,
        nodes: int = 100_000, edges: int = 1_000_000, reps: int = 20,
        peaks: Optional[Dict[str, float]] = None,
        out=None) -> List[Dict[str, Any]]:
    dev = common.setup(device)
    card, clock = common.card_line(dev), common.clock_name(dev)
    rows = []
    for kind in kinds:
        row = dict(bench_kind(kind, dev, n=nodes, e=edges, reps=reps,
                              peaks=common.peaks_of(dev, peaks)),
                   card=card, clock=clock)
        common.emit(row, out)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.skew",
        description="The segment sum under degree skew (bench_skew.py's).")
    p.add_argument("--kinds", nargs="+", default=list(KINDS),
                   choices=list(KINDS))
    p.add_argument("--nodes", type=int, default=100_000)
    p.add_argument("--edges", type=int, default=1_000_000)
    p.add_argument("--reps", type=int, default=20)
    args = common.parse(p, argv)
    run(args.device, kinds=args.kinds, nodes=args.nodes, edges=args.edges,
        reps=args.reps, out=args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
