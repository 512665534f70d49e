"""RGAT forward + backward edges/s on synthetic ogbn-mag, with the step's
share of its analytic bound (counterpart of ``bench.py``).

    python -m het_tpu_torch.bench.step [--scale 0.018] [--warmup 3]
        [--steps 10] [--device cuda|cpu] [--out FILE]

The model is ``bench.py``'s: a 1-layer RGAT with 4 heads from 64 input
features to 8 classes (so 2 features a head), dropout 0, the clipped
softmax, on standard normal inputs, the loss the NLL of every node's
label; a step is the forward and the backward into the parameters (no
optimizer).  Six variants, ``bench.py``'s in the port's terms: the plain
PyTorch versions (``impl="plain"``, the baseline, in the role of
het_tpu's XLA path) and the hand-written kernels (``impl="kernel"``, in
the role of its Pallas path), each with neither Hector flag, with compact
+ multiply-first, and with compact + multiply-first in bf16 (the port's
mixed precision: f32 master parameters, the model run on bf16 copies,
``train/driver.py::model_forward``).

Prints ONE JSON line with ``bench.py``'s keys: ``metric``, ``value``
(edges/s of the fastest kernel variant), ``unit``, ``vs_baseline`` (plain
over kernel at compact + multiply-first in f32) and ``detail`` (the card
line, every variant's median ms, spread, peak memory and kernel launches
a step, and the shares of the step's bounds from
``utils/profiling.py``: ``pct_of_roofline_strict_{f32,bf16}`` and
``pct_of_traffic_bound_{f32,bf16}`` of the kernel variants, the same
bounds for whatever runs).  Each kernel variant's first step (loss and
every gradient) is held to its plain variant's within PERF.md §2's limit
(rtol 1e-4 in f32, 1e-2 in bf16).  A variant that fails raises, as does a
disagreement or a share past 100%: nothing is retried and nothing is
emitted from a part of the variants.  The bounds count with
``common.peaks_of``'s row: on the card ``device_peaks()``, which raises
for any card but an H100 SXM.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict, Optional, Sequence

import torch

from ..data.loaders import load_dataset
from ..utils.profiling import (rgat_compact_step_roofline_ms,
                               rgat_compact_step_traffic_ms)
from . import common

HEADS, F_IN, HIDDEN, CLASSES = 4, 64, 64, 8
D_HEAD = CLASSES // HEADS  # the 1-layer model's output is the classes
DEFAULT_SCALE = 0.018
METRIC = "RGAT fwd+bwd edges/s on ogbn-mag (1 card)"
# name -> (impl, compact + multiply-first, dtype)
VARIANTS = {
    "plain": ("plain", False, "float32"),
    "kernel": ("kernel", False, "float32"),
    "plain_compact_multfirst": ("plain", True, "float32"),
    "kernel_compact_multfirst": ("kernel", True, "float32"),
    "plain_bf16_compact_multfirst": ("plain", True, "bfloat16"),
    "kernel_bf16_compact_multfirst": ("kernel", True, "bfloat16"),
}
# each kernel variant's launches a step.  The inputs take no gradient
# (bench.py differentiates the parameters only), so no gather's backward
# sums into them.  Plain: the fused op's forward sums z and z*feat over
# in_row_ptr (2), and each edge_rel_inner's attention gradient is a
# grouped dW (2).  Compact + multiply-first (the packed fused op): in f32
# its three walks (the forward's, the backward's destination and source
# walks) and draw summed over the (dst, rel) runs (1); in bf16 its chain,
# z and z*feat forward (2), draw over the (dst, rel) runs (1), draw and
# dfeat into the source compact rows through edge_sort_perm (2).
LAUNCHES_A_STEP = {
    "kernel": {"seg_sum_sorted": 2, "segment_matmul_dw": 2},
    "kernel_compact_multfirst": {"seg_sum_sorted": 1,
                                 "compact_gat_packed_fwd": 1,
                                 "compact_gat_packed_bwd_dst": 1,
                                 "compact_gat_packed_bwd_src": 1},
    "kernel_bf16_compact_multfirst": {"seg_sum_sorted": 5},
}


def load(scale: float, dev: torch.device):
    """Synthetic ogbn-mag at ``scale`` (tile 128, 8 classes, seed 0, both
    compact row lists) with the graph, the inputs and the labels on
    ``dev``."""
    data = load_dataset("mag", scale=scale, num_classes=CLASSES, seed=0,
                        tile=128, data_roots=())
    g = data.graph.to(dev)
    x = common.features(g.num_nodes, F_IN, dev)
    labels = torch.as_tensor(data.labels % CLASSES).long().to(dev)
    return data, g, x, labels


def model(data, impl: str, compact_multfirst: bool) -> torch.nn.Module:
    """``bench.py``'s RGAT (seeded: the same parameters for either
    ``impl``)."""
    return common.model_of(
        data, impl, model="RGAT", n_infeat=F_IN, hidden=HIDDEN,
        num_classes=CLASSES, num_heads=HEADS, num_layers=1,
        compact=compact_multfirst, multiply_first=compact_multfirst,
        dropout=0.0, stable_softmax="clip")


def run_variant(name: str, data, g, x, labels, dev: torch.device, *,
                warmup: int, steps: int) -> Dict[str, Any]:
    """One variant (``common.measure_step``)."""
    impl, cmf, dtype = VARIANTS[name]
    net = model(data, impl, cmf).to(dev).train()
    out = common.measure_step(net, g, x, labels, dev, dtype, warmup=warmup,
                              steps=steps)
    del net
    common.free(dev)
    return out


def bounds(g, peaks: Dict[str, float]) -> Dict[str, float]:
    """The step's strict and traffic bounds (ms) in f32 and bf16."""
    args = (g, F_IN, HEADS, D_HEAD, CLASSES)
    return {
        "strict_f32": rgat_compact_step_roofline_ms(*args, 4, peaks=peaks),
        "strict_bf16": rgat_compact_step_roofline_ms(*args, 2, peaks=peaks),
        "traffic_f32": rgat_compact_step_traffic_ms(*args, 4, peaks=peaks),
        "traffic_bf16": rgat_compact_step_traffic_ms(*args, 2, peaks=peaks),
    }


def run(scale: float = DEFAULT_SCALE, device: str = "cuda", *,
        warmup: int = 3, steps: int = 10,
        variants: Sequence[str] = tuple(VARIANTS),
        peaks: Optional[Dict[str, float]] = None) -> Dict[str, Any]:
    """Every variant of ``variants`` (all six by default; the tests run a
    part) at ``scale``; returns the JSON object.  ``peaks`` defaults to
    ``common.peaks_of``'s."""
    dev = common.setup(device)
    peaks = common.peaks_of(dev, peaks)
    data, g, x, labels = load(scale, dev)
    res = {name: run_variant(name, data, g, x, labels, dev, warmup=warmup,
                             steps=steps) for name in variants}
    gaps = {}
    for name, r in res.items():
        impl, _, dtype = VARIANTS[name]
        plain = name.replace("kernel", "plain", 1)
        if impl == "kernel" and plain in res:
            gaps[name] = common.hold(name, r["first"], res[plain]["first"],
                                     dtype)
    t = {name: r["timing"]["median_ms"] for name, r in res.items()}
    b = bounds(g, peaks)
    shares = {}
    for name in t:
        if VARIANTS[name][1]:
            kind = "bf16" if VARIANTS[name][2] == "bfloat16" else "f32"
            shares[name] = {
                f"pct_of_roofline_strict_{kind}": common.share_pct(
                    b[f"strict_{kind}"], t[name], name),
                f"pct_of_traffic_bound_{kind}": common.share_pct(
                    b[f"traffic_{kind}"], t[name], name)}
    kernel_ts = [t[n] for n in t if VARIANTS[n][0] == "kernel"]
    if not kernel_ts:
        raise common.BenchFailure("no kernel variant ran")
    t_best = min(kernel_ts)
    E = data.graph.num_edges

    def ratio(a, b):
        return t[a] / t[b] if a in t and b in t else None

    detail = {
        "card": common.card_line(dev),
        "clock": common.clock_name(dev),
        **{f"t_{name}_ms": t[name] for name in t},
        "spread": {n: r["timing"]["spread"] for n, r in res.items()},
        "peak_mem_mb": {n: r["peak_mem_mb"] for n, r in res.items()},
        "launches_a_step": {n: r["launches_a_step"] for n, r in res.items()},
        "first_step_loss": {n: r["first"]["loss"] for n, r in res.items()},
        "kernel_vs_plain_max_rel": gaps,
        "vs_baseline_f32": ratio("plain_compact_multfirst",
                                 "kernel_compact_multfirst"),
        "vs_baseline_bf16": ratio("plain_bf16_compact_multfirst",
                                  "kernel_bf16_compact_multfirst"),
        "vs_plain_best": (t["plain"] / t_best) if "plain" in t else None,
        "bound_ms": b,
        **shares.get("kernel_compact_multfirst", {}),
        **shares.get("kernel_bf16_compact_multfirst", {}),
        "shares": shares,
        "peaks": peaks,
        "num_edges": E,
        "num_padded_edges": data.graph.num_padded_edges,
        "num_nodes": data.graph.num_nodes,
        "compact_rows": {"src": data.graph.compact_src.seg.n_rows,
                         "dst": data.graph.compact_dst.seg.n_rows},
        "scale": scale,
        "config": {"heads": HEADS, "n_infeat": F_IN, "classes": CLASSES,
                   "layers": 1, "stable_softmax": "clip", "dropout": 0.0,
                   "warmup": warmup, "steps": steps},
        "synthetic_data": data.meta.get("synthetic", False),
    }
    return {"metric": METRIC, "value": E / (t_best / 1e3),
            "unit": "edges/s",
            "vs_baseline": detail["vs_baseline_f32"], "detail": detail}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        "python -m het_tpu_torch.bench.step",
        description="RGAT forward + backward edges/s (bench.py's).")
    p.add_argument("--scale", type=float, default=DEFAULT_SCALE)
    p.add_argument("--warmup", type=int, default=3)
    p.add_argument("--steps", type=int, default=10)
    args = common.parse(p, argv)
    common.emit(run(args.scale, args.device, warmup=args.warmup,
                    steps=args.steps), args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
