"""A step's analytic bound and trace capture (counterpart of
``het_tpu/utils/profiling.py``).

* :data:`H100_SXM` is the one row of peaks the port counts with, from
  NVIDIA's H100 SXM data sheet: 3.35 TB/s of HBM, 67 TFLOP/s f32 outside
  the tensor cores, 989 TFLOP/s dense bf16 on them.  het_tpu reads its row
  from its TPU tuning table; the port has no such table, and
  :func:`device_peaks` returns this row for an H100 SXM and raises for
  any other card.  Every function takes ``peaks=`` explicitly.
* :class:`OpCost` and :func:`rgat_layer_costs` are het_tpu's per-op table
  of one RGAT layer's forward on the per-edge path, and
  :func:`speed_of_light_report` its rows of percent of the bound.
* :func:`rgat_compact_step_roofline_ms` is the strict bound of one
  forward + backward step of the 1-layer compact multiply-first RGAT
  (``bench.py``'s model), :func:`rgat_compact_step_traffic_ms` the bound
  of a design that writes per-edge payloads, as the port's packed fused
  op (``ops/fused_agg.py::CompactFusedGATPacked``) does on its chain (bf16
  payloads, ``stable="max"``; in f32 its walks write only ``draw`` and
  ``alpha``).
* :func:`trace` captures a ``torch.profiler`` trace (Chrome format).

The module imports nothing of the package at run time, so that a script
can load it by its path (``scripts/bench_turns.py`` does).
"""

from __future__ import annotations

import contextlib
import json
import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional

import torch

if TYPE_CHECKING:  # pragma: no cover
    from ..graph.structures import HeteroGraph

# NVIDIA H100 SXM data sheet: HBM3 bandwidth, f32 outside the tensor
# cores, dense bf16 on them
H100_SXM = {"hbm_gbps": 3350.0, "f32_tflops": 67.0, "bf16_tflops": 989.0}


def device_peaks(name: Optional[str] = None) -> Dict[str, float]:
    """The peaks of card ``name`` (the current CUDA device's by default):
    :data:`H100_SXM` for an H100 SXM (its name holds "H100" and "HBM3");
    any other card raises ``ValueError``, since no other row is known."""
    if name is None:
        name = torch.cuda.get_device_name()
    if "H100" in name and "HBM3" in name:
        return dict(H100_SXM)
    raise ValueError(f"no peaks known for {name!r}: the port counts with "
                     "the H100 SXM's data sheet only; pass peaks=")


def _flops_rate(peaks: Dict[str, float], itemsize: int) -> float:
    """Operations a second at the element size: bf16 on the tensor cores
    for 2-byte elements, else f32."""
    key = "bf16_tflops" if itemsize == 2 else "f32_tflops"
    return peaks[key] * 1e12


@dataclass
class OpCost:
    name: str
    flops: float
    hbm_bytes: float

    def time_ms(self, peaks: Dict[str, float]) -> float:
        """The larger of the bytes at the HBM rate and the operations at
        the f32 rate (het_tpu's ``OpCost.time_ms``)."""
        t_mem = self.hbm_bytes / (peaks["hbm_gbps"] * 1e9)
        t_cmp = self.flops / (peaks["f32_tflops"] * 1e12)
        return max(t_mem, t_cmp) * 1e3

    def intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1.0)


def rgat_layer_costs(g: "HeteroGraph", f_in: int, heads: int, d_out: int,
                     itemsize: int = 4) -> Dict[str, OpCost]:
    """Analytic forward cost table of one RGAT layer on the per-edge path:
    het_tpu's entries, one term apart.

    ``fused_softmax_agg``'s operations: het_tpu counts ``2 E 128 C``, the
    one-hot MXU reduction its TPU kernel does (each edge's C lanes
    multiplied into the 128 destination rows of a tile), a TPU workaround
    the port does not have.  The port's op (``ops/fused_agg.py::
    FusedGAT``: ``_aggregate`` through ``_sum_heads``) multiplies the
    payload ``z * feat`` once a lane on every canonical edge row, padding
    included (``EP C``), and its two sorted segment sums add each real
    edge's ``z * feat`` and ``z`` rows once (``E (C + H)``, padding edges
    lying past ``in_row_ptr``'s end): ``EP C + E (C + H)``.  Bytes and
    every other entry are het_tpu's, with ``E`` the padded edge count."""
    E, N, C = g.num_padded_edges, g.num_nodes, heads * d_out
    return {
        "gather_src": OpCost(
            "gather_src", 0, (E * f_in + N * f_in) * itemsize),
        "typed_linear_src": OpCost(
            "typed_linear_src", 2.0 * E * heads * f_in * d_out,
            (E * f_in + E * C) * itemsize),
        "typed_linear_dst": OpCost(
            "typed_linear_dst", 2.0 * E * heads * f_in * d_out,
            (E * f_in + E * C) * itemsize),
        "attn_logits": OpCost(
            "attn_logits", 2.0 * E * C, (2 * E * C + 2 * E * heads) * itemsize),
        "fused_softmax_agg": OpCost(
            "fused_softmax_agg",
            float(E * C + g.num_edges * (C + heads)),
            (E * (C + heads) + N * (C + heads)) * itemsize),
    }


def rgat_compact_step_roofline_ms(
    g: "HeteroGraph",
    f_in: int,
    heads: int,
    d_head: int,
    n_classes: int,
    itemsize: int = 4,
    *,
    peaks: Dict[str, float],
) -> float:
    """Lower bound (ms) of one forward + backward step of the 1-layer
    compact multiply-first RGAT, het_tpu's count: each operand crosses
    HBM the least number of times, gathers are charged their output only,
    the dW and the loss are left out, so no implementation of the step can
    beat it.  ``UCs``, ``UCd`` are the padded compact rows of each side
    (``g.compact_src.seg.n_rows``, ``g.compact_dst.seg.n_rows``), ``P = H
    (1 + D)`` the packed ``[el | feat]`` columns::

        fwd = N K + UCs P + UCd H + (UCs P + UCd H) + N H D
        bwd = N n_classes + 2 (UCs P + UCd H) + (UCs P + UCd H)
              + 2 UCs K + N K
        ops = 3 * 2 UCs H K (1 + D)

    bytes ``(fwd + bwd) * itemsize`` at the HBM rate against ``ops`` at
    the f32 rate, or with ``itemsize=2`` at the bf16 rate, as the port
    counts a bf16 kernel's bound (het_tpu counts both at its f32 rate).
    With ``itemsize=4`` and the same peaks it is het_tpu's number on the
    same graph."""
    K, H, D = f_in, heads, d_head
    N = g.num_nodes
    UCs = g.compact_src.seg.n_rows
    UCd = g.compact_dst.seg.n_rows
    P = H * (1 + D)
    fwd = (N * K + UCs * P + UCd * H + UCs * P + UCd * H + N * H * D)
    bwd = (N * n_classes + 2 * (UCs * P + UCd * H) + UCs * P + UCd * H
           + 2 * UCs * K + N * K)
    flops = 3 * 2.0 * UCs * H * K * (1 + D)
    t_mem = (fwd + bwd) * itemsize / (peaks["hbm_gbps"] * 1e9)
    t_cmp = flops / _flops_rate(peaks, itemsize)
    return max(t_mem, t_cmp) * 1e3


def compact_step_edge_lanes(heads: int, d_head: int) -> Dict[str, int]:
    """Per-edge lanes the packed fused op (``CompactFusedGATPacked``) on
    its chain writes or reads in one step, term by term (a lane is one
    element of one canonical edge row, charged once each way it crosses
    HBM)::

        forward:  the [el | feat] gather            P
                  the er gather                     H
                  the z payload, written and read   2 H
                  the z*feat payload, the same      2 C
        backward: the two gathers again             P + H
                  the destination pack [ct|s|t2]    C + 2 H
                  draw, written and read            2 H
                  alpha*ct, written and read        2 C
                  draw read by the (dst, rel) sum   H

    with ``P = H (1 + D)``, ``C = H D``.  The sums read their rows
    through ``perm`` in the load, so no permuted copy is written (het_tpu
    charges one, and fold-packs its payloads into 32 lanes, a TPU layout
    rule the port does not have)."""
    H, C = heads, heads * d_head
    P = H + C
    fwd = P + H + 2 * H + 2 * C
    bwd = (P + H) + (C + 2 * H) + 2 * H + 2 * C + H
    return {"forward": fwd, "backward": bwd}


def rgat_compact_step_traffic_ms(
    g: "HeteroGraph",
    f_in: int,
    heads: int,
    d_head: int,
    n_classes: int,
    itemsize: int = 4,
    *,
    peaks: Dict[str, float],
) -> float:
    """Lower bound (ms) of the same step under a design that writes
    per-edge rows to HBM, as the port's packed fused op does: the strict
    bound (:func:`rgat_compact_step_roofline_ms`) plus the per-edge lanes
    of :func:`compact_step_edge_lanes` on every padded canonical edge at
    the HBM rate.  The strict bound assumes gathers fused into the
    kernels, which write no per-edge row; this one is what the port's
    design can approach."""
    lanes = compact_step_edge_lanes(heads, d_head)
    base = rgat_compact_step_roofline_ms(g, f_in, heads, d_head, n_classes,
                                         itemsize=itemsize, peaks=peaks)
    edge_bytes = (g.num_padded_edges * (lanes["forward"] + lanes["backward"])
                  * itemsize)
    return base + edge_bytes / (peaks["hbm_gbps"] * 1e9) * 1e3


def speed_of_light_report(g: "HeteroGraph", measured_ms: Dict[str, float],
                          f_in: int, heads: int, d_out: int, *,
                          peaks: Dict[str, float]) -> str:
    """Percent of each op's bound given its measured ms (het_tpu's JSON
    rows: op, ideal_ms, measured_ms, speed_of_light_pct,
    arith_intensity)."""
    rows = []
    for name, cost in rgat_layer_costs(g, f_in, heads, d_out).items():
        ideal = cost.time_ms(peaks)
        got = measured_ms.get(name)
        pct = (ideal / got * 100.0) if got else None
        rows.append({
            "op": name,
            "ideal_ms": round(ideal, 4),
            "measured_ms": got,
            "speed_of_light_pct": round(pct, 1) if pct else None,
            "arith_intensity": round(cost.intensity(), 2),
        })
    return json.dumps(rows, indent=2)


@contextlib.contextmanager
def trace(logdir: str, *, cuda: bool = True):
    """Profile the block with ``torch.profiler`` (CPU and, where ``cuda``,
    CUDA activities; CPU only when no GPU is asked for) and write its
    Chrome trace to ``logdir/trace.json``; yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
