"""The least work of one full-graph RGAT training step (forward,
backward, Adam), from the configuration's widths and the graph's sizes.

A layer (K in, O = H * D out, R relations) needs: the typed linear once a
unique (relation, source) pair (``unique_src_pairs``), 2 K O each; the
source logit from it, 2 O; the destination logit through ``W a_r`` folded
once a relation (2 R K O), 2 K H a unique (relation, destination) pair;
an edge's add, leaky ReLU and exp (3 H), weighted sum (2 O) and
denominator (H); a node's division, bias and, between layers, ReLU.
"""

from __future__ import annotations

from typing import Dict, Mapping

from benchmark.costs.common import (BACKWARD, adam_cost, layer_bytes,
                                    loss_cost)


def step_cost(cfg: Mapping, sizes: Mapping[str, int]) -> Dict[str, float]:
    H, L = int(cfg["num_heads"]), int(cfg["num_layers"])
    dims = [cfg["n_infeat"]] + [cfg["hidden"]] * (L - 1) + [
        cfg["num_classes"]]
    n, e, r = sizes["num_nodes"], sizes["num_edges"], sizes["num_rels"]
    us, ud = sizes["unique_src_pairs"], sizes["unique_dst_pairs"]
    flops = nbytes = 0.0
    for i in range(L):
        k, o = dims[i], dims[i + 1]
        fwd = (2.0 * us * k * o + 2.0 * us * o + 2.0 * r * k * o
               + 2.0 * ud * k * H + e * (4.0 * H + 2.0 * o)
               + n * o * (3 if i < L - 1 else 2))
        flops += fwd * (1 + BACKWARD)
        nbytes += layer_bytes(sizes, k, o, r * H * k * (o // H)
                              + 2 * r * o + o)
    lf, lb = loss_cost(sizes, cfg["num_classes"])
    af, ab = adam_cost(sizes["num_params"])
    return {"flops": flops + lf + af, "bytes": nbytes + lb + ab}
