"""The least work of one full-graph HGT training step (forward,
backward, Adam), from the configuration's widths and the graph's sizes.

A layer (K in, O = H * d out, T node types) needs: k, q and v a node, 2 K
O each; ``q W_att`` once a unique (relation, destination) pair and ``v
W_msg`` once a unique (relation, source) pair, 2 O d each; an edge's
score (2 O), scale and exp (2 H), weighted sum (2 O) and denominator (H);
a node's division (O) and output linear (2 O O).
"""

from __future__ import annotations

from typing import Dict, Mapping

from benchmark.costs.common import (BACKWARD, adam_cost, layer_bytes,
                                    loss_cost)


def step_cost(cfg: Mapping, sizes: Mapping[str, int]) -> Dict[str, float]:
    H, L = int(cfg["num_heads"]), int(cfg["num_layers"])
    dims = [cfg["n_infeat"]] + [cfg["hidden"]] * (L - 1) + [
        cfg["num_classes"]]
    n, e = sizes["num_nodes"], sizes["num_edges"]
    r, t = sizes["num_rels"], sizes["num_ntypes"]
    us, ud = sizes["unique_src_pairs"], sizes["unique_dst_pairs"]
    flops = nbytes = 0.0
    for i in range(L):
        k, o = dims[i], dims[i + 1]
        d = o // H
        fwd = (6.0 * n * k * o + 2.0 * (us + ud) * o * d
               + e * (4.0 * o + 3.0 * H) + n * (o + 2.0 * o * o))
        flops += fwd * (1 + BACKWARD)
        params = 3 * t * k * o + t * o * o + r * H + 2 * r * H * d * d + t
        nbytes += layer_bytes(sizes, k, o, params)
    lf, lb = loss_cost(sizes, cfg["num_classes"])
    af, ab = adam_cost(sizes["num_params"])
    return {"flops": flops + lf + af, "bytes": nbytes + lb + ab}
