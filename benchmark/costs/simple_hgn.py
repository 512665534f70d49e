"""The least work of one full-graph Simple-HGN training step (forward,
backward, Adam), from the configuration's widths and the graph's sizes,
and the least bytes of its attention op (``agg_bytes``, the yardstick of
``hgn_agg_roofline_pct``).

The input is a linear with bias a node type, 2 K hid + hid a node, its
bytes ``layer_bytes``' without the graph.  A
layer (F in, ``heads`` of D, HD = heads D out, Fe the edge-type width, E1
= E + N edges with the self-loops) needs: the projection, 2 F HD a
node; each of the logits ``el`` and ``er``, the lesser of 2 HD a node and
the weights folded first (2 F HD once, then 2 F heads a node); the
edge-type table, 2 Fe (heads Fe) + 2 heads Fe a type; an edge's three-way
add (2 heads), leaky ReLU, exp and division (3 heads), weighted sum (2
HD) and denominator (heads), with the residual attention's mix (3 heads)
where the layer takes it; a node's residual (HD, plus 2 F HD through a
linear) and, in hidden layers, ELU (HD).  The logits' L2 norm, 3 a
logit.

The op's least bytes a layer (f32): forward, each edge's source row read
once and each output row written once; backward, each edge's source row
and destination cotangent row read once and each source gradient
written once; the node tables (``el``, ``er`` read forward and backward,
the denominators written and read, ``d_el``, ``d_er`` written), the
edge-type table (read twice, its gradient written) and the attention a
layer hands on (written) or takes (read forward and backward), one f32 a
head an edge.
"""

from __future__ import annotations

from typing import Dict, Mapping

from benchmark.costs.common import (BACKWARD, F32, adam_cost, layer_bytes,
                                    loss_cost)


def _layers(cfg: Mapping):
    """(F in, heads, D) a layer: the hidden layers, then one head."""
    L, H, hid = int(cfg["num_layers"]), int(cfg["num_heads"]), cfg["hidden"]
    out = [(hid if i == 0 else H * hid, H, hid) for i in range(L - 1)]
    return out + [(H * hid if L > 1 else hid, 1, cfg["num_classes"])]


def agg_bytes(cfg: Mapping, sizes: Mapping[str, int]) -> float:
    """The attention op's least bytes a step, forward and backward."""
    n, r = sizes["num_nodes"], sizes["num_rels"]
    e1 = sizes["num_edges"] + n
    layers = _layers(cfg)
    total = 0.0
    for i, (_, heads, d) in enumerate(layers):
        keep = i + 1 < len(layers) - 1
        prev = 0 < i < len(layers) - 1
        hd = heads * d
        total += F32 * (3.0 * e1 * hd + 2.0 * n * hd + 8.0 * n * heads
                        + 3.0 * (r + 1) * heads
                        + e1 * heads * (keep + 2 * prev))
    return total


def step_cost(cfg: Mapping, sizes: Mapping[str, int]) -> Dict[str, float]:
    n, e, r = sizes["num_nodes"], sizes["num_edges"], sizes["num_rels"]
    t, k, hid = sizes["num_ntypes"], cfg["n_infeat"], cfg["hidden"]
    fe = int(cfg["edge_feats"])
    e1 = e + n
    layers = _layers(cfg)
    fwd = n * (2.0 * k * hid + hid)
    # the input linear reads no graph: layer_bytes' terms but the graph's
    nbytes = F32 * (3.0 * n * k + 2.0 * n * hid + 3.0 * t * (k + 1) * hid)
    for i, (f, heads, d) in enumerate(layers):
        hd = heads * d
        hidden, prev = i < len(layers) - 1, 0 < i < len(layers) - 1
        res_fc = i > 0 and f != hd
        logit = min(2.0 * n * hd, 2.0 * f * hd + 2.0 * n * f * heads)
        fwd += (2.0 * n * f * hd + 2 * logit
                + (r + 1) * (2.0 * fe * heads * fe + 2.0 * heads * fe)
                + e1 * (6.0 * heads + 2.0 * hd + 3.0 * heads * prev)
                + n * hd * ((i > 0) + hidden) + 2.0 * n * f * hd * res_fc)
        params = (f * hd * (1 + res_fc) + 2 * hd + (r + 1) * fe
                  + fe * heads * fe + heads * fe)
        nbytes += layer_bytes(sizes, f, hd, params)
    c = cfg["num_classes"]
    fwd += 3.0 * n * c
    lf, lb = loss_cost(sizes, c)
    af, ab = adam_cost(sizes["num_params"])
    return {"flops": fwd * (1 + BACKWARD) + lf + af,
            "bytes": nbytes + lb + ab, "agg_bytes": agg_bytes(cfg, sizes)}
