"""Plain reference of the HGT node classifier: learned node embeddings
through ``num_layers`` HGT layers with no activation between them.

A layer, per head h of H (d = out / H), node types t(n), over edges e =
(s, v, r):

    k, q, m = h[n] W_k[t(n)], h[n] W_q[t(n)], h[n] W_v[t(n)]   (N, H, d)
    l_e     = clip(<q[v] W_att[r], k[s]> * pri[r] / sqrt(d))
    out[v]  = sum_{dst(e)=v} softmax_v(l)_e m[s] W_msg[r]   (0 without
              in-edges)
    h'[n]   = concat_h out[n] (sigmoid(skip[t(n)]) A[t(n)])

with ``clip`` the clamp to +-60 of the configuration's "clip" softmax.
No residual and no layer norm: the trainer's HGT has neither.  The
per-relation products ``q W_att[r]`` and ``m W_msg[r]`` are taken once a
node and relation, and gathered by edge.  Parameter names are the
program's state-dict names.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import torch

from benchmark.reference.common import (CLIP_LOGIT, RefGraph,
                                        softmax_aggregate, type_linear)


def _dims(cfg: Mapping) -> list:
    L = int(cfg["num_layers"])
    return [cfg["n_infeat"]] + [cfg["hidden"]] * (L - 1) + [
        cfg["num_classes"]]


def param_shapes(cfg: Mapping, num_nodes: int, num_rels: int,
                 num_ntypes: int) -> Dict[str, Tuple[int, ...]]:
    H, T, R = int(cfg["num_heads"]), num_ntypes, num_rels
    dims = _dims(cfg)
    shapes = {"embed.embed": (num_nodes, cfg["n_infeat"])}
    for i in range(len(dims) - 1):
        K, O = dims[i], dims[i + 1]
        d = O // H
        p = f"model.layers.{i}."
        for lin in ("k_linears", "q_linears", "v_linears"):
            shapes[p + lin] = (T, H, K, d)
        shapes[p + "a_linears"] = (T, 1, O, O)
        shapes[p + "relation_pri"] = (R, H)
        shapes[p + "relation_att"] = (R, H, d, d)
        shapes[p + "relation_msg"] = (R, H, d, d)
        shapes[p + "skip"] = (T, 1, 1, 1)
    return shapes


def _per_head(x, w):
    """(N, H, d) rows times (H, d, d) weights, a head at a time."""
    return torch.bmm(x.transpose(0, 1), w).transpose(0, 1).contiguous()


def _edges(src, dst, k, q_att, m_msg, mu):
    score = (q_att[dst] * k[src]).sum(-1)
    logit = (score * mu).clamp(-CLIP_LOGIT, CLIP_LOGIT)
    return logit, m_msg[src]


def forward(params: Mapping[str, torch.Tensor], graph: RefGraph,
            cfg: Mapping) -> torch.Tensor:
    """The logits of every node."""
    H = int(cfg["num_heads"])
    offs = graph.ntype_offsets
    h = params["embed.embed"]
    for i in range(int(cfg["num_layers"])):
        p = f"model.layers.{i}."
        k, q, v = (type_linear(h, params[p + n], offs)
                   for n in ("k_linears", "q_linears", "v_linears"))
        d = k.shape[-1]
        mu = params[p + "relation_pri"] / math.sqrt(d)
        w_att, w_msg = params[p + "relation_att"], params[p + "relation_msg"]
        per_rel = [(_per_head(q, w_att[r]), _per_head(v, w_msg[r]), mu[r])
                   for r in range(graph.num_rels)]
        out = softmax_aggregate(graph, _edges, [k], per_rel.__getitem__, H,
                                d)
        gate = torch.sigmoid(params[p + "skip"]) * params[p + "a_linears"]
        h = type_linear(out.reshape(graph.num_nodes, H * d), gate,
                        offs)[:, 0, :]
    return h
