"""Plain reference of the relational GAT node classifier: learned node
embeddings through ``num_layers`` RGAT layers, ReLU between layers.

A layer, per head h of H, over edges e = (s, v, r):

    f_e    = x[s] W[r]                        (W: (R, H, K, D))
    l_e    = clip(leaky_relu(<f_e, a_l[r]> + <x[v] W[r], a_r[r]>, 0.2))
    out[v] = sum_{dst(e)=v} softmax_v(l)_e f_e     (0 without in-edges)
    h'[v]  = concat_h out[v] + b

with ``clip`` the clamp to +-60 of the configuration's "clip" softmax.
The layer is computed per edge whatever the trainer's flags: compact
materialization and multiply-first change how the program computes it,
not what.  Parameter names are the program's state-dict names, so that
the same seeded values load into both.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.common import (CLIP_LOGIT, RefGraph,
                                        softmax_aggregate)

SLOPE = 0.2


def _dims(cfg: Mapping) -> list:
    L = int(cfg["num_layers"])
    return [cfg["n_infeat"]] + [cfg["hidden"]] * (L - 1) + [
        cfg["num_classes"]]


def param_shapes(cfg: Mapping, num_nodes: int, num_rels: int,
                 num_ntypes: int) -> Dict[str, Tuple[int, ...]]:
    H = int(cfg["num_heads"])
    dims = _dims(cfg)
    shapes = {"embed.embed": (num_nodes, cfg["n_infeat"])}
    for i in range(len(dims) - 1):
        K, O = dims[i], dims[i + 1]
        p = f"model.layers.{i}."
        shapes[p + "conv_weights"] = (num_rels, H, K, O // H)
        shapes[p + "attn_l"] = (num_rels, H, O // H)
        shapes[p + "attn_r"] = (num_rels, H, O // H)
        shapes[p + "h_bias"] = (O,)
    return shapes


def _edges(src, dst, x, w, al, ar):
    K = x.shape[1]
    H, _, D = w.shape
    w2 = w.permute(1, 0, 2).reshape(K, H * D)
    f = (x[src] @ w2).view(-1, H, D)
    fd = (x[dst] @ w2).view(-1, H, D)
    logit = (f * al).sum(-1) + (fd * ar).sum(-1)
    return F.leaky_relu(logit, SLOPE).clamp(-CLIP_LOGIT, CLIP_LOGIT), f


def forward(params: Mapping[str, torch.Tensor], graph: RefGraph,
            cfg: Mapping) -> torch.Tensor:
    """The logits of every node."""
    H = int(cfg["num_heads"])
    h = params["embed.embed"]
    L = int(cfg["num_layers"])
    for i in range(L):
        p = f"model.layers.{i}."
        w, al, ar = (params[p + "conv_weights"], params[p + "attn_l"],
                     params[p + "attn_r"])
        out = softmax_aggregate(
            graph, _edges, [h],
            lambda r: (w[r], al[r], ar[r]), H, w.shape[-1])
        h = out.reshape(graph.num_nodes, -1) + params[p + "h_bias"]
        if i < L - 1:
            h = torch.relu(h)
    return h
