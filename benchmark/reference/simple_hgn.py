"""Plain reference of Simple-HGN (Lv et al., KDD 2021, arXiv:2112.14936;
HGB's ``myGAT`` / ``myGATConv``, github.com/THUDM/HGB,
``NC/benchmark/methods/baseline``): learned node embeddings through a
linear with bias a node type, ``num_layers - 1`` hidden layers of H heads
and an output layer of one head.

A layer of ``heads`` heads of D, input h (N, F), per head, over the
graph's edges e = (u, v, r) and one self-loop (v, v, R) a node (R the
number of relations):

    f      = h W_fc                                   (N, heads, D)
    el, er = <f[n], attn_l>, <f[n], attn_r>
    ee[r]  = <(edge_emb[r] W_e)_h, attn_e[h]>         (R + 1 rows)
    l_e    = clip(leaky_relu(el[u] + er[v] + ee[r], slope))
    a_e    = softmax_v(l)_e
    a_e   <- (1 - beta) a_e + beta a_e^prev   (a hidden layer after a
                                               hidden layer; a^prev the
                                               previous layer's, detached)
    out[v] = sum_{e -> v} a_e f[u] + res[v]

``res`` is 0 in the first layer, ``h[v]`` where F = heads * D and
``h[v] W_res`` otherwise.  Hidden layers apply ELU to the flattened
heads; the output layer (1 head of ``num_classes``) none, and its logits
are divided by ``max(|logits|_2, 1e-12)``.

Departures from HGB, each for the reason given:

* "clip": the logits are clamped to +-60 in place of DGL's
  max-subtracted edge softmax (the configuration's ``stable_softmax``;
  "raw" leaves them unclamped), as the other cells' references do;
* no reverse-edge types: the traffic's graph is used as the other cells
  use it, its R relations and the self-loops' type;
* the residual is the identity where the input width equals heads * D,
  as the layer equations read (HGB's code, copied from an older DGL
  ``GATConv``, compares the input width with D alone and takes a linear
  there);
* dropout 0 (masks would tie the reference to the program's random
  stream), no weight decay and lr 0.01 (the harness's Adam; HGB trains
  at 5e-4 with weight decay 1e-4).

The edges are walked in chunks of at most ``CHUNK`` edges (the graph's
relation blocks cut further, then the self-loops), each under
``torch.utils.checkpoint``: a first pass sums the denominators, a second
the weighted messages.  Parameter names are the program's state-dict
names.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.common import CLIP_LOGIT, RefGraph

CHUNK = 1 << 20  # edges a checkpointed chunk (2 GB at 512 f32 lanes)


def _layers(cfg: Mapping) -> List[Tuple[int, int, int]]:
    """(in width, heads, D) a layer."""
    L, H, hid = int(cfg["num_layers"]), int(cfg["num_heads"]), cfg["hidden"]
    out = [(hid if i == 0 else H * hid, H, hid) for i in range(L - 1)]
    return out + [(H * hid if L > 1 else hid, 1, cfg["num_classes"])]


def param_shapes(cfg: Mapping, num_nodes: int, num_rels: int,
                 num_ntypes: int) -> Dict[str, Tuple[int, ...]]:
    fe, hid = int(cfg["edge_feats"]), cfg["hidden"]
    shapes = {"embed.embed": (num_nodes, cfg["n_infeat"]),
              "model.fc_in.weight": (num_ntypes, cfg["n_infeat"], hid),
              "model.fc_in.bias": (num_ntypes, hid)}
    for i, (k, heads, d) in enumerate(_layers(cfg)):
        p = f"model.layers.{i}."
        shapes[p + "fc"] = (k, heads * d)
        shapes[p + "attn_l"] = (heads, d)
        shapes[p + "attn_r"] = (heads, d)
        shapes[p + "edge_emb"] = (num_rels + 1, fe)
        shapes[p + "fc_e"] = (fe, heads * fe)
        shapes[p + "attn_e"] = (heads, fe)
        if i > 0 and k != heads * d:
            shapes[p + "res_fc"] = (k, heads * d)
    return shapes


def _chunks(graph: RefGraph) -> List[Tuple[torch.Tensor, torch.Tensor,
                                           int]]:
    """(src, dst, edge type) chunks: the relation blocks, then the
    self-loops (type R)."""
    out = []
    for b in graph.blocks:
        for a in range(0, b.src.numel(), CHUNK):
            out.append((b.src[a:a + CHUNK], b.dst[a:a + CHUNK], b.rel))
    dev = graph.blocks[0].src.device if graph.blocks else None
    for a in range(0, graph.num_nodes, CHUNK):
        loop = torch.arange(a, min(a + CHUNK, graph.num_nodes), device=dev)
        out.append((loop, loop, graph.num_rels))
    return out


def _logits(src, dst, el, er, ee_r, slope: float, clip: Optional[float]):
    lg = F.leaky_relu(el[src] + er[dst] + ee_r, slope)
    return lg if clip is None else lg.clamp(-clip, clip)


def _attend(chunks, f3, el, er, ee, prev, beta: float, slope: float,
            clip: Optional[float]):
    """``out`` (N, heads, D) and the attention of every chunk, detached
    (mixed with ``prev``, a list a chunk, where given)."""
    N, heads, D = f3.shape

    def den_chunk(src, dst, el, er, ee_r):
        z = torch.exp(_logits(src, dst, el, er, ee_r, slope, clip))
        return el.new_zeros(N, heads).index_add(0, dst, z)

    def num_chunk(src, dst, el, er, ee_r, den, f3, p):
        a = torch.exp(_logits(src, dst, el, er, ee_r, slope, clip)) / den[dst]
        if p is not None:
            a = a * (1 - beta) + p * beta
        return f3.new_zeros(N, heads, D).index_add(0, dst,
                                                   a[..., None] * f3[src]), a

    den = el.new_zeros(N, heads)
    for src, dst, r in chunks:
        den = den + checkpoint(den_chunk, src, dst, el, er, ee[r],
                               use_reentrant=False)
    out, alphas = f3.new_zeros(N, heads, D), []
    for j, (src, dst, r) in enumerate(chunks):
        n, a = checkpoint(num_chunk, src, dst, el, er, ee[r], den, f3,
                          None if prev is None else prev[j],
                          use_reentrant=False)
        out = out + n
        alphas.append(a.detach())
    return out, alphas


def forward(params: Mapping[str, torch.Tensor], graph: RefGraph,
            cfg: Mapping) -> torch.Tensor:
    """The L2-normalized logits of every node."""
    clip = {"clip": CLIP_LOGIT, "raw": None}[cfg["stable_softmax"]]
    beta, slope, fe = float(cfg["beta"]), float(cfg["slope"]), int(
        cfg["edge_feats"])
    N, offs = graph.num_nodes, graph.ntype_offsets
    x, w, b = (params["embed.embed"], params["model.fc_in.weight"],
               params["model.fc_in.bias"])
    h = torch.cat([x[offs[t]:offs[t + 1]] @ w[t] + b[t]
                   for t in range(len(offs) - 1)])
    chunks = _chunks(graph)
    layers = _layers(cfg)
    alphas = None
    for i, (_, heads, d) in enumerate(layers):
        p = f"model.layers.{i}."
        f3 = (h @ params[p + "fc"]).view(N, heads, d)
        el = (f3 * params[p + "attn_l"]).sum(-1)
        er = (f3 * params[p + "attn_r"]).sum(-1)
        ee = ((params[p + "edge_emb"] @ params[p + "fc_e"]).view(
            -1, heads, fe) * params[p + "attn_e"]).sum(-1)
        hidden = i < len(layers) - 1
        out, alphas = _attend(chunks, f3, el, er, ee,
                              alphas if 0 < i and hidden else None, beta,
                              slope, clip)
        out = out.reshape(N, heads * d)
        if i > 0:
            out = out + (h @ params[p + "res_fc"] if p + "res_fc" in params
                         else h)
        h = F.elu(out) if hidden else out
    return h / h.norm(dim=1, keepdim=True).clamp_min(1e-12)
