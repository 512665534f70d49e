"""Simple-HGN (Lv et al., "Are we really making much progress? Revisiting,
benchmarking, and refining heterogeneous graph neural networks", KDD
2021; HGB's ``myGAT`` and ``myGATConv``).

A layer of H heads of D, input h (N, F), R relations plus a self-loop
type R (one self-loop a node, a term of the softmax, not an edge of the
graph), one projection for every node and edge type:

    f      = h W                                  W (F, H*D)
    el, er = <f_h, attn_l[h]>, <f_h, attn_r[h]>   (N, H)
    ee[r]  = <(edge_emb[r] fc_e)_h, attn_e[h]>    edge_emb (R+1, Fe),
                                                  fc_e (Fe, H*Fe)
    a_e    = softmax_v(leaky_relu(el[u] + er[v] + ee[r], slope))
    a_e   <- (1 - beta) a_e + beta a_e^prev       (hidden layers after
                                                   the first)
    out[v] = sum_e a_e f[u] + residual

The residual is none in the first layer, ``h`` where F = H*D and ``h
res_fc`` (no bias) otherwise; the conv has no bias.  Hidden layers apply
ELU and flatten the heads; the output layer (one head of ``num_classes``)
has no activation, and the model divides its logits by ``max(|logits|_2,
1e-12)``.  The input is one linear with bias a node type (``fc_in``).
``a^prev`` is the previous layer's attention, detached; the output layer
takes none.  Each layer's whole attention runs in one op,
``ops.simple_hgn_attention``.

The model has no dropout (HGB's feature and attention dropout).  Every
1-D or bias leaf is named ``*.bias``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..utils import spans
from .rgat import xavier_uniform_

# HGB's published settings (``NC/benchmark/methods/baseline``'s runs),
# the model's constants
EDGE_FEATS = 64  # edge-type embedding width
BETA = 0.05  # residual attention
SLOPE = 0.05  # leaky ReLU


def _param(shape, generator):
    return nn.Parameter(xavier_uniform_(torch.empty(*shape), generator))


class TypeAffine(nn.Module):
    """One linear with bias a node type, over the graph's contiguous
    node-type ranges (``ntype_offsets``): ``weight`` (T, K, O) through
    ``ops.ntype_linear``, ``bias`` (T, O) broadcast over its type's
    rows."""

    def __init__(self, num_ntypes: int, in_feat: int, out_feat: int, *,
                 impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.impl = impl
        self.weight = _param((num_ntypes, in_feat, out_feat), generator)
        self.bias = nn.Parameter(torch.zeros(num_ntypes, out_feat))

    def forward(self, g, x: torch.Tensor) -> torch.Tensor:
        offs = g.ntype_offsets
        if len(offs) - 1 != g.num_ntypes:
            raise ValueError("Simple-HGN's input linear needs node types "
                             "in contiguous ranges (ntype_offsets)")
        y = ops.ntype_linear(g, x, self.weight[:, None], impl=self.impl)
        return y[:, 0] + torch.cat([b.expand(offs[t + 1] - offs[t], -1)
                                    for t, b in enumerate(self.bias)])


class SimpleHGNLayer(nn.Module):
    """One ``myGATConv``: parameters ``fc`` (F, H*D), ``attn_l``, ``attn_r``
    (H, D), ``edge_emb`` (R+1, Fe), ``fc_e`` (Fe, H*Fe), ``attn_e`` (H,
    Fe) and, with a residual where F != H*D, ``res_fc`` (F, H*D).
    ``keep_alpha``: the layer hands its attention to the next."""

    def __init__(self, in_feat: int, out_feat: int, num_heads: int,
                 num_rels: int, *, residual: bool = True,
                 activation: bool = True, keep_alpha: bool = False,
                 stable_softmax: str = "clip", impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        H, D, Fe = num_heads, out_feat, EDGE_FEATS
        self.stable, self.impl = stable_softmax, impl
        self.activation, self.keep_alpha = activation, keep_alpha
        self.fc = _param((in_feat, H * D), generator)
        self.attn_l = _param((H, D), generator)
        self.attn_r = _param((H, D), generator)
        self.edge_emb = _param((num_rels + 1, Fe), generator)
        self.fc_e = _param((Fe, H * Fe), generator)
        self.attn_e = _param((H, Fe), generator)
        self.residual = residual
        self.res_fc = None
        if residual and in_feat != H * D:
            self.res_fc = _param((in_feat, H * D), generator)

    def forward(self, g, x: torch.Tensor,
                alpha_prev: Optional[torch.Tensor] = None):
        """x (N, F) -> (N, H*D) and, where ``keep_alpha``, this layer's
        attention (EP + N, H)."""
        f, el, er = ops.attention_projection(x, self.fc, self.attn_l,
                                             self.attn_r)
        ee = ops.edge_type_logits(self.edge_emb, self.fc_e, self.attn_e)
        h, alpha = ops.simple_hgn_attention(
            g, f, el, er, ee, alpha_prev, beta=BETA, slope=SLOPE,
            stable=self.stable, keep_alpha=self.keep_alpha, impl=self.impl)
        if self.residual:
            h = h + (x if self.res_fc is None
                     else ops.node_linear(x, self.res_fc))
        if self.activation:
            h = F.elu(h)
        return h, alpha


class SimpleHGNModel(nn.Module):
    """``fc_in``, then ``num_layers - 1`` hidden layers of ``num_heads`` x
    ``hidden`` (ELU; residual attention from the second on), then one
    head of ``num_classes``; L2-normalized logits (N, num_classes)."""

    def __init__(self, in_feat: int, hidden: int, num_classes: int,
                 num_heads: int, num_layers: int, num_rels: int,
                 num_ntypes: int, *, stable_softmax: str = "clip",
                 impl: str = "kernel",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if stable_softmax not in ("clip", "raw"):
            raise ValueError("Simple-HGN's softmax is 'clip' or 'raw', not "
                             f"{stable_softmax!r}")
        self.fc_in = TypeAffine(num_ntypes, in_feat, hidden, impl=impl,
                                generator=generator)
        width = hidden * num_heads
        kw = dict(stable_softmax=stable_softmax, impl=impl,
                  generator=generator)
        hidden_layers = num_layers - 1
        self.layers = nn.ModuleList(
            SimpleHGNLayer(hidden if i == 0 else width, hidden, num_heads,
                           num_rels, residual=i > 0,
                           keep_alpha=i + 1 < hidden_layers, **kw)
            for i in range(hidden_layers))
        self.layers.append(SimpleHGNLayer(
            width if hidden_layers else hidden, num_classes, 1, num_rels,
            residual=hidden_layers > 0, activation=False, **kw))

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h, alpha = self.fc_in(g, x), None
        for i, layer in enumerate(self.layers):
            with spans.span("layer", i):
                h, alpha = layer(g, h, alpha)
        return h / h.norm(dim=1, keepdim=True).clamp_min(1e-12)
