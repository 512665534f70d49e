"""Heterogeneous Graph Transformer (HGT).

Counterpart of ``het_tpu/models/hgt.py`` with the same parameter names and
shapes: per node type ``k_linears``, ``q_linears``, ``v_linears`` (T, H,
in, d_k) and ``a_linears`` (T, 1, out, out); per relation
``relation_pri`` (R, H, ones), ``relation_att`` and ``relation_msg`` (R,
H, d_k, d_k); ``skip`` (T, 1, 1, 1, ones); with ``use_norm`` a LayerNorm
(flax's ``LayerNorm_0``: eps 1e-6, ``scale`` is ``norm.weight``).  A layer:

    k, q, v = ntype_linear(h, W_k | W_q | W_v)      (N, H, d_k)
    out[v]  = sum_{dst(e)=v} softmax_v(<k[src] W_att[rel], q[dst]> * mu[rel])
              * v[src] W_msg[rel],      mu = relation_pri / sqrt(d_k)
    h'      = ntype_linear(out, sigmoid(skip) * a_linears)

in three forms:

* plain: the whole core is one op (``ops.hgt_plain_layer_core``), both
  typed linears on the relation-sorted edge rows with an input row a head;
* compact (``--compact_as_of_node_flag``): ``q W_att`` once a unique
  (relation, destination) pair and ``v W_msg`` once a unique (relation,
  source) pair (``ops.compact_typed_linear`` of per-head rows), then the
  fused compact attention (``ops.hgt_compact_attention``);
* multiply-first: the projections folded into per-relation weights over
  the raw features, ``h_src (W_k W_att W_q^T) h_dst`` and ``h_src (W_v
  W_msg)``, with v from the source node type and any H, as het_tpu has it
  (the reference draws v from the destination type and allows H = 1).

``stable_softmax`` is False/"raw", "clip" or "max" in every form.  On a
shard of a partitioned graph the ``halo`` hook carries the projected k and
v into the source space; q stays local.  HGT has no activation between
layers.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn

from .. import ops
from ..utils import spans
from .rgat import dropout, xavier_uniform_

LAYER_NORM_EPS = 1e-6  # flax's LayerNorm default (torch's is 1e-5)


def _by_type(w: torch.Tensor, types: Sequence[int]) -> torch.Tensor:
    """``w[types]`` along the first axis as a stack of selects: the
    backward adds each select's slice in a fixed order, with no atomic
    ``index_put_``."""
    return torch.stack([w[t] for t in types])


class HGTLayer(nn.Module):
    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        num_ntypes: int,
        num_rels: int,
        num_heads: int = 1,
        *,
        dropout: float = 0.2,
        use_norm: bool = False,
        compact: bool = False,
        multiply_first: bool = False,
        src_ntype_per_rel: Optional[Sequence[int]] = None,
        dst_ntype_per_rel: Optional[Sequence[int]] = None,
        stable_softmax=False,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if out_dim % num_heads:
            raise ValueError("out_dim must be a multiple of num_heads")
        if multiply_first and (src_ntype_per_rel is None
                               or dst_ntype_per_rel is None):
            raise ValueError("multiply_first needs src_ntype_per_rel and "
                             "dst_ntype_per_rel")
        self.out_dim = out_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.compact = compact
        self.multiply_first = multiply_first
        self.src_ntype_per_rel = (tuple(int(t) for t in src_ntype_per_rel)
                                  if multiply_first else None)
        self.dst_ntype_per_rel = (tuple(int(t) for t in dst_ntype_per_rel)
                                  if multiply_first else None)
        self.stable_softmax = stable_softmax
        self.impl = impl
        T, R, H = num_ntypes, num_rels, num_heads
        d_k = out_dim // H
        self.k_linears = nn.Parameter(torch.empty(T, H, in_dim, d_k))
        self.q_linears = nn.Parameter(torch.empty(T, H, in_dim, d_k))
        self.v_linears = nn.Parameter(torch.empty(T, H, in_dim, d_k))
        self.a_linears = nn.Parameter(torch.empty(T, 1, out_dim, out_dim))
        self.relation_pri = nn.Parameter(torch.ones(R, H))
        self.relation_att = nn.Parameter(torch.empty(R, H, d_k, d_k))
        self.relation_msg = nn.Parameter(torch.empty(R, H, d_k, d_k))
        self.skip = nn.Parameter(torch.ones(T, 1, 1, 1))
        for p in (self.k_linears, self.q_linears, self.v_linears,
                  self.a_linears, self.relation_att, self.relation_msg):
            xavier_uniform_(p, generator)
        self.norm = (nn.LayerNorm(out_dim, eps=LAYER_NORM_EPS) if use_norm
                     else None)

    def forward(self, g, h: torch.Tensor, *,
                halo: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``h`` holds the graph's destination rows; ``halo``, where given,
        maps the per-node k and v projections into its source space (a
        shard's exchange; the identity when None)."""
        d_k = self.out_dim // self.num_heads
        mu = self.relation_pri / math.sqrt(d_k)
        if self.multiply_first:
            new_h = self._multiply_first(g, h, mu)
        else:
            new_h = self._projected(g, h, mu, halo or (lambda t: t))
        gated_a = torch.sigmoid(self.skip) * self.a_linears
        out = ops.ntype_linear(g, new_h.reshape(g.num_nodes, self.out_dim),
                               gated_a, impl=self.impl)[:, 0, :]
        if self.norm is not None:
            out = self.norm(out)
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            out = dropout(out, self.dropout, generator)
        return out

    def _projected(self, g, h, mu, halo):
        impl, stable = self.impl, self.stable_softmax
        k = halo(ops.ntype_linear(g, h, self.k_linears, impl=impl))
        q = ops.ntype_linear(g, h, self.q_linears, impl=impl)
        v = halo(ops.ntype_linear(g, h, self.v_linears, impl=impl))
        if self.compact:
            att_q_c = ops.compact_typed_linear(g, q, self.relation_att, "dst",
                                               impl=impl)
            message_c = ops.compact_typed_linear(g, v, self.relation_msg,
                                                 "src", impl=impl)
            return ops.hgt_compact_attention(g, message_c, att_q_c, k, mu,
                                             stable=stable, impl=impl)
        return ops.hgt_plain_layer_core(g, v, q, k, self.relation_msg,
                                        self.relation_att, mu,
                                        stable=stable, impl=impl)

    def _multiply_first(self, g, h, mu):
        """score_e = h_src . (W_k W_att W_q^T)[rel] . h_dst and msg_e =
        h_src . (W_v W_msg)[rel], per relation from its source and
        destination node types."""
        impl = self.impl
        k_w = _by_type(self.k_linears, self.src_ntype_per_rel)
        q_w = _by_type(self.q_linears, self.dst_ntype_per_rel)
        v_w = _by_type(self.v_linears, self.src_ntype_per_rel)
        # score = q_dst^T W_att k_src: M[i, j] = sum W_k[i, l] W_att[k, l]
        # W_q[j, k]
        w_score = torch.einsum("rhil,rhkl,rhjk->rhij", k_w,
                               self.relation_att, q_w)  # (R, H, in, in)
        w_vmsg = torch.einsum("rhik,rhkl->rhil", v_w,
                              self.relation_msg)  # (R, H, in, d_k)
        hq_e = ops.edge_typed_linear(g, h, w_score, "src", impl=impl)
        score = (hq_e * ops.gather_dst(g, h, impl=impl)[:, None, :]).sum(-1)
        message_e = ops.edge_typed_linear(g, h, w_vmsg, "src", impl=impl)
        return ops.hgt_softmax_weighted_agg(g, message_e, score, mu,
                                            stable=self.stable_softmax,
                                            impl=impl)


class HGTModel(nn.Module):
    """``num_layers`` HGT layers from ``in_dim`` through ``hidden`` to
    ``num_classes`` (het_tpu's ``HGTModel``, the reference's
    ``HET_HGT_DGLHetero``), with no activation between them."""

    def __init__(
        self,
        in_dim: int,
        hidden: int,
        num_classes: int,
        num_ntypes: int,
        num_rels: int,
        num_heads: int = 1,
        num_layers: int = 1,
        *,
        dropout: float = 0.2,
        compact: bool = False,
        stable_softmax=False,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_dim] + [hidden] * (num_layers - 1) + [num_classes]
        self.layers = nn.ModuleList(
            HGTLayer(dims[i], dims[i + 1], num_ntypes, num_rels, num_heads,
                     dropout=dropout, compact=compact,
                     stable_softmax=stable_softmax, impl=impl,
                     generator=generator)
            for i in range(num_layers)
        )

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            with spans.span("layer", i):
                h = layer(g, h, generator=generator)
        return h
