"""Relational GAT (RGAT).

Counterpart of ``het_tpu/models/rgat.py`` with the same parameter names
and shapes: ``conv_weights`` (R, H, in, D), ``attn_l``/``attn_r``
(R, H, D), ``h_bias`` (out,; none with ``bias=False``), ``loop_weight``
(in, out; with ``self_loop``, adding ``x_dst @ loop_weight`` before the
bias), and every branch het_tpu has.  The four
dual-list ones:

* plain (per edge): ``edge_typed_linear`` projects each edge's source and
  destination rows, ``edge_rel_inner`` takes the attention logits, and
  the fused per-edge softmax aggregation sums into destinations;
* plain multiply-first: the logits ride the projection as extra output
  columns (``x · (W·a)``), so no inner product;
* compact: one projected row per unique (relation, node) pair on each
  side, logits by ``segment_rel_inner`` on those rows;
* compact multiply-first (the reference's
  ``--compact_as_of_node_flag --multiply_among_weights_first_flag`` run):
  both the features and the logits on compact rows from one matmul, whose
  packed per-head ``[el | feat]`` output goes into the fused op as one
  buffer (the packed form).  het_tpu takes that form only from 1M source
  compact rows on (each narrow array costs a TPU a 128-lane row) and two
  split views below; on the card the packed form copies less at every
  size, so the port takes it always.

On a union-list graph (``g.compact_shared``) the two sides share one
compact row space, so one projection serves both: with multiply-first the
matmul's columns are ``[W.a_l | W | W.a_r]`` and ``er`` is its last lane;
without it, ``el`` and ``er`` are two inner products over the same rows.

``stable_softmax`` is False/"raw" (the reference's raw ``exp``), "clip"
or "max" (the exact max-subtracted softmax) in every branch.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from .. import ops
from ..utils import spans

LEAKY_RELU_SLOPE = 0.2


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator):
    """Glorot uniform with flax's fan convention for >2-D shapes (fan_in
    and fan_out from the last two axes times the leading ones)."""
    rf = math.prod(t.shape[:-2])
    fan_in, fan_out = t.shape[-2] * rf, t.shape[-1] * rf
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    with torch.no_grad():
        t.uniform_(-limit, limit, generator=generator)
    return t


def dropout(h: torch.Tensor, p: float, generator: torch.Generator):
    """Inverted dropout whose mask comes from ``generator``."""
    keep = torch.rand(h.shape, generator=generator, device=h.device) >= p
    return torch.where(keep, h / (1.0 - p), torch.zeros_like(h))


class RGATLayer(nn.Module):
    def __init__(
        self,
        in_feat: int,
        out_feat: int,
        num_rels: int,
        num_heads: int,
        *,
        bias: bool = True,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        self_loop: bool = False,
        compact: bool = False,
        multiply_first: bool = False,
        dropout: float = 0.5,
        stable_softmax=False,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if out_feat % num_heads:
            raise ValueError("out_feat must be a multiple of num_heads")
        self.out_feat = out_feat
        self.activation = activation
        self.compact = compact
        self.multiply_first = multiply_first
        self.dropout = dropout
        self.stable_softmax = stable_softmax
        self.impl = impl
        H, D = num_heads, out_feat // num_heads
        self.conv_weights = nn.Parameter(torch.empty(num_rels, H, in_feat, D))
        self.attn_l = nn.Parameter(torch.empty(num_rels, H, D))
        self.attn_r = nn.Parameter(torch.empty(num_rels, H, D))
        for p in (self.conv_weights, self.attn_l, self.attn_r):
            xavier_uniform_(p, generator)
        self.loop_weight = None
        if self_loop:
            self.loop_weight = nn.Parameter(torch.empty(in_feat, out_feat))
            xavier_uniform_(self.loop_weight, generator)
        self.h_bias = nn.Parameter(torch.zeros(out_feat)) if bias else None

    def forward(self, g, x: torch.Tensor, *,
                x_dst: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` indexes the graph's source space, ``x_dst`` its
        destinations (``x`` when None).  They differ on a shard of a
        partitioned graph, where ``x`` is the halo buffer and ``x_dst``
        the shard's own rows."""
        if x_dst is None:
            x_dst = x
        if self.compact:
            h = self._compact(g, x, x_dst)
        else:
            h = self._plain(g, x, x_dst)
        h = h.reshape(g.num_nodes, self.out_feat)
        if self.loop_weight is not None:
            h = h + x_dst @ self.loop_weight
        if self.h_bias is not None:
            h = h + self.h_bias
        if self.activation is not None:
            h = self.activation(h)
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            h = dropout(h, self.dropout, generator)
        return h

    def _weights_times_attn(self):
        """``W·a_l`` and ``W·a_r`` (R, H, K): the multiply-first logit
        columns."""
        return (torch.einsum("rhkd,rhd->rhk", self.conv_weights, self.attn_l),
                torch.einsum("rhkd,rhd->rhk", self.conv_weights, self.attn_r))

    def _compact(self, g, x, x_dst):
        if g.compact_shared:
            return self._compact_union(g, x)
        impl, slope, stable = self.impl, LEAKY_RELU_SLOPE, self.stable_softmax
        conv_w = self.conv_weights
        if not self.multiply_first:
            feat_c = ops.compact_typed_linear(g, x, conv_w, "src", impl=impl)
            el_c = ops.segment_rel_inner(feat_c, self.attn_l,
                                         g.compact_src.seg, impl=impl)
            feat_c_dst = ops.compact_typed_linear(g, x_dst, conv_w, "dst",
                                                  impl=impl)
            er_c = ops.segment_rel_inner(feat_c_dst, self.attn_r,
                                         g.compact_dst.seg, impl=impl)
            return ops.relational_fused_gat_compact(
                g, feat_c, el_c, er_c, slope, stable=stable, impl=impl)
        wa_l, wa_r = self._weights_times_attn()
        w_cat = torch.cat([wa_l[..., None], conv_w], dim=-1)  # (R,H,K,1+D)
        fe = ops.compact_typed_linear(g, x, w_cat, "src", impl=impl)
        er_c = ops.compact_typed_linear(g, x_dst, wa_r[..., None], "dst",
                                        impl=impl)[..., 0]
        return ops.relational_fused_gat_compact_packed(
            g, fe, er_c, slope, stable=stable, impl=impl)

    def _compact_union(self, g, x):
        """Both attention sides from one projection of the shared union
        rows (``g.compact_src`` and ``g.compact_dst`` index the same
        rows, so ``x`` serves both; a union graph has one node space)."""
        impl, slope, stable = self.impl, LEAKY_RELU_SLOPE, self.stable_softmax
        conv_w = self.conv_weights
        seg = g.compact_src.seg
        if self.multiply_first:
            wa_l, wa_r = self._weights_times_attn()
            w_cat = torch.cat([wa_l[..., None], conv_w, wa_r[..., None]],
                              dim=-1)  # (R, H, K, 1+D+1)
            fe = ops.compact_typed_linear(g, x, w_cat, "src", impl=impl)
            return ops.relational_fused_gat_compact(
                g, fe[..., 1:-1], fe[..., 0], fe[..., -1], slope,
                stable=stable, impl=impl)
        feat_c = ops.compact_typed_linear(g, x, conv_w, "src", impl=impl)
        el_c = ops.segment_rel_inner(feat_c, self.attn_l, seg, impl=impl)
        er_c = ops.segment_rel_inner(feat_c, self.attn_r, seg, impl=impl)
        return ops.relational_fused_gat_compact(
            g, feat_c, el_c, er_c, slope, stable=stable, impl=impl)

    def _plain(self, g, x, x_dst):
        impl, slope, stable = self.impl, LEAKY_RELU_SLOPE, self.stable_softmax
        conv_w = self.conv_weights
        if self.multiply_first:
            D = conv_w.shape[-1]
            wa_l, wa_r = self._weights_times_attn()
            w_cat = torch.cat([conv_w, wa_l[..., None]], dim=-1)  # (R,H,K,D+1)
            fe = ops.edge_typed_linear(g, x, w_cat, "src", impl=impl)
            feat_e, el = fe[..., :D], fe[..., D]
            er = ops.edge_typed_linear(g, x_dst, wa_r[..., None], "dst",
                                       impl=impl)[..., 0]
        else:
            feat_e = ops.edge_typed_linear(g, x, conv_w, "src", impl=impl)
            el = ops.edge_rel_inner(g, feat_e, self.attn_l, impl=impl)
            feat_dst_e = ops.edge_typed_linear(g, x_dst, conv_w, "dst",
                                               impl=impl)
            er = ops.edge_rel_inner(g, feat_dst_e, self.attn_r, impl=impl)
        return ops.relational_fused_gat(g, feat_e, el, er, slope,
                                        stable=stable, impl=impl)


class RGATModel(nn.Module):
    """Multi-layer RGAT: ``num_layers`` layers from ``in_feat`` through
    ``hidden`` to ``num_classes``, ReLU between layers."""

    def __init__(
        self,
        in_feat: int,
        hidden: int,
        num_classes: int,
        num_rels: int,
        num_heads: int,
        num_layers: int = 2,
        *,
        compact: bool = False,
        multiply_first: bool = False,
        dropout: float = 0.5,
        stable_softmax=False,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        dims = [in_feat] + [hidden] * (num_layers - 1) + [num_classes]
        self.layers = nn.ModuleList(
            RGATLayer(
                dims[i], dims[i + 1], num_rels, num_heads,
                activation=torch.relu if i < num_layers - 1 else None,
                compact=compact, multiply_first=multiply_first,
                dropout=dropout, stable_softmax=stable_softmax,
                impl=impl, generator=generator,
            )
            for i in range(num_layers)
        )

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            with spans.span("layer", i):
                h = layer(g, h, generator=generator)
        return h
