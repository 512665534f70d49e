"""Relational graph convolution (RGCN).

Counterpart of ``het_tpu/models/rgcn.py`` with the same parameter names
and shapes:

* :class:`SeastarRGCNLayer0`, the featureless first layer: ``weight``
  (R, N, out) read by a weight-row gather, ``out[dst] = sum_e norm_e *
  W[rel_e, src_e]`` (the input features are one-hot node ids);
* :class:`RGCNLayer`: ``weight`` (R, in, out), per edge (``x[src] @
  W[rel]`` over the relation-sorted edge rows) or compact (one projected
  row per unique (relation, source) pair, aggregated single-sided without
  a per-edge tensor), then ``+ x_dst @ loop_weight`` (``self_loop``) and
  ``+ bias``;
* :class:`RGCNModel`: two layers, ReLU between them.

Every aggregation is normalized by ``ops.rgcn_norm`` (1 / in-degree).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch import nn

from .. import ops
from ..utils import spans
from .rgat import dropout, xavier_uniform_


class SeastarRGCNLayer0(nn.Module):
    """Featureless input layer.  Keeps the (relation, source) run index of
    its weight gradient (``ops.rel_src_runs``) for the last graph it saw,
    so that it is built once a graph and not once a step."""

    def __init__(
        self,
        num_nodes: int,
        num_rels: int,
        out_feat: int,
        *,
        bias: bool = True,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(num_rels, num_nodes, out_feat))
        xavier_uniform_(self.weight, generator)
        self.bias = (nn.Parameter(torch.zeros(out_feat)) if bias else None)
        self._runs = None  # (graph, ops.rel_src_runs(graph))

    def forward(self, g, norm_e: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        if norm_e is None:
            norm_e = ops.rgcn_norm(g)
        if self._runs is None or self._runs[0] is not g:
            self._runs = (g, ops.rel_src_runs(g))
        h = ops.rgcn_layer0(g, self.weight, norm_e, impl=self.impl,
                            runs=self._runs[1])
        if self.bias is not None:
            h = h + self.bias
        if self.activation is not None:
            h = self.activation(h)
        return h


class RGCNLayer(nn.Module):
    def __init__(
        self,
        in_feat: int,
        out_feat: int,
        num_rels: int,
        *,
        bias: bool = True,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        self_loop: bool = False,
        compact: bool = False,
        dropout: float = 0.0,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.activation = activation
        self.compact = compact
        self.dropout = dropout
        self.impl = impl
        self.weight = nn.Parameter(torch.empty(num_rels, in_feat, out_feat))
        xavier_uniform_(self.weight, generator)
        self.loop_weight = None
        if self_loop:
            self.loop_weight = nn.Parameter(torch.empty(in_feat, out_feat))
            xavier_uniform_(self.loop_weight, generator)
        self.bias = (nn.Parameter(torch.zeros(out_feat)) if bias else None)

    def forward(self, g, x: torch.Tensor,
                norm_e: Optional[torch.Tensor] = None, *,
                x_dst: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``x`` indexes the graph's source space, ``x_dst`` its
        destinations (``x`` when None), as in ``RGATLayer``."""
        if x_dst is None:
            x_dst = x
        if norm_e is None:
            norm_e = ops.rgcn_norm(g)
        impl = self.impl
        if self.compact:
            feat_c = ops.compact_typed_linear(g, x, self.weight[:, None],
                                              "src", impl=impl)
            h = ops.rgcn_aggregate_compact(g, feat_c[:, 0, :], norm_e,
                                           impl=impl)
        else:
            h = ops.rgcn_layer1(g, x, self.weight, norm_e, impl=impl)
        if self.loop_weight is not None:
            h = h + x_dst @ self.loop_weight
        if self.bias is not None:
            h = h + self.bias
        if self.activation is not None:
            h = self.activation(h)
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            h = dropout(h, self.dropout, generator)
        return h


class RGCNModel(nn.Module):
    """Two-layer entity classification: the featureless layer (or an
    ``RGCNLayer`` from ``in_feat`` features) to ``hidden`` with ReLU and
    ``dropout``, then an ``RGCNLayer`` to ``num_classes``.  Parameters
    are ``layers.{0,1}.*``."""

    def __init__(
        self,
        num_nodes: int,
        hidden: int,
        num_classes: int,
        num_rels: int,
        *,
        featureless: bool = True,
        in_feat: Optional[int] = None,
        compact: bool = False,
        dropout: float = 0.0,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if featureless:
            first = SeastarRGCNLayer0(num_nodes, num_rels, hidden,
                                      activation=torch.relu, impl=impl,
                                      generator=generator)
        else:
            first = RGCNLayer(in_feat, hidden, num_rels,
                              activation=torch.relu, compact=compact,
                              dropout=dropout, impl=impl,
                              generator=generator)
        self.featureless = featureless
        self.layers = nn.ModuleList([
            first,
            RGCNLayer(hidden, num_classes, num_rels, compact=compact,
                      impl=impl, generator=generator),
        ])

    def forward(self, g, x: Optional[torch.Tensor] = None, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        norm_e = ops.rgcn_norm(g)
        with spans.span("layer", 0):
            if self.featureless:
                h = self.layers[0](g, norm_e)
            else:
                h = self.layers[0](g, x, norm_e, generator=generator)
        with spans.span("layer", 1):
            return self.layers[1](g, h, norm_e, generator=generator)
