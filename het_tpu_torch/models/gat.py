"""Homogeneous GAT.

Counterpart of ``het_tpu/models/gat.py`` with the same parameter names and
shapes: ``fc`` (in, H*D), ``attn_l`` and ``attn_r`` (H, D), and with
``residual`` where in != H*D, ``res_fc`` (in, H*D).  A layer drops its
input features (``feat_drop``, from the caller's generator), runs the
whole core (projection, logits, softmax, aggregation) through
``ops.gat_layer_core``, adds the residual and applies its activation; its
output stays head-major (N, H*D).  het_tpu declares an ``attn_drop`` that
it never reads; the port leaves it out.

:class:`GATModel` stacks ``num_layers - 1`` layers of ``num_heads`` heads
of ``hidden`` with ELU, then one head of ``num_classes``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from .. import ops
from ..utils import spans
from .rgat import LEAKY_RELU_SLOPE, dropout, xavier_uniform_


class GATLayer(nn.Module):
    def __init__(
        self,
        in_feat: int,
        out_feat: int,
        num_heads: int,
        *,
        feat_drop: float = 0.0,
        leaky_relu_slope: float = LEAKY_RELU_SLOPE,
        residual: bool = False,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.feat_drop = feat_drop
        self.slope = leaky_relu_slope
        self.activation = activation
        self.impl = impl
        H, D = num_heads, out_feat
        self.fc = nn.Parameter(torch.empty(in_feat, H * D))
        self.attn_l = nn.Parameter(torch.empty(H, D))
        self.attn_r = nn.Parameter(torch.empty(H, D))
        for p in (self.fc, self.attn_l, self.attn_r):
            xavier_uniform_(p, generator)
        self.residual = residual
        self.res_fc = None
        if residual and in_feat != H * D:
            self.res_fc = nn.Parameter(torch.empty(in_feat, H * D))
            xavier_uniform_(self.res_fc, generator)

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x (N, in) -> (N, H*D)."""
        if self.training and self.feat_drop > 0:
            if generator is None:
                raise ValueError("training with feat_drop needs a generator")
            x = dropout(x, self.feat_drop, generator)
        h = ops.gat_layer_core(g, x, self.fc, self.attn_l, self.attn_r,
                               self.slope, impl=self.impl)
        if self.residual:
            h = h + (x if self.res_fc is None else x @ self.res_fc)
        if self.activation is not None:
            h = self.activation(h)
        return h


class GATModel(nn.Module):
    """``num_layers - 1`` layers of ``num_heads`` x ``hidden`` with ELU,
    then one head of ``num_classes``; logits (N, num_classes).
    ``feat_drop`` drops the inputs of every layer but the last, as
    het_tpu's."""

    def __init__(
        self,
        in_feat: int,
        hidden: int,
        num_classes: int,
        num_heads: int,
        num_layers: int = 2,
        *,
        feat_drop: float = 0.0,
        impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        width = hidden * num_heads
        self.layers = nn.ModuleList(
            GATLayer(in_feat if i == 0 else width, hidden, num_heads,
                     feat_drop=feat_drop, activation=F.elu, impl=impl,
                     generator=generator)
            for i in range(num_layers - 1)
        )
        self.layers.append(GATLayer(width if num_layers > 1 else in_feat,
                                    num_classes, 1, impl=impl,
                                    generator=generator))

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for i, layer in enumerate(self.layers):
            with spans.span("layer", i):
                h = layer(g, h, generator=generator)
        return h
