"""Relational GAT (RGAT).

Counterpart of ``het_tpu/models/rgat.py`` with the same parameter names
and shapes: ``conv_weights`` (R, H, in, D), ``attn_l``/``attn_r``
(R, H, D), ``h_bias`` (out,).  The branch ported so far is the dual-list
compact + multiply-first split form, the one the reference's
``--compact_as_of_node_flag --multiply_among_weights_first_flag`` run
takes: the attention logits ride the feature projection as extra output
columns (``x · (W·a)``), both sides stay on compact rows, and the fused
compact softmax aggregation sums them into destinations.  Every other
branch raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from .. import ops

# compact-row count from which the JAX package switches to the packed
# operand form of the fused op (not ported yet)
PACKED_COMPACT_ROWS = 1_000_000
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
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        compact: bool = False,
        multiply_first: bool = False,
        dropout: float = 0.5,
        stable_softmax=False,
        seg_sum_impl: str = "kernel",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if out_feat % num_heads:
            raise ValueError("out_feat must be a multiple of num_heads")
        if not compact:
            raise NotImplementedError(
                "plain (per-edge) RGAT is not ported yet (ROADMAP.md, "
                "'The rest of RGAT: the plain path')"
            )
        if not multiply_first:
            raise NotImplementedError(
                "compact RGAT without multiply_first is not ported yet "
                "(ROADMAP.md, 'The rest of RGAT: compact, not "
                "multiply-first')"
            )
        self.out_feat = out_feat
        self.activation = activation
        self.dropout = dropout
        self.stable_softmax = stable_softmax
        self.seg_sum_impl = seg_sum_impl
        H, D = num_heads, out_feat // num_heads
        self.conv_weights = nn.Parameter(torch.empty(num_rels, H, in_feat, D))
        self.attn_l = nn.Parameter(torch.empty(num_rels, H, D))
        self.attn_r = nn.Parameter(torch.empty(num_rels, H, D))
        for p in (self.conv_weights, self.attn_l, self.attn_r):
            xavier_uniform_(p, generator)
        self.h_bias = nn.Parameter(torch.zeros(out_feat))

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if g.compact_shared:
            raise NotImplementedError(
                "union-list compact RGAT is not ported yet (ROADMAP.md, "
                "'The rest of RGAT: the union-compact branch')"
            )
        if g.compact_src.seg.n_rows >= PACKED_COMPACT_ROWS:
            raise NotImplementedError(
                f"{g.compact_src.seg.n_rows} source compact rows take the "
                "packed-operand fused op, which is not ported yet "
                "(ROADMAP.md, 'The rest of RGAT: the packed branch')"
            )
        impl = self.seg_sum_impl
        conv_w = self.conv_weights
        wa_l = torch.einsum("rhkd,rhd->rhk", conv_w, self.attn_l)
        wa_r = torch.einsum("rhkd,rhd->rhk", conv_w, self.attn_r)
        w_cat = torch.cat([wa_l[..., None], conv_w], dim=-1)  # (R,H,K,1+D)
        fe = ops.compact_typed_linear(g, x, w_cat, "src", seg_sum_impl=impl)
        er_c = ops.compact_typed_linear(g, x, wa_r[..., None], "dst",
                                        seg_sum_impl=impl)[..., 0]
        h = ops.relational_fused_gat_compact(
            g, fe[..., 1:], fe[..., 0], er_c, LEAKY_RELU_SLOPE,
            stable=self.stable_softmax, seg_sum_impl=impl,
        )
        h = h.reshape(g.num_nodes, self.out_feat) + self.h_bias
        if self.activation is not None:
            h = self.activation(h)
        if self.training and self.dropout > 0:
            if generator is None:
                raise ValueError("training with dropout needs a generator")
            h = dropout(h, self.dropout, generator)
        return h


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
        seg_sum_impl: str = "kernel",
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
                seg_sum_impl=seg_sum_impl, generator=generator,
            )
            for i in range(num_layers)
        )

    def forward(self, g, x: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = x
        for layer in self.layers:
            h = layer(g, h, generator=generator)
        return h
