"""Relational fused GAT aggregation, per edge and over compact rows.

Counterparts of ``het_tpu/ops/spmm.py::relational_fused_gat`` and
``::relational_fused_gat_compact``.  The edge softmax is a raw ``exp``
with no max subtraction, as in the reference; ``stable="clip"`` clamps
logits to +-``CLIP_LOGIT`` after the activation, which bounds the
exponent without an extra pass.  ``stable="max"`` (the exact
max-subtracted softmax) is not ported yet.
"""

from __future__ import annotations

import torch

from .fused_agg import CompactFusedGAT, FusedGAT

CLIP_LOGIT = 60.0  # exp(60) ~ 1e26: far from f32 overflow, keeps order


def _clip(stable):
    if stable not in (False, "raw", "clip"):
        raise NotImplementedError(
            f"stable={stable!r} needs the exact max-subtracted softmax and "
            "its segment max (ROADMAP.md, 'The rest of RGAT: stable=max')"
        )
    return CLIP_LOGIT if stable == "clip" else None


def relational_fused_gat(
    g,
    feat_src_e: torch.Tensor,
    el_e: torch.Tensor,
    er_e: torch.Tensor,
    slope: float,
    *,
    stable=False,
    impl: str = "kernel",
) -> torch.Tensor:
    """Edge softmax of ``leaky_relu(el + er)`` over each destination's
    incoming edges, weighting ``feat_src_e``: feat_src_e (EP, H, D) and
    el_e/er_e (EP, H) in canonical edge order -> (N, H, D)."""
    clip = _clip(stable)
    EP, H, D = feat_src_e.shape
    return FusedGAT.apply(feat_src_e.reshape(EP, H * D), el_e + er_e, g,
                          float(slope), clip, impl)


def relational_fused_gat_compact(
    g,
    feat_c: torch.Tensor,
    el_c: torch.Tensor,
    er_c: torch.Tensor,
    slope: float,
    *,
    stable=False,
    impl: str = "kernel",
) -> torch.Tensor:
    """feat_c (UCs, H, D) and el_c (UCs, H) on source compact rows, er_c
    (UCd, H) on destination compact rows -> (N, H, D)."""
    clip = _clip(stable)
    UC, H, D = feat_c.shape
    return CompactFusedGAT.apply(feat_c.reshape(UC, H * D), el_c, er_c, g,
                                 float(slope), clip, impl)
