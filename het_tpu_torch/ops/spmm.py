"""Relational fused GAT aggregation over compact rows.

Counterpart of ``het_tpu/ops/spmm.py::relational_fused_gat_compact``.  The
edge softmax is a raw ``exp`` with no max subtraction, as in the
reference; ``stable="clip"`` clamps logits to +-``CLIP_LOGIT`` after the
activation, which bounds the exponent without an extra pass.
"""

from __future__ import annotations

import torch

from .fused_agg import CompactFusedGAT

CLIP_LOGIT = 60.0  # exp(60) ~ 1e26: far from f32 overflow, keeps order


def relational_fused_gat_compact(
    g,
    feat_c: torch.Tensor,
    el_c: torch.Tensor,
    er_c: torch.Tensor,
    slope: float,
    *,
    stable=False,
    seg_sum_impl: str = "kernel",
) -> torch.Tensor:
    """feat_c (UCs, H, D) and el_c (UCs, H) on source compact rows, er_c
    (UCd, H) on destination compact rows -> (N, H, D)."""
    if stable not in (False, "raw", "clip"):
        raise NotImplementedError(
            f"stable={stable!r} needs the exact max-subtracted softmax and "
            "its segment max (ROADMAP.md, 'The rest of RGAT: stable=max')"
        )
    UC, H, D = feat_c.shape
    clip = CLIP_LOGIT if stable == "clip" else None
    return CompactFusedGAT.apply(feat_c.reshape(UC, H * D), el_c, er_c, g,
                                 float(slope), clip, seg_sum_impl)
