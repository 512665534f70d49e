"""Relational fused GAT aggregation, per edge and over compact rows.

Counterparts of ``het_tpu/ops/spmm.py::relational_fused_gat``,
``::relational_fused_gat_compact`` and
``::relational_fused_gat_compact_packed``.  The edge softmax is a raw
``exp`` with no max subtraction by default, as in the reference
(``stable=False`` or ``"raw"``); ``stable="clip"`` clamps logits to
+-``CLIP_LOGIT`` after the activation, which bounds the exponent without
an extra pass; ``stable="max"`` (or ``True``) is the exact
max-subtracted softmax, whose destination max is one ``seg_max_sorted``
launch in the forward.
"""

from __future__ import annotations

import torch

from .fused_agg import (CLIP_LOGIT, STABLE_MODES,  # noqa: F401
                        CompactFusedGAT, CompactFusedGATPacked, FusedGAT)


def _mode(stable) -> str:
    """The softmax mode of a ``stable`` argument, as het_tpu reads it."""
    mode = {False: "raw", True: "max"}.get(stable, stable)
    if mode not in STABLE_MODES:
        raise ValueError(f"stable must be False, True or one of "
                         f"{STABLE_MODES}, got {stable!r}")
    return mode


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
    EP, H, D = feat_src_e.shape
    return FusedGAT.apply(feat_src_e.reshape(EP, H * D), el_e + er_e, g,
                          float(slope), _mode(stable), impl)


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
    UC, H, D = feat_c.shape
    return CompactFusedGAT.apply(feat_c.reshape(UC, H * D), el_c, er_c, g,
                                 float(slope), _mode(stable), impl)


def relational_fused_gat_compact_packed(
    g,
    fe: torch.Tensor,
    er_c: torch.Tensor,
    slope: float,
    *,
    stable=False,
    impl: str = "kernel",
) -> torch.Tensor:
    """The compact op over the packed multiply-first projection: fe
    (UCs, H, 1+D) with per-head lanes ``[el | feat]``, er_c (UCd, H) ->
    (N, H, D).  One buffer in, its gradient out in the same layout."""
    UC, H, D1 = fe.shape
    return CompactFusedGATPacked.apply(fe.reshape(UC, H * D1), er_c, g,
                                       float(slope), _mode(stable), impl)
