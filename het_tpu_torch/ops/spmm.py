"""Relational fused GAT aggregation, per edge and over compact rows, and
the RGCN ops.

Counterparts of ``het_tpu/ops/spmm.py::relational_fused_gat``,
``::relational_fused_gat_compact`` and
``::relational_fused_gat_compact_packed``, and of ``rgcn_norm``,
``rgcn_aggregate``, ``rgcn_aggregate_compact``, ``rgcn_layer1`` and
``rgcn_layer0``: every RGCN aggregation is one sorted segment sum into
the destinations, and every gradient into node, compact or weight rows
one more, over a row pointer with a permutation (no atomics).

The edge softmax is a raw ``exp`` with no max subtraction by default, as
in the reference (``stable=False`` or ``"raw"``); ``stable="clip"``
clamps logits to +-``CLIP_LOGIT`` after the activation, which bounds the
exponent without an extra pass; ``stable="max"`` (or ``True``) is the
exact max-subtracted softmax, whose destination max is one
``seg_max_sorted`` launch in the forward.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import gather_dst, scatter_sum_dst, sorted_gather
from .fused_agg import (CLIP_LOGIT, STABLE_MODES,  # noqa: F401
                        CompactFusedGAT, CompactFusedGATPacked, FusedGAT,
                        compact_weighted_agg)
from .linear import edge_typed_linear


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


# ------------------------------------------------------------------ RGCN


def rgcn_norm(g, kind: str = "in_degree") -> torch.Tensor:
    """Per-edge normalization (EP,) in canonical order: ``1/max(in_deg,
    1)`` at each edge's destination (DGL's "right" norm), zero on padding
    edges.  On a shard ``in_deg`` is the shard's, the global in-degree
    because a shard owns whole destinations."""
    if kind != "in_degree":
        raise ValueError(kind)
    inv = 1.0 / g.in_deg.clamp(min=1).float()
    return gather_dst(g, inv)


def rgcn_aggregate(g, feat_e: torch.Tensor, norm_e: torch.Tensor, *,
                   impl: str = "kernel") -> torch.Tensor:
    """``out[dst] = sum_e feat_e * norm_e``: feat_e (EP, ...) in canonical
    order -> (N, ...)."""
    extra = (1,) * (feat_e.dim() - norm_e.dim())
    return scatter_sum_dst(g, feat_e * norm_e.view(norm_e.shape + extra),
                           impl=impl)


def rgcn_aggregate_compact(g, feat_c: torch.Tensor, norm_e: torch.Tensor,
                           *, impl: str = "kernel") -> torch.Tensor:
    """``out[dst] = sum_e norm_e * feat_c[compact_src_row(e)]``: feat_c
    (UCs, C) on source compact rows, aggregated without a standalone
    per-edge tensor (:class:`~.fused_agg.CompactWeightedAgg`)."""
    return compact_weighted_agg(g, feat_c, norm_e, impl=impl)


def rgcn_layer1(g, x: torch.Tensor, w: torch.Tensor, norm_e: torch.Tensor,
                *, impl: str = "kernel") -> torch.Tensor:
    """``out[dst] = sum_e norm_e * (x[src_e] @ W[rel_e])``: x (N, in),
    w (R, in, out): the edge-parallel typed linear, then the normalized
    aggregation."""
    feat_e = edge_typed_linear(g, x, w[:, None], "src", impl=impl)
    return rgcn_aggregate(g, feat_e[:, 0, :], norm_e, impl=impl)


def _weight_rows(g) -> torch.Tensor:
    """Each canonical edge's row ``rel * N + src`` of the featureless
    weight viewed (R*N, out); the sentinel R*N on padding edges."""
    N = g.num_nodes
    key = g.rel.long() * N + g.src.long().clamp(max=N - 1)
    return torch.where(g.dst < N, key, torch.full_like(key, g.num_rels * N))


def rel_src_runs(g) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (relation, source) runs of the real edges, for the gradient of
    the featureless layer's weight-row gather: ``(ptr, perm)`` with
    ``perm`` the canonical edges stably sorted by ``rel * N + src``
    (padding edges past ``ptr[-1]``) and ``ptr`` (R*N + 1,) the start of
    each key's run.  One stable sort and one search on the graph's
    device: a caller builds it once a graph (``SeastarRGCNLayer0`` keeps
    it) rather than once a step."""
    keys, perm = torch.sort(_weight_rows(g), stable=True)
    bounds = torch.arange(g.num_rels * g.num_nodes + 1, device=keys.device)
    ptr = torch.searchsorted(keys, bounds)
    return ptr.to(torch.int32), perm.to(torch.int32)


def rgcn_layer0(g, w: torch.Tensor, norm_e: torch.Tensor, *,
                impl: str = "kernel",
                runs: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                ) -> torch.Tensor:
    """Featureless first layer: ``out[dst] = sum_e norm_e *
    W[rel_e, src_e]``, w (R, N, out), the inputs one-hot node ids.
    ``runs`` is ``rel_src_runs(g)``, built here when None.  Padding edges
    read a zero row and sort past every run, so they add exactly zero
    whatever their ``rel`` holds."""
    R, N, O = w.shape
    if runs is None:
        runs = rel_src_runs(g)
    # dW[r*N + n] sums the edges of run (r, n): one sorted segment sum,
    # not index_put_'s atomic scatter
    feat_e = sorted_gather(w.reshape(R * N, O), _weight_rows(g), *runs,
                           impl=impl)
    return rgcn_aggregate(g, feat_e, norm_e, impl=impl)
