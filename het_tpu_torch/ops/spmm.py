"""Relational fused GAT aggregation, per edge and over compact rows, the
RGCN ops, the HGT ops and the homogeneous GAT ops.

Counterparts of ``het_tpu/ops/spmm.py::relational_fused_gat``,
``::relational_fused_gat_compact`` and
``::relational_fused_gat_compact_packed``, and of ``rgcn_norm``,
``rgcn_aggregate``, ``rgcn_aggregate_compact``, ``rgcn_layer1`` and
``rgcn_layer0``: every RGCN aggregation is one sorted segment sum into
the destinations, and every gradient into node, compact or weight rows
one more, over a row pointer with a permutation (no atomics).  The HGT
ops (``inner_product_edge_node``, ``edge_softmax``, ``hgt_edge_softmax``,
``hgt_softmax_weighted_agg`` and its compact form, and the dispatchers
``hgt_compact_attention``, ``hgt_plain_attention`` and
``hgt_plain_layer_core``) pick, as het_tpu's pallas backend does, the
fused ops of ``fused_agg`` under "raw" and "clip" and the unfused chain
under "max"; ``score * mu[rel]`` is ``edge_rel_inner`` at D = 1, whose
``mu`` gradient is the grouped dW over the relation-sorted edge rows.
The homogeneous GAT ops (``gat_node_fused``, ``gat_node_fused2d`` and
``gat_layer_core``) likewise take the node-sided fused ops under "raw"
and "clip" and the per-edge op on gathered inputs under "max".  The
compiler's generic softmax aggregations, ``edge_softmax_weighted_sum``
and ``edge_softmax_weighted_sum_compact`` (source-compact messages), do
the same with the identity activation.

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

from .common import (_edge_valid, gather_dst, gather_nodes, gather_src,
                     safe_div, scatter_sum_dst, scatter_sum_src,
                     sorted_gather)
from .fused_agg import (CLIP_LOGIT, STABLE_MODES,  # noqa: F401
                        CompactFusedGAT, CompactFusedGATPacked,
                        GATLayerFused, HGTCompactAttention, HGTPlainFull,
                        NodeFusedGAT, _clip, compact_weighted_agg,
                        fused_softmax_agg, fused_softmax_agg_src_compact)
from .kernels import seg_max_sorted
from .linear import (compact_dst_inner, edge_rel_inner, edge_typed_linear,
                     expand_compact)


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
    return fused_softmax_agg(g, feat_src_e, el_e + er_e, slope=slope,
                             stable=_mode(stable), impl=impl)


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


# ------------------------------------------------------------------- HGT


class _InnerProduct(torch.autograd.Function):
    """``score[e, h] = <left_e[e, h], right[side(e), h]>``.  Backward:
    ``d_left = ct * right[side(e)]``; ``d_right`` the sorted segment sum
    of ``ct * left_e`` into the side's nodes."""

    @staticmethod
    def forward(ctx, left_e, right, g, side: str, impl: str):
        ctx.save_for_backward(left_e, right)
        ctx.g, ctx.side, ctx.impl = g, side, impl
        r_e = gather_nodes(right, g.dst if side == "dst" else g.src)
        return (left_e.float() * r_e.float()).sum(-1).to(left_e.dtype)

    @staticmethod
    def backward(ctx, ct):
        left_e, right = ctx.saved_tensors
        g = ctx.g
        r_e = gather_nodes(right, g.dst if ctx.side == "dst" else g.src)
        ct = ct.float()[..., None]
        total = scatter_sum_dst if ctx.side == "dst" else scatter_sum_src
        d_right = total(g, ct * left_e.float(), impl=ctx.impl)
        return ((ct * r_e.float()).to(left_e.dtype),
                d_right.view(right.shape).to(right.dtype), None, None, None)


def inner_product_edge_node(g, left_e: torch.Tensor, right: torch.Tensor,
                            side: str = "dst", *,
                            impl: str = "kernel") -> torch.Tensor:
    """``score_e[h] = <left_e[e, h], right[side(e), h]>``: left_e (EP, H,
    D) per edge, right (nodes of the side, H, D) -> (EP, H)."""
    return _InnerProduct.apply(left_e, right, g, side, impl)


def _stabilize(g, logits: torch.Tensor, mode: str,
               impl: str) -> torch.Tensor:
    """Overflow protection of the raw-exp softmax: none ("raw"), logits
    clamped to +-``CLIP_LOGIT`` ("clip"), or the destination max
    subtracted ("max": ``seg_max_sorted`` over ``in_row_ptr``, which never
    reads a padding edge; no gradient through the max, as het_tpu stops
    it)."""
    if mode == "raw":
        return logits
    if mode == "clip":
        return logits.clamp(-CLIP_LOGIT, CLIP_LOGIT)
    EP = logits.shape[0]
    m = seg_max_sorted(logits.detach().float().reshape(EP, -1).contiguous(),
                       g.in_row_ptr, impl=impl)
    return logits - gather_nodes(m, g.dst).view(logits.shape)


def _masked_exp(g, logits: torch.Tensor) -> torch.Tensor:
    """``exp(logits)``, 0 on padding edges.  Their logits are dropped
    before the ``exp``: het_tpu masks after it, where an overflowing
    padding logit turns the backward's 0 * inf into NaN."""
    valid = _edge_valid(g).view((-1,) + (1,) * (logits.dim() - 1))
    zero = torch.zeros_like(logits)
    return torch.where(valid, torch.exp(torch.where(valid, logits, zero)),
                       zero)


def edge_softmax(g, logits: torch.Tensor, *, stable=False,
                 impl: str = "kernel") -> torch.Tensor:
    """Per-destination softmax over incoming edges, (EP, H) -> (EP, H),
    exactly 0 on padding edges."""
    e = _masked_exp(g, _stabilize(g, logits, _mode(stable), impl))
    s = scatter_sum_dst(g, e, impl=impl)
    return safe_div(e, gather_dst(g, s, impl=impl))


def _typed_logits(g, score_e: torch.Tensor, mu: torch.Tensor,
                  impl: str) -> torch.Tensor:
    """``score_e * mu[rel_e]`` (EP, H): the inner product of
    :func:`edge_rel_inner` at D = 1, whose ``mu`` gradient is the grouped
    dW over the relation-sorted edge rows, not ``index_select``'s atomic
    scatter of millions of rows into R * H addresses."""
    return edge_rel_inner(g, score_e[..., None], mu[..., None], impl=impl)


def hgt_edge_softmax(g, score_e: torch.Tensor, mu: torch.Tensor, *,
                     stable=False, impl: str = "kernel") -> torch.Tensor:
    """HGT's typed edge softmax ``softmax_dst(score_e * mu[rel_e])``: mu
    (R, H) = relation_pri / sqrt(d_k), score_e (EP, H)."""
    return edge_softmax(g, _typed_logits(g, score_e, mu, impl),
                        stable=stable, impl=impl)


def hgt_softmax_weighted_agg(g, message_e: torch.Tensor,
                             score_e: torch.Tensor, mu: torch.Tensor, *,
                             stable=False,
                             impl: str = "kernel") -> torch.Tensor:
    """HGT's typed edge softmax and the weighted sum of ``message_e``
    (EP, H, D) into destinations -> (N, H, D), as het_tpu's pallas
    backend computes it: the fused per-edge op with the identity
    activation (:func:`~.fused_agg.fused_softmax_agg`) under "raw" and
    "clip"; under "max" one segment sum of ``[z | z*msg]`` after the
    max-subtracted ``exp``.  The fused ops sum ``z`` and ``z*msg`` apart;
    this chain keeps one buffer because its backward is autograd's, whose
    destination gather follows the buffer: two sums cost a narrow (EP, H)
    gather more, slower on the card (PERF.md's GAT findings)."""
    return edge_softmax_weighted_sum(g, _typed_logits(g, score_e, mu, impl),
                                     message_e, stable=stable, impl=impl)


def hgt_softmax_weighted_agg_compact(g, message_c: torch.Tensor,
                                     score_e: torch.Tensor,
                                     mu: torch.Tensor, *, stable=False,
                                     impl: str = "kernel") -> torch.Tensor:
    """:func:`hgt_softmax_weighted_agg` with messages on source compact
    rows (UCs, H, D), expanded to the edges (:func:`expand_compact`)."""
    message_e = expand_compact(g, message_c, "src", impl=impl)
    return hgt_softmax_weighted_agg(g, message_e, score_e, mu,
                                    stable=stable, impl=impl)


def hgt_compact_attention(g, message_c: torch.Tensor,
                          att_q_c: torch.Tensor, k_nodes: torch.Tensor,
                          mu: torch.Tensor, *, stable=False,
                          impl: str = "kernel") -> torch.Tensor:
    """HGT's compact attention: the score ``<att_q_c[rowD(e)],
    k[src(e)]>``, the typed softmax and the aggregation of source compact
    messages -> (N, H, dk).  "raw" and "clip" take the fused
    :class:`~.fused_agg.HGTCompactAttention`; "max" the unfused chain
    (:func:`compact_dst_inner`, then
    :func:`hgt_softmax_weighted_agg_compact`), as het_tpu's pallas
    backend does."""
    mode = _mode(stable)
    if mode == "max":
        score = compact_dst_inner(g, att_q_c, k_nodes, impl=impl)
        return hgt_softmax_weighted_agg_compact(g, message_c, score, mu,
                                                stable=mode, impl=impl)
    UC, H, dk = message_c.shape
    return HGTCompactAttention.apply(
        message_c.reshape(UC, H * dk),
        att_q_c.reshape(att_q_c.shape[0], H * dk),
        k_nodes.reshape(k_nodes.shape[0], H * dk), mu, g,
        CLIP_LOGIT if mode == "clip" else None, impl)


def hgt_plain_attention(g, message_e: torch.Tensor, q_nodes: torch.Tensor,
                        k_nodes: torch.Tensor, w_att: torch.Tensor,
                        mu: torch.Tensor, *, stable=False,
                        impl: str = "kernel") -> torch.Tensor:
    """HGT's per-edge attention chain: ``att_q_e = q[dst] W_att[rel]``
    (:func:`edge_typed_linear`, a row a head), the score ``<att_q_e,
    k[src]>``, the typed softmax and the aggregation of ``message_e``.
    het_tpu fuses it for "raw" and "clip" in an op no ``HGTLayer`` path
    reaches; the port runs the chain in every mode."""
    att_q_e = edge_typed_linear(g, q_nodes, w_att, side="dst", impl=impl)
    score = inner_product_edge_node(g, att_q_e, k_nodes, "src", impl=impl)
    return hgt_softmax_weighted_agg(g, message_e, score, mu, stable=stable,
                                    impl=impl)


def hgt_plain_layer_core(g, v_nodes: torch.Tensor, q_nodes: torch.Tensor,
                         k_nodes: torch.Tensor, w_msg: torch.Tensor,
                         w_att: torch.Tensor, mu: torch.Tensor, *,
                         stable=False, impl: str = "kernel") -> torch.Tensor:
    """HGT's plain layer core: the message ``v[src] W_msg[rel]``, the
    score ``q[dst] W_att[rel] . k[src]``, the typed softmax and the
    aggregation -> (N, H, dk).  "raw" and "clip" take the fused
    :class:`~.fused_agg.HGTPlainFull`; "max" the unfused chain, as
    het_tpu's pallas backend does."""
    mode = _mode(stable)
    if mode == "max":
        message_e = edge_typed_linear(g, v_nodes, w_msg, side="src",
                                      impl=impl)
        return hgt_plain_attention(g, message_e, q_nodes, k_nodes, w_att,
                                   mu, stable=mode, impl=impl)
    H, dk = q_nodes.shape[1], q_nodes.shape[2]
    return HGTPlainFull.apply(
        v_nodes.reshape(v_nodes.shape[0], H * dk),
        q_nodes.reshape(q_nodes.shape[0], H * dk),
        k_nodes.reshape(k_nodes.shape[0], H * dk), w_msg, w_att, mu, g,
        CLIP_LOGIT if mode == "clip" else None, impl)


def edge_softmax_weighted_sum(g, logits: torch.Tensor,
                              vec_e: torch.Tensor, *, stable=False,
                              impl: str = "kernel") -> torch.Tensor:
    """``out[dst] = sum_e softmax_dst(logits)_e * vec_e``, the generic
    fused softmax aggregation (the compiler's ``FusedEdgeSoftmaxAgg``):
    logits (EP, H) or (EP,), vec_e (EP, [H,] D) in canonical order ->
    (N, [H,] D).  As het_tpu's pallas backend (``het_tpu/ops/spmm.py::
    edge_softmax_weighted_sum``): "raw" and "clip" take the fused per-edge
    op with the identity activation (:func:`~.fused_agg.
    fused_softmax_agg`); "max" the unfused chain, one segment sum of
    ``[z | z*vec]`` after the max-subtracted ``exp``.  That chain keeps one
    buffer because its backward is autograd's, whose destination gather
    follows the buffer: two sums cost a narrow (EP, H) gather more,
    slower on the card (PERF.md's GAT findings)."""
    squeeze = logits.dim() == 1
    if squeeze:
        logits, vec_e = logits[:, None], vec_e[:, None, :]
    mode = _mode(stable)
    if mode != "max":
        out = fused_softmax_agg(g, vec_e, logits, act="identity",
                                stable=mode, impl=impl)
    else:
        z = _masked_exp(g, _stabilize(g, logits, mode, impl))
        EP, H = z.shape
        D = vec_e.shape[-1]
        zf = (vec_e * z[..., None]).reshape(EP, H * D)
        agg = scatter_sum_dst(g, torch.cat([z, zf], dim=1), impl=impl)
        out = safe_div(agg[:, H:].view(-1, H, D), agg[:, :H, None])
    return out[:, 0, :] if squeeze else out


def edge_softmax_weighted_sum_compact(g, logits: torch.Tensor,
                                      msg_c: torch.Tensor, *, stable=False,
                                      impl: str = "kernel") -> torch.Tensor:
    """:func:`edge_softmax_weighted_sum` of source-compact messages, ``out
    [dst] = sum_e softmax_dst(logits)_e * msg_c[compact_src_row(e)]``:
    logits (EP, H) or (EP,), msg_c (UCs, [H,] D) -> (N, [H,] D) (the
    compiler's ``FusedEdgeSoftmaxAggCompact``).  "raw" and "clip" take
    :class:`~.fused_agg.SrcCompactFusedSoftmaxAgg`, which keeps no
    per-edge message tensor; "max" expands the messages
    (:func:`~.linear.expand_compact`) into the unfused chain, as
    het_tpu's pallas backend does (``het_tpu/ops/spmm.py::
    edge_softmax_weighted_sum_compact``)."""
    squeeze = logits.dim() == 1
    if squeeze:
        logits, msg_c = logits[:, None], msg_c[:, None, :]
    mode = _mode(stable)
    if mode != "max":
        out = fused_softmax_agg_src_compact(g, msg_c, logits, act="identity",
                                            stable=mode, impl=impl)
    else:
        out = edge_softmax_weighted_sum(
            g, logits, expand_compact(g, msg_c, "src", impl=impl),
            stable=mode, impl=impl)
    return out[:, 0, :] if squeeze else out


# ------------------------------------------------------------------- GAT


def gat_node_fused(g, feat: torch.Tensor, el: torch.Tensor,
                   er: torch.Tensor, slope: float, *, stable=False,
                   impl: str = "kernel") -> torch.Tensor:
    """Homogeneous GAT's softmax aggregation with node-level inputs: feat
    (src_space, H, D), el (src_space, H), er (N, H) -> (N, H, D).  "raw"
    and "clip" take :class:`~.fused_agg.NodeFusedGAT`, which keeps no
    per-edge tensor; "max" the per-edge op on the gathered inputs, as
    het_tpu's pallas backend does."""
    mode = _mode(stable)
    if mode == "max":
        return relational_fused_gat(
            g, gather_src(g, feat, impl=impl), gather_src(g, el, impl=impl),
            gather_dst(g, er, impl=impl), slope, stable=mode, impl=impl)
    ns, H, D = feat.shape
    out = NodeFusedGAT.apply(feat.reshape(ns, H * D), el, er, g,
                             float(slope), _clip(mode), impl)
    return out.view(-1, H, D)


def gat_node_fused2d(g, feat2d: torch.Tensor, el: torch.Tensor,
                     er: torch.Tensor, slope: float, *, num_heads: int,
                     stable=False, impl: str = "kernel") -> torch.Tensor:
    """:func:`gat_node_fused` on head-major rows: feat2d (src_space,
    H*D) -> (N, H*D)."""
    out = gat_node_fused(g, feat2d.view(feat2d.shape[0], num_heads, -1),
                         el, er, slope, stable=stable, impl=impl)
    return out.reshape(out.shape[0], -1)


def gat_layer_core(g, x2d: torch.Tensor, w: torch.Tensor,
                   attn_l: torch.Tensor, attn_r: torch.Tensor, slope: float,
                   *, stable=False, impl: str = "kernel") -> torch.Tensor:
    """Homogeneous GAT's layer core: the projection ``x W``, the logits a
    head, the softmax and the aggregation -> (N, H*D) head-major; x2d
    (rows, F), w (F, H*D), attn_l/attn_r (H, D).  het_tpu's gate: "raw" or
    "clip", F <= H*D and one node space (x2d's rows, the source space and
    the destinations alike) take :class:`~.fused_agg.GATLayerFused`;
    otherwise the composed path, the projection and the logits by
    autograd, then :func:`gat_node_fused2d`."""
    mode = _mode(stable)
    H, D = attn_l.shape
    N = g.num_nodes
    if (mode != "max" and x2d.shape[1] <= H * D and g.src_space == N
            and x2d.shape[0] == N):
        return GATLayerFused.apply(x2d, w, attn_l, attn_r, g, float(slope),
                                   _clip(mode), impl)
    feat2d = x2d @ w
    f3 = feat2d.view(-1, H, D)
    el = (f3 * attn_l).sum(-1)
    er = (f3[:N] * attn_r).sum(-1)
    return gat_node_fused2d(g, feat2d, el, er, slope, num_heads=H,
                            stable=mode, impl=impl)
