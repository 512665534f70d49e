"""Fused edge softmax + aggregation with an analytic backward.

:class:`FusedGAT` is the counterpart of
``het_tpu/ops/pallas/fused_agg.py::_make_fused_op`` (per-edge inputs, the
plain RGAT path): one sorted segment sum of ``[z | z*feat]`` over
``in_row_ptr`` forward, gathers and elementwise work backward.

:class:`CompactFusedGAT` is the counterpart of ``_make_compact_fused_op``
(the single-sided compact op, ``COMPACT_BWD="permute"``):

    out[v] = sum_{dst(e)=v} softmax_v(act(el_c[rowS(e)] + er_c[rowD(e)]))
             * feat_c[rowS(e)]

with rowS/rowD the source/destination ``edge_map``s and ``act`` a leaky
ReLU followed by an optional clip.  Inputs stay on compact rows; per-edge
tensors exist only between a gather and the sorted segment sum.  The
forward keeps no per-edge tensor for the backward: it saves
``(feat_c, el_c, er_c, s, out)`` (and the max ``m`` below) and the
backward recomputes the edge terms from compact-row gathers.

:class:`CompactFusedGATPacked` is the counterpart of
``_make_compact_fused_packed_op``: the same function with the source
operand the packed output of the multiply-first projection, per-head lanes
``[el | feat]`` in one ``(UCs, H*(1+D))`` buffer, whose gradient leaves
the source-side reduce already in that layout.

The softmax is a raw ``exp`` by default (the reference's), or clipped
(``stable="clip"``, logits clamped to +-``CLIP_LOGIT``), or exact
(``stable="max"``): ``z = exp(act(raw) - m[dst])`` with ``m`` the
destination max of ``act(raw)`` (``seg_max_sorted`` over ``in_row_ptr``),
saved for the backward.  The max carries no gradient (softmax is
shift-invariant, and the JAX package stops it), so the backward formula
is the same in every mode.

Backward, with ``s`` the softmax denominators:

    alpha_e = z_e / s[dst(e)]
    dfeat_e = alpha_e * ct[dst(e)]
    draw_e  = alpha_e * (<feat_e, ct[dst(e)]> - <out[dst(e)], ct[dst(e)]>)
              * act'(raw_e)

``draw`` is summed over the canonical (dst, rel) runs into destination
compact rows (d_er); ``[draw | dfeat]`` is summed, through
``edge_sort_perm``, into source compact rows (d_el, d_feat).

:class:`CompactWeightedAgg` is the counterpart of
``_compact_weighted_agg_op`` (``_cwa_fwd`` / ``_cwa_bwd``), RGCN's
single-sided compact aggregation with a per-edge weight:

    out[v] = sum_{dst(e)=v} w_e * feat_c[rowS(e)]

one segment sum over ``in_row_ptr`` forward; backward, ``d_feat_c`` one
segment sum of ``ct[dst(e)] * w_e`` through ``edge_sort_perm`` into the
source compact rows and ``d_w_e = <feat_c[rowS(e)], ct[dst(e)]>``.

:class:`HGTCompactAttention` and :class:`HGTPlainFull` are the
counterparts of ``_make_hgt_compact_attention_op`` and
``_make_hgt_plain_full_op``: HGT's score, typed softmax (the identity
activation, an optional clip, ``raw = score * mu[rel]``) and aggregation
in one op each, with the backward above and ``d_mu``, the sum of ``draw *
score`` a relation, the grouped dW over the relation-sorted edge rows.
:func:`fused_softmax_agg` is :class:`FusedGAT` with the activation
named ("identity" is a leaky ReLU of slope 1).
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import gather_dst, gather_nodes, safe_div, take_rows
from .kernels import seg_max_sorted, seg_sum_sorted
from .linear import (_edge_row_idx, edge_rel_scale_grad, segment_matmul,
                     segment_matmul_pullback)

CLIP_LOGIT = 60.0  # exp(60) ~ 1e26: far from f32 overflow, keeps order
STABLE_MODES = ("raw", "clip", "max")


def _act_apply(raw, slope: float, clip: Optional[float]):
    a = torch.where(raw >= 0, raw, slope * raw)
    if clip is not None:
        a = a.clamp(-clip, clip)
    return a


def _act_deriv(raw, slope: float, clip: Optional[float]):
    """Derivative of :func:`_act_apply`: zero outside the clip."""
    d = torch.where(raw >= 0, torch.ones_like(raw),
                    torch.full_like(raw, slope))
    if clip is not None:
        inner = torch.where(raw >= 0, raw, slope * raw)
        d = torch.where(inner.abs() <= clip, d, torch.zeros_like(d))
    return d


def _clip(stable: str) -> Optional[float]:
    return CLIP_LOGIT if stable == "clip" else None


def _softmax_num(g, raw, slope: float, stable: str, impl: str):
    """Forward: ``z`` (EP, H) and the destination max ``m`` (N, H), None
    unless ``stable == "max"``.  Padding edges lie past ``in_row_ptr``'s
    end, so the max never reads them."""
    a = _act_apply(raw, slope, _clip(stable))
    if stable != "max":
        return torch.exp(a), None
    m = seg_max_sorted(a, g.in_row_ptr, impl=impl)
    return torch.exp(a - gather_dst(g, m)), m


def _softmax_terms(raw, slope: float, stable: str, m_e):
    """Backward: ``z`` and ``act'(raw)`` per edge, with ``m_e`` the
    gathered destination max under ``stable == "max"``."""
    clip = _clip(stable)
    a = _act_apply(raw, slope, clip)
    if m_e is not None:
        a = a - m_e
    return torch.exp(a), _act_deriv(raw, slope, clip)


def _ct_pack(g, ct, s, out, m):
    """One destination gather (monotone in canonical order) of everything
    the backward reads per edge: ``ct`` (HD lanes), ``s``, ``<out, ct>``
    per head and, under ``stable="max"``, ``m`` (H lanes each).  Zero on
    padding edges.  Returns ``(ctd, s_d, t2d, m_d)``."""
    H = s.shape[1]
    HD = ct.shape[1] * ct.shape[2]
    t2 = (out * ct).sum(-1)  # (N, H)
    parts = [ct.reshape(-1, HD), s, t2] + ([m] if m is not None else [])
    cpe = gather_dst(g, torch.cat(parts, dim=1))
    m_d = cpe[:, HD + 2 * H:] if m is not None else None
    return (cpe[:, :HD], cpe[:, HD:HD + H], cpe[:, HD + H:HD + 2 * H],
            m_d)


def _compact_raw(el_feat_c, er_c, infoS, infoD, H):
    """Per-edge logits ``raw`` and features in canonical order, from one
    source-row gather of [el | feat] and one destination-row gather of
    er."""
    ge = take_rows(el_feat_c, infoS.edge_map)
    return ge[:, :H] + take_rows(er_c, infoD.edge_map), ge[:, H:]


class FusedGAT(torch.autograd.Function):
    """``forward(feat2d (EP, H*D), raw (EP, H), g, slope, stable, impl) ->
    (N, H, D)`` with ``raw = el + er`` per canonical edge.  The forward
    saves ``(feat2d, raw, s, out, m)``; the backward is the one in the
    module docstring with per-edge inputs: ``dfeat`` and ``draw`` in
    canonical order, zero on padding edges (their ``dst`` gathers a zero
    row)."""

    @staticmethod
    def forward(ctx, feat2d, raw, g, slope: float, stable: str, impl: str):
        H = raw.shape[1]
        D = feat2d.shape[1] // H
        # padding edges lie past in_row_ptr's end: never reduced
        z, m = _softmax_num(g, raw.float(), slope, stable, impl)
        payload = torch.cat([z, z.repeat_interleave(D, 1) * feat2d.float()],
                            dim=1)
        agg = seg_sum_sorted(payload, g.in_row_ptr, impl=impl)
        s, num = agg[:, :H], agg[:, H:]
        out = safe_div(num.view(-1, H, D), s[..., None])
        ctx.save_for_backward(feat2d, raw, s, out, m)
        ctx.g, ctx.slope, ctx.stable = g, slope, stable
        return out.to(feat2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat2d, raw, s, out, m = ctx.saved_tensors
        H = raw.shape[1]
        D = feat2d.shape[1] // H
        ctd, s_d, t2d, m_d = _ct_pack(ctx.g, ct.float(), s, out, m)
        z, actd = _softmax_terms(raw.float(), ctx.slope, ctx.stable, m_d)
        alpha = safe_div(z, s_d)
        t1 = (feat2d.float() * ctd).view(-1, H, D).sum(-1)
        draw = alpha * (t1 - t2d) * actd
        dfeat = alpha.repeat_interleave(D, 1) * ctd
        return (dfeat.to(feat2d.dtype), draw.to(raw.dtype),
                None, None, None, None)


def _d_er(infoD, draw, impl: str):
    """d_er on destination compact rows: ``draw`` summed over the
    canonical (dst, rel) runs, contiguous in canonical order; padding
    compact rows map to the sentinel run (a zero row)."""
    red_d = seg_sum_sorted(draw, infoD.canon_ptr, impl=impl)
    return gather_nodes(red_d, infoD.canon_to_row)


class CompactFusedGAT(torch.autograd.Function):
    """``forward(feat_c2d (UCs, H*D), el_c (UCs, H), er_c (UCd, H), g,
    slope, stable, impl) -> (N, H, D)``; ``impl`` picks the kernels or
    their plain versions on the card."""

    @staticmethod
    def forward(ctx, feat_c2d, el_c, er_c, g, slope: float, stable: str,
                impl: str):
        H = el_c.shape[1]
        HD = feat_c2d.shape[1]
        D = HD // H
        el_feat_c = torch.cat([el_c, feat_c2d], dim=1).float()
        raw, feat_e = _compact_raw(el_feat_c, er_c.float(), g.compact_src,
                                   g.compact_dst, H)
        z, m = _softmax_num(g, raw, slope, stable, impl)
        # (EP, H) -> (EP, H*D) head-major
        payload = torch.cat([z, z.repeat_interleave(D, 1) * feat_e], dim=1)
        agg = seg_sum_sorted(payload, g.in_row_ptr, impl=impl)
        s, num = agg[:, :H], agg[:, H:]
        out = safe_div(num.view(-1, H, D), s[..., None])
        ctx.save_for_backward(feat_c2d, el_c, er_c, s, out, m)
        ctx.g, ctx.slope, ctx.stable, ctx.impl = g, slope, stable, impl
        return out.to(feat_c2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat_c2d, el_c, er_c, s, out, m = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        infoS, infoD = g.compact_src, g.compact_dst
        H = el_c.shape[1]
        HD = feat_c2d.shape[1]
        D = HD // H
        ctd, s_d, t2d, m_d = _ct_pack(g, ct.float(), s, out, m)
        el_feat_c = torch.cat([el_c, feat_c2d], dim=1).float()
        raw, feat_e = _compact_raw(el_feat_c, er_c.float(), infoS, infoD, H)
        z, actd = _softmax_terms(raw, ctx.slope, ctx.stable, m_d)
        alpha = safe_div(z, s_d)
        t1 = (feat_e * ctd).view(-1, H, D).sum(-1)
        draw = alpha * (t1 - t2d) * actd
        dfeat = alpha.repeat_interleave(D, 1) * ctd

        d_er_c = _d_er(infoD, draw, impl)
        # source side: the canonical payload read in compact-row order
        red_s = seg_sum_sorted(torch.cat([draw, dfeat], dim=1),
                               infoS.edge_row_ptr, infoS.edge_sort_perm,
                               impl=impl)
        return (red_s[:, H:].to(feat_c2d.dtype),
                red_s[:, :H].to(el_c.dtype),
                d_er_c.to(er_c.dtype), None, None, None, None)


class CompactFusedGATPacked(torch.autograd.Function):
    """``forward(fe2d (UCs, H*(1+D)), er_c (UCd, H), g, slope, stable,
    impl) -> (N, H, D)`` with per-head lanes ``[el | feat]`` in ``fe2d``.
    The backward's source-side payload is built in the same per-head
    ``[draw | dfeat]`` layout, so one segment sum through
    ``edge_sort_perm`` returns ``d_fe`` as it is; the destination
    (dst, rel)-run reduce takes only the ``draw`` lanes.  Five segment
    sums a layer with the compact gathers, as the split op."""

    @staticmethod
    def _edge_rows(fe2d, er_c, g, H):
        """Per-edge ``raw`` (EP, H) and the gathered rows (EP, H, 1+D)."""
        ge = take_rows(fe2d, g.compact_src.edge_map).float()
        ge = ge.view(ge.shape[0], H, -1)
        raw = ge[..., 0] + take_rows(er_c, g.compact_dst.edge_map).float()
        return raw, ge

    @staticmethod
    def forward(ctx, fe2d, er_c, g, slope: float, stable: str, impl: str):
        H = er_c.shape[1]
        raw, ge = CompactFusedGATPacked._edge_rows(fe2d, er_c, g, H)
        D = ge.shape[2] - 1
        z, m = _softmax_num(g, raw, slope, stable, impl)
        zf = (z[..., None] * ge[..., 1:]).reshape(-1, H * D)
        agg = seg_sum_sorted(torch.cat([z, zf], dim=1), g.in_row_ptr,
                             impl=impl)
        s, num = agg[:, :H], agg[:, H:]
        out = safe_div(num.view(-1, H, D), s[..., None])
        ctx.save_for_backward(fe2d, er_c, s, out, m)
        ctx.g, ctx.slope, ctx.stable, ctx.impl = g, slope, stable, impl
        return out.to(fe2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        fe2d, er_c, s, out, m = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        H = er_c.shape[1]
        raw, ge = CompactFusedGATPacked._edge_rows(fe2d, er_c, g, H)
        D = ge.shape[2] - 1
        ctd, s_d, t2d, m_d = _ct_pack(g, ct.float(), s, out, m)
        ctd3 = ctd.view(-1, H, D)
        z, actd = _softmax_terms(raw, ctx.slope, ctx.stable, m_d)
        alpha = safe_div(z, s_d)
        t1 = (ge[..., 1:] * ctd3).sum(-1)
        draw = alpha * (t1 - t2d) * actd  # (EP, H)
        pay = torch.cat([draw[..., None], alpha[..., None] * ctd3],
                        dim=2).view(-1, H * (1 + D))
        infoS = g.compact_src
        d_fe = seg_sum_sorted(pay, infoS.edge_row_ptr, infoS.edge_sort_perm,
                              impl=impl)
        d_er_c = _d_er(g.compact_dst, draw, impl)
        return (d_fe.to(fe2d.dtype), d_er_c.to(er_c.dtype),
                None, None, None, None)


class CompactWeightedAgg(torch.autograd.Function):
    """``forward(feat_c (UCs, C), w_e (EP,), g, impl) -> (N, C)``.  Saves
    the compact rows and the weights, no per-edge tensor; ``d_w`` only
    where ``w_e`` needs a gradient (het_tpu always returns it)."""

    @staticmethod
    def forward(ctx, feat_c, w_e, g, impl: str):
        feat_e = take_rows(feat_c, g.compact_src.edge_map).float()
        out = seg_sum_sorted(feat_e * w_e.float()[:, None], g.in_row_ptr,
                             impl=impl)
        ctx.save_for_backward(feat_c, w_e)
        ctx.g, ctx.impl = g, impl
        return out.to(feat_c.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat_c, w_e = ctx.saved_tensors
        g, infoS = ctx.g, ctx.g.compact_src
        ct_e = gather_dst(g, ct.float())  # zero on padding edges
        d_feat = d_w = None
        if ctx.needs_input_grad[0]:
            d_feat = seg_sum_sorted(ct_e * w_e.float()[:, None],
                                    infoS.edge_row_ptr, infoS.edge_sort_perm,
                                    impl=ctx.impl).to(feat_c.dtype)
        if ctx.needs_input_grad[1]:
            feat_e = take_rows(feat_c, infoS.edge_map).float()
            d_w = (feat_e * ct_e).sum(-1).to(w_e.dtype)
        return d_feat, d_w, None, None


def compact_weighted_agg(g, feat_c: torch.Tensor, w_e: torch.Tensor, *,
                         impl: str = "kernel") -> torch.Tensor:
    """``out[v] = sum_{dst(e)=v} w_e * feat_c[compact_src_row(e)]``:
    feat_c (UCs, C) on source compact rows, w_e (EP,) a weight per
    canonical edge -> (N, C).  Per-edge rows exist only between the
    compact-row gather and the segment sum."""
    if g.compact_src is None:
        raise ValueError("graph built without compact indices")
    return CompactWeightedAgg.apply(feat_c, w_e, g, impl)


def fused_softmax_agg(g, feat_e: torch.Tensor, raw_e: torch.Tensor, *,
                      act: str = "leaky_relu", slope: float = 0.2,
                      stable: str = "raw",
                      impl: str = "kernel") -> torch.Tensor:
    """``sum_dst softmax(act(raw)) * feat``: feat_e (EP, H, D), raw_e (EP,
    H) in canonical order -> (N, H, D), by :class:`FusedGAT` with ``act``
    "leaky_relu" (of ``slope``) or "identity", a leaky ReLU of slope 1
    (exactly: 1.0 * x == x in f32)
    (``het_tpu/ops/pallas/fused_agg.py::fused_softmax_agg``)."""
    if act not in ("leaky_relu", "identity"):
        raise ValueError(f"act must be leaky_relu or identity, got {act!r}")
    EP, H, D = feat_e.shape
    return FusedGAT.apply(feat_e.reshape(EP, H * D), raw_e, g,
                          1.0 if act == "identity" else float(slope), stable,
                          impl)


# ------------------------------------------------------------------- HGT


def _hgt_softmax_backward(g, ct, s, out, raw, feat_e, clip, H):
    """The backward terms the HGT ops share (the module docstring's, with
    the identity activation and an optional clip): ``ctd`` (EP, H*dk),
    ``alpha`` and ``draw`` (EP, H)."""
    ctd, s_d, t2d, _ = _ct_pack(g, ct.float(), s, out, None)
    z = torch.exp(_act_apply(raw, 1.0, clip))
    alpha = safe_div(z, s_d)  # 0 on padding edges (s_d = 0)
    t1 = (feat_e * ctd).view(ctd.shape[0], H, -1).sum(-1)
    draw = alpha * (t1 - t2d) * _act_deriv(raw, 1.0, clip)
    return ctd, alpha, draw


def _per_head(a, b, out=None):
    """``a`` (n, H) times ``b`` (n, H*dk) head by head -> (n, H*dk),
    written into ``out`` (an (n, H*dk) view) where given: no repeated
    (n, H*dk) copy of ``a`` and no concatenation."""
    n, H = a.shape
    if out is None:
        return (a[..., None] * b.view(n, H, -1)).view(n, -1)
    torch.mul(a[..., None], b.view(n, H, -1), out=out.view(n, H, -1))
    return out


def _hgt_aggregate(g, z, msg_e, impl):
    """Forward aggregation: one segment sum of ``[z | z*msg]`` over
    ``in_row_ptr``; returns ``(s, out)``."""
    EP, H = z.shape
    pay = z.new_empty(EP, H + msg_e.shape[1])
    pay[:, :H] = z
    _per_head(z, msg_e, pay[:, H:])
    agg = seg_sum_sorted(pay, g.in_row_ptr, impl=impl)
    s = agg[:, :H]
    return s, safe_div(agg[:, H:].view(-1, H, msg_e.shape[1] // H),
                       s[..., None])


class HGTCompactAttention(torch.autograd.Function):
    """HGT's compact attention chain in one op
    (``_make_hgt_compact_attention_op``):

        score_e = <attq_c[rowD(e)], k[src(e)]>  (per head)
        out[v]  = sum_{dst(e)=v} softmax_v(clip(score_e * mu[rel_e]))
                  * msg_c[rowS(e)]

    ``forward(msg2d (UCs, H*dk), attq2d (UCd, H*dk), k2d (src_space,
    H*dk), mu (R, H), g, clip, impl) -> (N, H, dk)``.  The forward is one
    segment sum of ``[z | z*msg]`` over ``in_row_ptr`` and keeps no
    per-edge tensor: the backward recomputes the score chain from
    compact-row and node gathers.  Backward: ``[dfeat | dscore*attq]``
    summed through ``edge_sort_perm`` into source compact rows (``d_msg``
    and each row's part of ``d_k``), those rows summed into source nodes
    through ``node_sort_perm`` (``d_k``), ``dscore*k`` over the canonical
    (dst, rel) runs (``d_attq``), and ``d_mu[r] = sum_{rel(e)=r} draw_e *
    score_e``, where het_tpu contracts a one-hot (EP, R) matrix: the
    grouped dW over the relation-sorted edge rows
    (:func:`~.linear.edge_rel_scale_grad`)."""

    @staticmethod
    def _edge_terms(msg2d, attq2d, k2d, mu, g):
        H = mu.shape[1]
        attq_e = take_rows(attq2d, g.compact_dst.edge_map).float()
        k_e = gather_nodes(k2d, g.src).float()
        score = (attq_e * k_e).view(attq_e.shape[0], H, -1).sum(-1)
        mu_e = take_rows(mu, g.rel).float()
        feat_e = take_rows(msg2d, g.compact_src.edge_map).float()
        return attq_e, k_e, score, mu_e, feat_e

    @staticmethod
    def forward(ctx, msg2d, attq2d, k2d, mu, g, clip: Optional[float],
                impl: str):
        _, _, score, mu_e, feat_e = HGTCompactAttention._edge_terms(
            msg2d, attq2d, k2d, mu, g)
        z = torch.exp(_act_apply(score * mu_e, 1.0, clip))
        # padding edges lie past in_row_ptr's end: never reduced
        s, out = _hgt_aggregate(g, z, feat_e, impl)
        ctx.save_for_backward(msg2d, attq2d, k2d, mu, s, out)
        ctx.g, ctx.clip, ctx.impl = g, clip, impl
        return out.to(msg2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        msg2d, attq2d, k2d, mu, s, out = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        infoS, infoD = g.compact_src, g.compact_dst
        H = mu.shape[1]
        dk = msg2d.shape[1] // H
        attq_e, k_e, score, mu_e, feat_e = HGTCompactAttention._edge_terms(
            msg2d, attq2d, k2d, mu, g)
        ctd, alpha, draw = _hgt_softmax_backward(
            g, ct, s, out, score * mu_e, feat_e, ctx.clip, H)
        del feat_e  # the per-edge rows go as soon as they are read
        dscore = draw * mu_e
        d_mu = edge_rel_scale_grad(g, score, draw, impl=impl)
        HD = H * dk
        # d_msg and each source compact row's part of d_k in one sum
        pay = ctd.new_empty(ctd.shape[0], 2 * HD)
        _per_head(alpha, ctd, pay[:, :HD])
        _per_head(dscore, attq_e, pay[:, HD:])
        del ctd, attq_e
        red_s = seg_sum_sorted(pay, infoS.edge_row_ptr, infoS.edge_sort_perm,
                               impl=impl)
        del pay
        d_k = seg_sum_sorted(red_s[:, HD:].contiguous(), infoS.node_row_ptr,
                             infoS.node_sort_perm, impl=impl)
        red_d = seg_sum_sorted(_per_head(dscore, k_e), infoD.canon_ptr,
                               impl=impl)
        d_attq = gather_nodes(red_d, infoD.canon_to_row)
        return (red_s[:, :HD].to(msg2d.dtype), d_attq.to(attq2d.dtype),
                d_k.to(k2d.dtype), d_mu.to(mu.dtype), None, None, None)


class HGTPlainFull(torch.autograd.Function):
    """HGT's plain layer core in one op (``_make_hgt_plain_full_op``):
    both per-edge typed linears over the relation-sorted edge rows
    (``edge_rel_seg``), ``msg = v[src] W_msg[rel]`` and ``attq = q[dst]
    W_att[rel]``, the score ``<attq, k[src]>``, the typed softmax and the
    aggregation.

    ``forward(v2d, q2d, k2d (rows, H*dk), w_msg, w_att (R, H, dk, dk), mu
    (R, H), g, clip, impl) -> (N, H, dk)``.  Forward: the two matmuls on
    the edge rows (:func:`~.linear.segment_matmul`, a row's input one a
    head), one read-back of ``[score | msg]`` through ``seg.inv``, one
    segment sum over ``in_row_ptr``.  It keeps the per-edge score (EP, H)
    and recomputes the matmuls in the backward, which takes: their
    pullbacks (:func:`~.linear.segment_matmul_pullback`), ``d_q`` as one
    segment sum over ``in_row_ptr`` through ``seg.inv``, ``d_k`` and
    ``d_v`` together in one over ``out_row_ptr`` through
    ``seg.inv[out_perm]``, and ``d_mu`` as in :class:`HGTCompactAttention`."""

    @staticmethod
    def _rows(x2d, w, g, side, H, impl):
        rows = gather_nodes(x2d, _edge_row_idx(g, side))
        rows = rows.view(rows.shape[0], H, -1)
        return rows, segment_matmul(rows, w, g.edge_rel_seg, impl=impl)

    @staticmethod
    def forward(ctx, v2d, q2d, k2d, w_msg, w_att, mu, g,
                clip: Optional[float], impl: str):
        seg = g.edge_rel_seg
        H = mu.shape[1]
        HD = q2d.shape[1]
        _, attq_rows = HGTPlainFull._rows(q2d, w_att, g, "dst", H, impl)
        k_rows = gather_nodes(k2d, _edge_row_idx(g, "src")).float()
        score_rows = (attq_rows.reshape(-1, HD) * k_rows).view(
            -1, H, HD // H).sum(-1)
        _, msg_rows = HGTPlainFull._rows(v2d, w_msg, g, "src", H, impl)
        # one read-back to canonical order serves score and msg
        se = take_rows(torch.cat([score_rows, msg_rows.reshape(-1, HD)],
                                 dim=1), seg.inv).float()
        score = se[:, :H].contiguous()
        mu_e = take_rows(mu, g.rel).float()
        z = torch.exp(_act_apply(score * mu_e, 1.0, clip))
        s, out = _hgt_aggregate(g, z, se[:, H:], impl)
        ctx.save_for_backward(v2d, q2d, k2d, w_msg, w_att, mu, score, s, out)
        ctx.g, ctx.clip, ctx.impl = g, clip, impl
        return out.to(v2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        v2d, q2d, k2d, w_msg, w_att, mu, score, s, out = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        seg = g.edge_rel_seg
        H = mu.shape[1]
        HD = q2d.shape[1]
        q_rows, attq_rows = HGTPlainFull._rows(q2d, w_att, g, "dst", H, impl)
        v_rows, msg_rows = HGTPlainFull._rows(v2d, w_msg, g, "src", H, impl)
        msg_e = take_rows(msg_rows.reshape(-1, HD), seg.inv).float()
        mu_e = take_rows(mu, g.rel).float()
        ctd, alpha, draw = _hgt_softmax_backward(
            g, ct, s, out, score * mu_e, msg_e, ctx.clip, H)
        d_mu = edge_rel_scale_grad(g, score, draw, impl=impl)
        # one canonical -> rows take serves dscore and dmsg
        both = take_rows(torch.cat([draw * mu_e, _per_head(alpha, ctd)],
                                   dim=1), seg.perm)
        del ctd, msg_e
        both = torch.where(seg.row_valid[:, None], both,
                           torch.zeros_like(both))
        dscore_rows = both[:, :H]
        k_rows = gather_nodes(k2d, _edge_row_idx(g, "src")).float()
        need = ctx.needs_input_grad
        d_q_rows, d_watt = segment_matmul_pullback(
            q_rows, w_att, seg, _per_head(dscore_rows, k_rows),
            need_dx=need[1], need_dw=need[4], impl=impl)
        del k_rows
        d_v_rows, d_wmsg = segment_matmul_pullback(
            v_rows, w_msg, seg, both[:, H:], need_dx=need[0],
            need_dw=need[3], impl=impl)
        d_q = d_k = d_v = None
        if need[1]:
            d_q = seg_sum_sorted(d_q_rows.reshape(-1, HD).float().contiguous(),
                                 g.in_row_ptr, seg.inv, impl=impl)
        if need[0] or need[2]:
            # d_k and d_v share one source-sorted reduce of the rows
            pay = both.new_empty(both.shape[0], 2 * HD if need[0] else HD)
            _per_head(dscore_rows, attq_rows.reshape(-1, HD).float(),
                      pay[:, :HD])
            if need[0]:
                pay[:, HD:] = d_v_rows.reshape(-1, HD)
            red = seg_sum_sorted(pay, g.out_row_ptr,
                                 take_rows(seg.inv, g.out_perm), impl=impl)
            d_k = red[:, :HD].to(k2d.dtype)
            if need[0]:
                d_v = red[:, HD:].to(v2d.dtype)
        return (d_v, d_q.to(q2d.dtype) if d_q is not None else None, d_k,
                d_wmsg, d_watt, d_mu.to(mu.dtype), None, None, None)
