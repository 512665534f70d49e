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
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import gather_dst, gather_nodes, safe_div, take_rows
from .kernels import seg_max_sorted, seg_sum_sorted

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
