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
``(feat_c, el_c, er_c, s, out)`` and the backward recomputes the edge
terms from compact-row gathers.

Backward, with ``s`` the softmax denominators:

    alpha_e = z_e / s[dst(e)]
    dfeat_e = alpha_e * ct[dst(e)]
    draw_e  = alpha_e * (<feat_e, ct[dst(e)]> - <out[dst(e)], ct[dst(e)]>)
              * act'(raw_e)

``draw`` is summed over the canonical (dst, rel) runs into destination
compact rows (d_er); ``[draw | dfeat]`` is summed, through
``edge_sort_perm``, into source compact rows (d_el, d_feat).
"""

from __future__ import annotations

from typing import Optional

import torch

from .common import gather_dst, gather_nodes, safe_div, take_rows
from .kernels import seg_sum_sorted


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


def _edge_terms(el_feat_c, er_c, infoS, infoD, H, slope, clip):
    """Per-edge z = exp(act(raw)), act'(raw) and feat in canonical order,
    from one source-row gather of [el | feat] and one destination-row
    gather of er."""
    ge = take_rows(el_feat_c, infoS.edge_map)
    raw = ge[:, :H] + take_rows(er_c, infoD.edge_map)
    z = torch.exp(_act_apply(raw, slope, clip))
    return z, _act_deriv(raw, slope, clip), ge[:, H:]


class FusedGAT(torch.autograd.Function):
    """``forward(feat2d (EP, H*D), raw (EP, H), g, slope, clip, impl) ->
    (N, H, D)`` with ``raw = el + er`` per canonical edge.  The forward
    saves ``(feat2d, raw, s, out)``; the backward is the one in the module
    docstring with per-edge inputs: ``dfeat`` and ``draw`` in canonical
    order, zero on padding edges (their ``dst`` gathers a zero row)."""

    @staticmethod
    def forward(ctx, feat2d, raw, g, slope: float, clip: Optional[float],
                impl: str):
        H = raw.shape[1]
        D = feat2d.shape[1] // H
        z = torch.exp(_act_apply(raw.float(), slope, clip))
        # padding edges give finite z and lie past in_row_ptr's end
        payload = torch.cat([z, z.repeat_interleave(D, 1) * feat2d.float()],
                            dim=1)
        agg = seg_sum_sorted(payload, g.in_row_ptr, impl=impl)
        s, num = agg[:, :H], agg[:, H:]
        out = safe_div(num.view(-1, H, D), s[..., None])
        ctx.save_for_backward(feat2d, raw, s, out)
        ctx.g, ctx.slope, ctx.clip = g, slope, clip
        return out.to(feat2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat2d, raw, s, out = ctx.saved_tensors
        g, slope, clip = ctx.g, ctx.slope, ctx.clip
        H = raw.shape[1]
        HD = feat2d.shape[1]
        D = HD // H
        raw32 = raw.float()
        z = torch.exp(_act_apply(raw32, slope, clip))
        ct = ct.float()
        t2 = (out * ct).sum(-1)  # (N, H)
        # one dst gather (monotone in canonical order) serves ct, s and t2
        cpe = gather_dst(g, torch.cat([ct.reshape(-1, HD), s, t2], dim=1))
        ctd = cpe[:, :HD]
        alpha = safe_div(z, cpe[:, HD:HD + H])
        t1 = (feat2d.float() * ctd).view(-1, H, D).sum(-1)
        draw = alpha * (t1 - cpe[:, HD + H:]) * _act_deriv(raw32, slope,
                                                           clip)
        dfeat = alpha.repeat_interleave(D, 1) * ctd
        return (dfeat.to(feat2d.dtype), draw.to(raw.dtype),
                None, None, None, None)


class CompactFusedGAT(torch.autograd.Function):
    """``forward(feat_c2d (UCs, H*D), el_c (UCs, H), er_c (UCd, H), g,
    slope, clip, impl) -> (N, H, D)``; ``impl`` picks the segment sum's
    kernel or its plain version on the card."""

    @staticmethod
    def forward(ctx, feat_c2d, el_c, er_c, g, slope: float,
                clip: Optional[float], impl: str):
        H = el_c.shape[1]
        HD = feat_c2d.shape[1]
        D = HD // H
        el_feat_c = torch.cat([el_c, feat_c2d], dim=1).float()
        z, _, feat_e = _edge_terms(el_feat_c, er_c.float(), g.compact_src,
                                   g.compact_dst, H, slope, clip)
        # (EP, H) -> (EP, H*D) head-major
        payload = torch.cat([z, z.repeat_interleave(D, 1) * feat_e], dim=1)
        agg = seg_sum_sorted(payload, g.in_row_ptr, impl=impl)
        s, num = agg[:, :H], agg[:, H:]
        out = safe_div(num.view(-1, H, D), s[..., None])
        ctx.save_for_backward(feat_c2d, el_c, er_c, s, out)
        ctx.g, ctx.slope, ctx.clip, ctx.impl = g, slope, clip, impl
        return out.to(feat_c2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat_c2d, el_c, er_c, s, out = ctx.saved_tensors
        g, slope, clip, impl = ctx.g, ctx.slope, ctx.clip, ctx.impl
        infoS, infoD = g.compact_src, g.compact_dst
        H = el_c.shape[1]
        HD = feat_c2d.shape[1]
        D = HD // H
        ct = ct.float()
        t2 = (out * ct).sum(-1)  # (N, H)
        ctpack = torch.cat([ct.reshape(-1, HD), s, t2], dim=1)

        el_feat_c = torch.cat([el_c, feat_c2d], dim=1).float()
        z, actd, feat_e = _edge_terms(el_feat_c, er_c.float(), infoS, infoD,
                                      H, slope, clip)
        cpe = gather_dst(g, ctpack)  # zero rows on padding edges
        ctd = cpe[:, :HD]
        alpha = safe_div(z, cpe[:, HD:HD + H])
        t1 = (feat_e * ctd).view(-1, H, D).sum(-1)
        draw = alpha * (t1 - cpe[:, HD + H:]) * actd
        dfeat = alpha.repeat_interleave(D, 1) * ctd

        # destination side: (dst, rel) runs are contiguous in canonical
        # order; padding compact rows map to the sentinel run (zero row)
        red_d = seg_sum_sorted(draw, infoD.canon_ptr, impl=impl)
        d_er_c = gather_nodes(red_d, infoD.canon_to_row)
        # source side: the canonical payload read in compact-row order
        red_s = seg_sum_sorted(torch.cat([draw, dfeat], dim=1),
                               infoS.edge_row_ptr, infoS.edge_sort_perm,
                               impl=impl)
        return (red_s[:, H:].to(feat_c2d.dtype),
                red_s[:, :H].to(el_c.dtype),
                d_er_c.to(er_c.dtype), None, None, None, None)
