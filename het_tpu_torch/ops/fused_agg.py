"""Fused edge softmax + aggregation with an analytic backward.

:class:`FusedGAT` is the counterpart of
``het_tpu/ops/pallas/fused_agg.py::_make_fused_op`` (per-edge inputs, the
plain RGAT path): sorted segment sums of ``z`` and ``z*feat`` over
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
the source-side reduce already in that layout.  On f32 operands on the
card under "raw" or "clip" it computes its edge terms inside three segment
walks (``kernels/compact_gat.py``) and writes no (EP, H*D) tensor.

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
compact rows (d_er); ``draw`` and ``dfeat`` are summed, through
``edge_sort_perm``, into source compact rows (d_el, d_feat).

:class:`CompactWeightedAgg` is the counterpart of
``_compact_weighted_agg_op`` (``_cwa_fwd`` / ``_cwa_bwd``), RGCN's
single-sided compact aggregation with a per-edge weight:

    out[v] = sum_{dst(e)=v} w_e * feat_c[rowS(e)]

one segment sum over ``in_row_ptr`` forward; backward, ``d_feat_c`` one
segment sum of ``ct[dst(e)] * w_e`` through ``edge_sort_perm`` into the
source compact rows and ``d_w_e = <feat_c[rowS(e)], ct[dst(e)]>``.

:class:`HGTCompactAttention`, :class:`HGTPlainAttention` and
:class:`HGTPlainFull` are the counterparts of
``_make_hgt_compact_attention_op``, ``_make_hgt_plain_attention_op`` and
``_make_hgt_plain_full_op``: HGT's score, typed softmax (the identity
activation, an optional clip, ``raw = score * mu[rel]``) and aggregation
in one op each, with the backward above and ``d_mu``, the sum of ``draw *
score`` a relation, the grouped dW over the relation-sorted edge rows.
:func:`fused_softmax_agg` is :class:`FusedGAT` with the activation
named ("identity" is a leaky ReLU of slope 1).
:class:`SrcCompactFusedSoftmaxAgg` is the counterpart of
``_make_src_compact_fused_op``, the compiler's softmax aggregation of
source-compact messages with per-edge logits: the forward of
:class:`FusedGAT` on messages gathered from compact rows, and
``d_feat_c`` one segment sum through ``edge_sort_perm``.

:class:`NodeFusedGAT` and :class:`GATLayerFused` are the counterparts of
``_make_node_fused_op`` and ``_make_gat_layer_op``, homogeneous GAT's ops
with node-sided inputs: the logits ``el[src] + er[dst]`` and the features
``feat[src]`` are gathered from node rows, the forward sums ``z`` and
``z*feat`` over ``in_row_ptr`` and the backward reduces ``draw`` over it
(d_er) and ``draw`` and ``dfeat`` over the source CSR, ``out_row_ptr``
through ``out_perm`` (d_el, d_feat).  The layer op computes the projection
and the logits inside and pulls their gradients back at node scale.

:class:`NodeFusedHGNAttention` (:func:`simple_hgn_attention`) is
Simple-HGN's node-sided attention, which the JAX package lacks: a
per-relation logit term, a self-loop term in each destination's softmax
and the previous layer's attention mixed in, over node-aligned edge
blocks (``graph/blocks.py``) so that its (edges, H*D) payloads stay a
block's size at 512 lanes.

Every op sums its narrow and wide per-edge terms (``z`` and ``z*feat``;
``draw`` and ``dfeat`` at the source side) through one helper,
:func:`_sum_heads`, in two segment sums.

Element types follow het_tpu's: the logits, ``z`` and the backward's
terms are f32, and every per-edge payload is summed in the dtype het_tpu
packs it in, ``pack_dt`` (:func:`_pack_dt`: bf16 where the op's feature
input is bf16, else f32), into f32 sums forward and into ``pack_dt`` sums
where het_tpu passes ``out_dt=pack_dt`` (the source-side and (dst, rel)
reduces of the backward).  In f32 every sum is f32 -> f32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils import spans
from ..graph.blocks import graph_blocks
from .common import _sum_rel, gather_dst, gather_nodes, safe_div, take_rows
from .kernels import (_dispatch, compact_gat_packed_bwd_dst,
                      compact_gat_packed_bwd_src, compact_gat_packed_fwd,
                      seg_max_sorted, seg_sum_sorted)
from .kernels.compact_gat import (MAX_D, act as _act_apply,
                                  act_deriv as _act_deriv)
from .linear import (_edge_row_idx, edge_rel_scale_grad, segment_matmul,
                     segment_matmul_pullback)

CLIP_LOGIT = 60.0  # exp(60) ~ 1e26: far from f32 overflow, keeps order
STABLE_MODES = ("raw", "clip", "max")


def _clip(stable: str) -> Optional[float]:
    return CLIP_LOGIT if stable == "clip" else None


def _pack_dt(x: torch.Tensor) -> torch.dtype:
    """The payload dtype het_tpu sums for an op whose feature input is
    ``x`` (``fused_agg.py::_pack_dt``)."""
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _sum(vals, ptr, perm, impl: str, dt, out_dt=None):
    """``vals`` cast to ``dt`` (het_tpu's ``pack_dt``) summed over ``ptr``
    through ``perm`` into ``out_dt`` (f32 by default)."""
    return seg_sum_sorted(vals.to(dt).contiguous(), ptr, perm,
                          out_dtype=out_dt, impl=impl)


def _softmax_num(g, raw, slope: float, stable: str, impl: str):
    """Forward: ``z`` (EP, H) and the destination max ``m`` (N, H), None
    unless ``stable == "max"``.  Padding edges lie past ``in_row_ptr``'s
    end, so the max never reads them."""
    a = _act_apply(raw, slope, _clip(stable))
    if stable != "max":
        return torch.exp(a), None
    m = seg_max_sorted(a, g.in_row_ptr, impl=impl)
    return torch.exp(a - gather_dst(g, m)), m


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


def _softmax_backward(g, ct, s, out, raw, feat_e, slope: float,
                      clip: Optional[float], m=None):
    """The backward terms every fused op shares (the module docstring's):
    one destination gather (:func:`_ct_pack`), then ``ctd`` (EP, H*D),
    ``alpha`` and ``draw`` (EP, H).  ``ct`` and ``out`` are (N, H, D),
    ``feat_e`` (EP, H*D) or (EP, H, D), ``raw`` (EP, H); ``slope`` is 1
    for HGT's identity; ``m`` is the destination max (N, H) under
    stable="max", else None."""
    ctd, s_d, t2d, m_d = _ct_pack(g, ct.float(), s, out, m)
    a = _act_apply(raw, slope, clip)
    if m_d is not None:
        a = a - m_d
    alpha = safe_div(torch.exp(a), s_d)  # 0 on padding edges (s_d = 0)
    n, H = alpha.shape
    t1 = (feat_e.view(n, H, -1) * ctd.view(n, H, -1)).sum(-1)
    draw = alpha * (t1 - t2d) * _act_deriv(raw, slope, clip)
    return ctd, alpha, draw


def _per_head(a, b, out=None, dtype=None):
    """``a`` (n, H) times ``b`` (n, H*dk) or (n, H, dk) head by head ->
    (n, H*dk), written into ``out`` (an (n, H*dk) view) where given, else
    into a new tensor of ``dtype`` (the operands' by default; the product
    is rounded once to it): no repeated (n, H*dk) copy of ``a`` and no
    concatenation."""
    n, H = a.shape
    if out is None:
        if dtype is None:
            return (a[..., None] * b.view(n, H, -1)).view(n, -1)
        out = torch.empty(n, b.numel() // n, dtype=dtype, device=b.device)
    torch.mul(a[..., None], b.view(n, H, -1), out=out.view(n, H, -1))
    return out


def _sum_heads(n, a, b, ptr, perm, impl: str, dt=torch.float32,
               out_dt=None):
    """``n`` and ``a*b`` (head by head) summed over ``ptr``, reading row
    ``perm[e]`` where given: ``n`` and ``a`` (EP, H), ``b`` (EP, H*D) or
    (EP, H, D), either a view -> ``(sum n (rows, H), sum a*b (rows,
    H*D))``, each payload cast to ``dt`` (``pack_dt``, the product written
    in it) and summed into ``out_dt`` (f32 by default).  Two segment sums
    and no ``[n | a*b]`` buffer: building one costs more than the narrow
    sum's walk at every width the models give (PERF.md's GAT findings)."""
    return (_sum(n, ptr, perm, impl, dt, out_dt),
            seg_sum_sorted(_per_head(a, b, dtype=dt), ptr, perm,
                           out_dtype=out_dt, impl=impl))


def _aggregate(g, z, feat_e, impl: str, dt=torch.float32):
    """The forward aggregation: ``s = sum z`` and ``out = sum z*feat / s``
    over ``in_row_ptr`` (:func:`_sum_heads`, payloads in ``dt``, f32
    sums), ``z`` (EP, H), ``feat_e`` (EP, H*D) or (EP, H, D) in canonical
    order.  Padding edges lie past ``in_row_ptr``'s end: never reduced.
    Returns ``(s, out (N, H, D))``."""
    s, num = _sum_heads(z, z, feat_e, g.in_row_ptr, None, impl, dt)
    H = z.shape[1]
    return s, safe_div(num.view(-1, H, num.shape[1] // H), s[..., None])


def _compact_raw(el_feat_c, er_c, infoS, infoD, H):
    """Per-edge logits ``raw`` and features in canonical order, from one
    source-row gather of [el | feat] and one destination-row gather of
    er."""
    ge = take_rows(el_feat_c, infoS.edge_map)
    return ge[:, :H] + take_rows(er_c, infoD.edge_map), ge[:, H:]


@spans.function
class FusedGAT(torch.autograd.Function):
    """``forward(feat2d (EP, H*D), raw (EP, H), g, slope, stable, impl) ->
    (N, H, D)`` with ``raw = el + er`` per canonical edge.  The forward
    saves ``(feat2d, raw, s, out, m)``; the backward is the one in the
    module docstring with per-edge inputs: ``dfeat`` and ``draw`` in
    canonical order, zero on padding edges (their ``dst`` gathers a zero
    row)."""

    @staticmethod
    def forward(ctx, feat2d, raw, g, slope: float, stable: str, impl: str):
        z, m = _softmax_num(g, raw.float(), slope, stable, impl)
        s, out = _aggregate(g, z, feat2d.float(), impl, _pack_dt(feat2d))
        ctx.save_for_backward(feat2d, raw, s, out, m)
        ctx.g, ctx.slope, ctx.stable = g, slope, stable
        return out.to(feat2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat2d, raw, s, out, m = ctx.saved_tensors
        ctd, alpha, draw = _softmax_backward(
            ctx.g, ct, s, out, raw.float(), feat2d.float(), ctx.slope,
            _clip(ctx.stable), m)
        return (_per_head(alpha, ctd).to(feat2d.dtype), draw.to(raw.dtype),
                None, None, None, None)


def _d_er(infoD, draw, impl: str, dt=torch.float32):
    """d_er on destination compact rows: ``draw`` summed over the
    canonical (dst, rel) runs, contiguous in canonical order, in ``dt``
    (``pack_dt``) into ``dt``; padding compact rows map to the sentinel
    run (a zero row)."""
    red_d = _sum(draw, infoD.canon_ptr, None, impl, dt, dt)
    return gather_nodes(red_d, infoD.canon_to_row)


@spans.function
class CompactFusedGAT(torch.autograd.Function):
    """``forward(feat_c2d (UCs, H*D), el_c (UCs, H), er_c (UCd, H), g,
    slope, stable, impl) -> (N, H, D)``; ``impl`` picks the kernels or
    their plain versions on the card."""

    @staticmethod
    def forward(ctx, feat_c2d, el_c, er_c, g, slope: float, stable: str,
                impl: str):
        H = el_c.shape[1]
        el_feat_c = torch.cat([el_c, feat_c2d], dim=1).float()
        raw, feat_e = _compact_raw(el_feat_c, er_c.float(), g.compact_src,
                                   g.compact_dst, H)
        z, m = _softmax_num(g, raw, slope, stable, impl)
        s, out = _aggregate(g, z, feat_e, impl, _pack_dt(feat_c2d))
        ctx.save_for_backward(feat_c2d, el_c, er_c, s, out, m)
        ctx.g, ctx.slope, ctx.stable, ctx.impl = g, slope, stable, impl
        return out.to(feat_c2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat_c2d, el_c, er_c, s, out, m = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        infoS, infoD = g.compact_src, g.compact_dst
        H = el_c.shape[1]
        el_feat_c = torch.cat([el_c, feat_c2d], dim=1).float()
        raw, feat_e = _compact_raw(el_feat_c, er_c.float(), infoS, infoD, H)
        ctd, alpha, draw = _softmax_backward(
            g, ct, s, out, raw, feat_e, ctx.slope, _clip(ctx.stable), m)
        del feat_e
        dt = _pack_dt(feat_c2d)
        d_er_c = _d_er(infoD, draw, impl, dt)
        # source side: draw and dfeat read in compact-row order
        d_el_c, d_feat_c = _sum_heads(draw, alpha, ctd, infoS.edge_row_ptr,
                                      infoS.edge_sort_perm, impl, dt, dt)
        return (d_feat_c.to(feat_c2d.dtype), d_el_c.to(el_c.dtype),
                d_er_c.to(er_c.dtype), None, None, None, None)


@spans.function
class CompactFusedGATPacked(torch.autograd.Function):
    """``forward(fe2d (UCs, H*(1+D)), er_c (UCd, H), g, slope, stable,
    impl) -> (N, H, D)`` with per-head lanes ``[el | feat]`` in ``fe2d``.

    Two routes, picked from the inputs (:meth:`_walks`).  On f32 operands
    that the kernels launch on (CUDA tensors under ``impl="kernel"``),
    under "raw" or "clip", with D <= ``MAX_D``, three segment walks
    compute the edge terms in registers: the forward's
    (:func:`~.kernels.compact_gat_packed_fwd`, ``s`` and ``out`` over
    ``in_row_ptr``), the backward's destination walk
    (:func:`~.kernels.compact_gat_packed_bwd_dst`, ``draw`` and ``alpha``
    (EP, H)) and its source walk (:func:`~.kernels.compact_gat_packed_bwd_src`,
    ``d_fe`` over ``edge_row_ptr`` through ``edge_sort_perm``), with
    ``d_er`` the (dst, rel)-run sum of ``draw``.  Otherwise (bf16
    payloads, "max", ``impl="plain"``, CPU tensors) the chain: gathers
    and elementwise work around the segment sums, the backward summing
    ``draw`` and ``dfeat`` through ``edge_sort_perm`` and laying the
    compact rows' sums out per head as ``[d_el | d_feat]``; seven segment
    sums a layer with the compact gathers, as the split op.  Both save
    ``(fe2d, er_c, s, out, m)``."""

    @staticmethod
    def _walks(fe2d, er_c, stable: str, impl: str) -> bool:
        """Whether the op takes the three walks (the class docstring)."""
        return (stable != "max" and fe2d.dtype == torch.float32
                and er_c.dtype == torch.float32
                and fe2d.shape[1] // er_c.shape[1] - 1 <= MAX_D
                and _dispatch.launches(fe2d, impl))

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
        ctx.walks = CompactFusedGATPacked._walks(fe2d, er_c, stable, impl)
        if ctx.walks:
            fe2d, er_c = fe2d.contiguous(), er_c.contiguous()
            s, out = compact_gat_packed_fwd(
                fe2d, er_c, g.compact_src.edge_map, g.compact_dst.edge_map,
                g.in_row_ptr, slope, _clip(stable), impl=impl)
            m = None
        else:
            raw, ge = CompactFusedGATPacked._edge_rows(fe2d, er_c, g, H)
            z, m = _softmax_num(g, raw, slope, stable, impl)
            s, out = _aggregate(g, z, ge[..., 1:], impl, _pack_dt(fe2d))
        ctx.save_for_backward(fe2d, er_c, s, out, m)
        ctx.g, ctx.slope, ctx.stable, ctx.impl = g, slope, stable, impl
        return out.to(fe2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        if ctx.walks:
            return CompactFusedGATPacked._walk_backward(ctx, ct)
        fe2d, er_c, s, out, m = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        H = er_c.shape[1]
        raw, ge = CompactFusedGATPacked._edge_rows(fe2d, er_c, g, H)
        ctd, alpha, draw = _softmax_backward(
            g, ct, s, out, raw, ge[..., 1:], ctx.slope, _clip(ctx.stable), m)
        del ge
        infoS = g.compact_src
        dt = _pack_dt(fe2d)
        d_el_c, d_feat_c = _sum_heads(draw, alpha, ctd, infoS.edge_row_ptr,
                                      infoS.edge_sort_perm, impl, dt, dt)
        del ctd, alpha
        d_fe = torch.cat([d_el_c[..., None], d_feat_c.view(-1, H,
                          d_feat_c.shape[1] // H)], dim=2)
        d_fe = d_fe.view(d_fe.shape[0], -1)
        d_er_c = _d_er(g.compact_dst, draw, impl, dt)
        return (d_fe.to(fe2d.dtype), d_er_c.to(er_c.dtype),
                None, None, None, None)

    @staticmethod
    def _walk_backward(ctx, ct):
        """The backward of the walks' route: ``draw`` and ``alpha`` from
        the destination walk, ``d_fe`` from the source walk, ``d_er``
        from one segment sum of ``draw``."""
        fe2d, er_c, s, out, _ = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        infoS = g.compact_src
        ct = ct.float().contiguous()
        draw, alpha = compact_gat_packed_bwd_dst(
            fe2d, er_c, infoS.edge_map, g.compact_dst.edge_map, g.in_row_ptr,
            s, out, ct, ctx.slope, _clip(ctx.stable), impl=impl)
        d_fe = compact_gat_packed_bwd_src(draw, alpha, ct, g.dst,
                                          infoS.edge_row_ptr,
                                          infoS.edge_sort_perm, impl=impl)
        del alpha
        d_er_c = _d_er(g.compact_dst, draw, impl)
        return d_fe, d_er_c, None, None, None, None


@spans.function
class CompactWeightedAgg(torch.autograd.Function):
    """``forward(feat_c (UCs, C), w_e (EP,), g, impl) -> (N, C)``.  Saves
    the compact rows and the weights, no per-edge tensor; ``d_w`` only
    where ``w_e`` needs a gradient (het_tpu always returns it)."""

    @staticmethod
    def forward(ctx, feat_c, w_e, g, impl: str):
        feat_e = take_rows(feat_c, g.compact_src.edge_map).float()
        out = _sum(feat_e * w_e.float()[:, None], g.in_row_ptr, None, impl,
                   _pack_dt(feat_c))
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
            dt = _pack_dt(feat_c)
            d_feat = _sum(ct_e * w_e.float()[:, None], infoS.edge_row_ptr,
                          infoS.edge_sort_perm, ctx.impl, dt,
                          dt).to(feat_c.dtype)
        if ctx.needs_input_grad[1]:
            feat_e = take_rows(feat_c, infoS.edge_map).float()
            d_w = (feat_e * ct_e).sum(-1).to(w_e.dtype)
        return d_feat, d_w, None, None


@spans.op("agg")
def compact_weighted_agg(g, feat_c: torch.Tensor, w_e: torch.Tensor, *,
                         impl: str = "kernel") -> torch.Tensor:
    """``out[v] = sum_{dst(e)=v} w_e * feat_c[compact_src_row(e)]``:
    feat_c (UCs, C) on source compact rows, w_e (EP,) a weight per
    canonical edge -> (N, C).  Per-edge rows exist only between the
    compact-row gather and the segment sum."""
    if g.compact_src is None:
        raise ValueError("graph built without compact indices")
    return CompactWeightedAgg.apply(feat_c, w_e, g, impl)


@spans.op("agg")
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


@spans.function
class SrcCompactFusedSoftmaxAgg(torch.autograd.Function):
    """The softmax aggregation of source-compact features with per-edge
    logits (``_make_src_compact_fused_op``, the target of the compiler's
    ``fuse_compact_agg``):

        out[v] = sum_{dst(e)=v} softmax_v(act(raw_e)) * feat_c[rowS(e)]

    ``forward(feat_c2d (UCs, H*D), raw (EP, H), g, slope, clip, impl) ->
    (N, H, D)``: ``z`` and ``z*feat`` summed over ``in_row_ptr``
    (:func:`_aggregate`, two sums).  It saves the compact rows, the
    logits, ``s`` and ``out``, no (EP, H*D) message tensor: the backward
    gathers the rows again.  Backward: ``d_feat_c`` one segment sum of
    ``alpha*ct[dst]`` through ``edge_sort_perm`` into the source compact
    rows, ``d_raw`` elementwise (``draw``)."""

    @staticmethod
    def forward(ctx, feat_c2d, raw, g, slope: float, clip: Optional[float],
                impl: str):
        z = torch.exp(_act_apply(raw.float(), slope, clip))
        feat_e = take_rows(feat_c2d, g.compact_src.edge_map).float()
        # padding edges lie past in_row_ptr's end: never reduced
        s, out = _aggregate(g, z, feat_e, impl, _pack_dt(feat_c2d))
        ctx.save_for_backward(feat_c2d, raw, s, out)
        ctx.g, ctx.slope, ctx.clip, ctx.impl = g, slope, clip, impl
        return out.to(feat_c2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat_c2d, raw, s, out = ctx.saved_tensors
        g, infoS = ctx.g, ctx.g.compact_src
        feat_e = take_rows(feat_c2d, infoS.edge_map).float()
        ctd, alpha, draw = _softmax_backward(
            g, ct, s, out, raw.float(), feat_e, ctx.slope, ctx.clip)
        del feat_e
        dt = _pack_dt(feat_c2d)
        d_feat_c = seg_sum_sorted(_per_head(alpha, ctd, dtype=dt),
                                  infoS.edge_row_ptr, infoS.edge_sort_perm,
                                  out_dtype=dt, impl=ctx.impl)
        return (d_feat_c.to(feat_c2d.dtype), draw.to(raw.dtype), None, None,
                None, None)


@spans.op("agg")
def fused_softmax_agg_src_compact(g, feat_c: torch.Tensor,
                                  raw_e: torch.Tensor, *,
                                  act: str = "identity", slope: float = 0.2,
                                  stable: str = "raw",
                                  impl: str = "kernel") -> torch.Tensor:
    """``sum_dst softmax(act(raw)) * feat_c[rowS]``: feat_c (UCs, H, D) on
    source compact rows, raw_e (EP, H) -> (N, H, D), by
    :class:`SrcCompactFusedSoftmaxAgg` with ``act`` "leaky_relu" (of
    ``slope``) or "identity" and ``stable`` "raw" or "clip"
    (``het_tpu/ops/pallas/fused_agg.py::fused_softmax_agg_src_compact``)."""
    if act not in ("leaky_relu", "identity"):
        raise ValueError(f"act must be leaky_relu or identity, got {act!r}")
    if stable not in ("raw", "clip"):
        raise ValueError(f"stable must be raw or clip, got {stable!r}")
    if g.compact_src is None:
        raise ValueError("graph built without compact indices")
    UC, H, D = feat_c.shape
    out = SrcCompactFusedSoftmaxAgg.apply(
        feat_c.reshape(UC, H * D), raw_e, g,
        1.0 if act == "identity" else float(slope), _clip(stable), impl)
    return out.view(-1, H, D)


# ------------------------------------------------------------------- HGT


@spans.function
class HGTCompactAttention(torch.autograd.Function):
    """HGT's compact attention chain in one op
    (``_make_hgt_compact_attention_op``):

        score_e = <attq_c[rowD(e)], k[src(e)]>  (per head)
        out[v]  = sum_{dst(e)=v} softmax_v(clip(score_e * mu[rel_e]))
                  * msg_c[rowS(e)]

    ``forward(msg2d (UCs, H*dk), attq2d (UCd, H*dk), k2d (src_space,
    H*dk), mu (R, H), g, clip, impl) -> (N, H, dk)``.  The forward is the
    segment sums of ``z`` and ``z*msg`` over ``in_row_ptr`` and keeps no
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
        s, out = _aggregate(g, z, feat_e, impl, _pack_dt(msg2d))
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
        ctd, alpha, draw = _softmax_backward(
            g, ct, s, out, score * mu_e, feat_e, 1.0, ctx.clip)
        del feat_e  # the per-edge rows go as soon as they are read
        dscore = draw * mu_e
        d_mu = edge_rel_scale_grad(g, score, draw, impl=impl)
        HD = H * dk
        dt = _pack_dt(msg2d)
        # d_msg and each source compact row's part of d_k in one sum
        pay = torch.empty(ctd.shape[0], 2 * HD, dtype=dt, device=ctd.device)
        _per_head(alpha, ctd, pay[:, :HD])
        _per_head(dscore, attq_e, pay[:, HD:])
        del ctd, attq_e
        red_s = seg_sum_sorted(pay, infoS.edge_row_ptr, infoS.edge_sort_perm,
                               out_dtype=dt, impl=impl)
        del pay
        d_k = seg_sum_sorted(red_s[:, HD:].contiguous(), infoS.node_row_ptr,
                             infoS.node_sort_perm, impl=impl)
        red_d = seg_sum_sorted(_per_head(dscore, k_e, dtype=dt),
                               infoD.canon_ptr, out_dtype=dt, impl=impl)
        d_attq = gather_nodes(red_d, infoD.canon_to_row)
        return (red_s[:, :HD].to(msg2d.dtype), d_attq.to(attq2d.dtype),
                d_k.to(k2d.dtype), d_mu.to(mu.dtype), None, None, None)


def _plain_score_rows(q2d, k2d, w_att, g, H, impl):
    """HGT's per-edge score ``<q[dst] W_att[rel], k[src]>`` (n_rows, H)
    f32 on the relation-sorted edge rows of ``g.edge_rel_seg``; no (rows,
    H*dk) buffer outlives its last use (the product is taken in ``k``'s
    gathered rows)."""
    HD = q2d.shape[1]
    attq_rows = HGTPlainFull._rows(q2d, w_att, g, "dst", H, impl)[1]
    prod = gather_nodes(k2d, _edge_row_idx(g, "src")).float()
    prod.mul_(attq_rows.reshape(-1, HD))
    del attq_rows
    return prod.view(-1, H, HD // H).sum(-1)


def _plain_score_pullback(q2d, k2d, w_att, g, dscore_rows, need_q: bool,
                          need_w: bool, impl: str, dt):
    """The pullback of :func:`_plain_score_rows` from ``dscore_rows``
    (n_rows, H; zero on the padding rows), ``attq`` recomputed:
    ``(d_q, d_watt, attq_rows (n_rows, H*dk))``.  ``d_q`` is one segment
    sum over ``in_row_ptr`` through ``seg.inv`` (payload in ``dt``), None
    unless ``need_q``; ``d_watt`` None unless ``need_w``; the caller's
    ``d_k`` reads ``attq_rows``.  The cotangent is taken in ``k``'s
    gathered rows, and each (rows, H*dk) buffer is freed after its last
    use."""
    seg = g.edge_rel_seg
    H, HD = dscore_rows.shape[1], q2d.shape[1]
    q_rows, attq_rows = HGTPlainFull._rows(q2d, w_att, g, "dst", H, impl)
    d_q = d_watt = None
    if need_q or need_w:
        ct = gather_nodes(k2d, _edge_row_idx(g, "src")).float()
        n = ct.shape[0]
        ct.view(n, H, -1).mul_(dscore_rows[..., None])
        # the matmul's cotangent in its output's dtype, as het_tpu's
        # pullback takes it
        d_q_rows, d_watt = segment_matmul_pullback(
            q_rows, w_att, seg, ct.to(attq_rows.dtype),
            need_dx=need_q, need_dw=need_w, impl=impl)
        del ct, q_rows
        if need_q:
            d_q = _sum(d_q_rows.reshape(-1, HD), g.in_row_ptr, seg.inv,
                       impl, dt).to(q2d.dtype)
        del d_q_rows
    return d_q, d_watt, attq_rows.reshape(-1, HD)


@spans.function
class HGTPlainFull(torch.autograd.Function):
    """HGT's plain layer core in one op (``_make_hgt_plain_full_op``):
    both per-edge typed linears over the relation-sorted edge rows
    (``edge_rel_seg``), ``msg = v[src] W_msg[rel]`` and ``attq = q[dst]
    W_att[rel]``, the score ``<attq, k[src]>``, the typed softmax and the
    aggregation.

    ``forward(v2d, q2d, k2d (rows, H*dk), w_msg, w_att (R, H, dk, dk), mu
    (R, H), g, clip, impl) -> (N, H, dk)``.  Forward: the two matmuls on
    the edge rows (:func:`~.linear.segment_matmul`, a row's input one a
    head), one read-back of ``[score | msg]`` through ``seg.inv``, the
    segment sums of :func:`_aggregate` over ``in_row_ptr``.  It keeps the
    per-edge score (EP, H) and recomputes the matmuls in the backward,
    which takes: their pullbacks
    (:func:`~.linear.segment_matmul_pullback`), ``d_q`` as one
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
        score_rows = _plain_score_rows(q2d, k2d, w_att, g, H, impl)
        _, msg_rows = HGTPlainFull._rows(v2d, w_msg, g, "src", H, impl)
        # one read-back to canonical order serves score and msg
        se = take_rows(torch.cat([score_rows, msg_rows.reshape(-1, HD)],
                                 dim=1), seg.inv).float()
        score = se[:, :H].contiguous()
        mu_e = take_rows(mu, g.rel).float()
        z = torch.exp(_act_apply(score * mu_e, 1.0, clip))
        s, out = _aggregate(g, z, se[:, H:], impl, _pack_dt(v2d))
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
        v_rows, msg_rows = HGTPlainFull._rows(v2d, w_msg, g, "src", H, impl)
        msg_e = take_rows(msg_rows.reshape(-1, HD), seg.inv).float()
        mu_e = take_rows(mu, g.rel).float()
        ctd, alpha, draw = _softmax_backward(
            g, ct, s, out, score * mu_e, msg_e, 1.0, ctx.clip)
        d_mu = edge_rel_scale_grad(g, score, draw, impl=impl)
        # one canonical -> rows take serves dscore and dmsg
        both = take_rows(torch.cat([draw * mu_e, _per_head(alpha, ctd)],
                                   dim=1), seg.perm)
        del ctd, msg_e
        both = torch.where(seg.row_valid[:, None], both,
                           torch.zeros_like(both))
        dscore_rows = both[:, :H]
        need = ctx.needs_input_grad
        dt = _pack_dt(v2d)
        d_q, d_watt, attq_rows = _plain_score_pullback(
            q2d, k2d, w_att, g, dscore_rows, need[1], need[4], impl, dt)
        # the matmul's cotangent in its output's dtype, as het_tpu's
        # pullback takes it
        d_v_rows, d_wmsg = segment_matmul_pullback(
            v_rows, w_msg, seg, both[:, H:].to(msg_rows.dtype),
            need_dx=need[0], need_dw=need[3], impl=impl)
        d_k = d_v = None
        if need[0] or need[2]:
            # d_k and d_v share one source-sorted reduce of the rows
            pay = torch.empty(both.shape[0], 2 * HD if need[0] else HD,
                              dtype=dt, device=both.device)
            _per_head(dscore_rows, attq_rows.float(), pay[:, :HD])
            if need[0]:
                pay[:, HD:] = d_v_rows.reshape(-1, HD)
            red = seg_sum_sorted(pay, g.out_row_ptr,
                                 take_rows(seg.inv, g.out_perm), impl=impl)
            d_k = red[:, :HD].to(k2d.dtype)
            if need[0]:
                d_v = red[:, HD:].to(v2d.dtype)
        return (d_v, d_q, d_k, d_wmsg, d_watt, d_mu.to(mu.dtype), None,
                None, None)


@spans.function
class HGTPlainAttention(torch.autograd.Function):
    """HGT's plain attention in one op (``_make_hgt_plain_attention_op``):
    :class:`HGTPlainFull` without the message transform, the messages
    given per edge in canonical order.

    ``forward(msg2d (EP, H*dk), q2d (N, H*dk), k2d (src_space, H*dk),
    w_att (R, H, dk, dk), mu (R, H), g, clip, impl) -> (N, H, dk)``.
    Forward: ``attq = q[dst] W_att[rel]`` on the relation-sorted edge rows
    (:func:`~.linear.segment_matmul`), the score ``<attq, k[src]>`` read
    back to canonical order through ``seg.inv``, ``z = exp(act(score *
    mu[rel]))`` and the segment sums of :func:`_aggregate` over
    ``in_row_ptr``.  It keeps the per-edge score (EP, H) and recomputes
    ``attq`` in the backward, which takes ``d_msg = alpha * ctd``
    elementwise, ``d_mu`` as in :class:`HGTCompactAttention`, the
    matmul's pullback (:func:`~.linear.segment_matmul_pullback`) on
    ``dscore`` taken to the rows through ``seg.perm``, ``d_q`` as one
    segment sum over ``in_row_ptr`` through ``seg.inv`` and ``d_k`` as
    one over ``out_row_ptr`` through ``seg.inv[out_perm]``; each only
    where its input needs it.

    ``LAUNCHES``: a forward and a backward into all five inputs launch,
    on host relation offsets, the segment sums of ``z`` and ``z*msg``,
    ``d_q`` and ``d_k`` and the grouped dW of ``d_mu``; where the offsets
    live on the card only (a shard), also the per-head matmul's forward
    and its recompute in the backward, its dX and its dW."""

    LAUNCHES = {
        "host": {"seg_sum_sorted": 4, "segment_matmul_dw": 1},
        "device": {"seg_sum_sorted": 4, "segment_matmul_dw": 2,
                   "segment_matmul_fwd": 2, "segment_matmul_dx": 1},
    }

    @staticmethod
    def forward(ctx, msg2d, q2d, k2d, w_att, mu, g, clip: Optional[float],
                impl: str):
        seg = g.edge_rel_seg
        H = mu.shape[1]
        score = take_rows(_plain_score_rows(q2d, k2d, w_att, g, H, impl),
                          seg.inv).float()
        mu_e = take_rows(mu, g.rel).float()
        z = torch.exp(_act_apply(score * mu_e, 1.0, clip))
        s, out = _aggregate(g, z, msg2d, impl, _pack_dt(msg2d))
        ctx.save_for_backward(msg2d, q2d, k2d, w_att, mu, score, s, out)
        ctx.g, ctx.clip, ctx.impl = g, clip, impl
        return out.to(msg2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        msg2d, q2d, k2d, w_att, mu, score, s, out = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        seg = g.edge_rel_seg
        need = ctx.needs_input_grad
        mu_e = take_rows(mu, g.rel).float()
        ctd, alpha, draw = _softmax_backward(
            g, ct, s, out, score * mu_e, msg2d, 1.0, ctx.clip)
        d_msg = _per_head(alpha, ctd).to(msg2d.dtype) if need[0] else None
        del ctd
        d_mu = (edge_rel_scale_grad(g, score, draw, impl=impl).to(mu.dtype)
                if need[4] else None)
        d_q = d_k = d_watt = None
        if need[1] or need[2] or need[3]:
            dscore_rows = take_rows(draw * mu_e, seg.perm)
            dscore_rows = torch.where(seg.row_valid[:, None], dscore_rows,
                                      torch.zeros_like(dscore_rows))
            dt = _pack_dt(msg2d)
            d_q, d_watt, attq_rows = _plain_score_pullback(
                q2d, k2d, w_att, g, dscore_rows, need[1], need[3], impl, dt)
            if need[2]:
                d_k = seg_sum_sorted(
                    _per_head(dscore_rows, attq_rows.float(), dtype=dt),
                    g.out_row_ptr, take_rows(seg.inv, g.out_perm),
                    impl=impl).to(k2d.dtype)
        return d_msg, d_q, d_k, d_watt, d_mu, None, None, None


# ------------------------------------------------------------------- GAT


def _node_logits(el, er, g):
    """Per-edge ``raw = el[src] + er[dst]`` (EP, H) in canonical order;
    padding edges read the sentinel rows (zeros), and no sum reads them."""
    return gather_nodes(el, g.src).float() + gather_nodes(er, g.dst).float()


def _node_fused_forward(feat2d, el, er, g, slope, clip, impl, dt):
    """The node-sided forward: ``z = exp(act(el[src] + er[dst]))``, then
    :func:`_aggregate` (payloads in ``dt``).  Returns ``(feat[src] (EP,
    H*D), s, out)``, out (N, H, D)."""
    z = torch.exp(_act_apply(_node_logits(el, er, g), slope, clip))
    feat_e = gather_nodes(feat2d, g.src).float()
    return (feat_e,) + _aggregate(g, z, feat_e, impl, dt)


def _node_fused_backward(ct, feat_e, el, er, s, out, g, slope, clip, impl,
                         dt):
    """The node-sided backward from ``feat[src]`` and the saved ``(s,
    out)``: ``z`` and ``act'`` recomputed, ``d_er`` the segment sum of
    ``draw`` over ``in_row_ptr`` (into f32), and ``draw`` and ``dfeat``
    summed over ``out_row_ptr`` through ``out_perm`` into the sources
    (``d_el``, ``d_feat``, into ``dt``), every payload in ``dt``.  ``ct``
    is (N, H*D); returns ``(d_feat (S, H*D), d_el (S, H), d_er (N,
    H))``."""
    H = el.shape[1]
    ctd, alpha, draw = _softmax_backward(
        g, ct.reshape(-1, H, feat_e.shape[1] // H), s, out,
        _node_logits(el, er, g), feat_e, slope, clip)
    d_er = _sum(draw, g.in_row_ptr, None, impl, dt)
    d_el, d_feat = _sum_heads(draw, alpha, ctd, g.out_row_ptr, g.out_perm,
                              impl, dt, dt)
    return d_feat, d_el, d_er


@spans.function
class NodeFusedGAT(torch.autograd.Function):
    """Homogeneous GAT's fused softmax aggregation with node-sided inputs
    (``_make_node_fused_op``):

        out[v] = sum_{dst(e)=v} softmax_v(act(el[src(e)] + er[dst(e)]))
                 * feat[src(e)]

    ``forward(feat2d (S, H*D) head-major, el (S, H), er (N, H), g, slope,
    clip, impl) -> (N, H*D)``.  The forward sums over ``in_row_ptr`` and
    saves ``(feat2d, el, er, s, out)``, no per-edge tensor, as het_tpu;
    the backward (:func:`_node_fused_backward`) gathers ``feat[src]``
    again and reduces the source side over the graph's source CSR, not
    over compact metadata."""

    @staticmethod
    def forward(ctx, feat2d, el, er, g, slope: float,
                clip: Optional[float], impl: str):
        _, s, out = _node_fused_forward(feat2d, el, er, g, slope, clip,
                                        impl, _pack_dt(feat2d))
        ctx.save_for_backward(feat2d, el, er, s, out)
        ctx.g, ctx.slope, ctx.clip, ctx.impl = g, slope, clip, impl
        return out.reshape(out.shape[0], -1).to(feat2d.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat2d, el, er, s, out = ctx.saved_tensors
        g = ctx.g
        d_feat, d_el, d_er = _node_fused_backward(
            ct, gather_nodes(feat2d, g.src).float(), el, er, s, out, g,
            ctx.slope, ctx.clip, ctx.impl, _pack_dt(feat2d))
        return (d_feat.to(feat2d.dtype), d_el.to(el.dtype),
                d_er.to(er.dtype), None, None, None, None)


@spans.function
class GATLayerFused(torch.autograd.Function):
    """Homogeneous GAT's layer core in one op (``_make_gat_layer_op``): the
    projection ``feat = x W``, the logits ``el = <feat, attn_l>`` and ``er
    = <feat, attn_r>`` a head, the softmax and the aggregation of
    :class:`NodeFusedGAT`.

    ``forward(x2d (N, F), w (F, H*D), attn_l, attn_r (H, D), g, slope,
    clip, impl) -> (N, H*D)``, for a graph whose source space is its
    destinations.  It saves ``x2d``, the parameters, ``feat[src]`` (EP,
    H*D) and ``(s, out)``, and recomputes the projection (a node-scale
    matmul) in the backward, which takes :func:`_node_fused_backward`'s
    sums and pulls ``d_feat`` and the logits' gradients back through the
    projection at node scale: ``dx = d_feat' W^T``, ``dW = x^T d_feat'``
    with ``d_feat' = d_feat + d_el attn_l + d_er attn_r`` a head.

    Two choices differ from het_tpu's, each measured on the card at GAT's
    widths (PERF.md's GAT findings): het_tpu reassociates the backward (dW
    one contraction over the edges, dx a head-mixed F-lane payload) to keep
    wide payloads out of its source-side passes, which is slower here; and
    it gathers
    ``feat[src]`` again above 512 MB, where saving it is faster here and
    leaves the step's peak as it was (the backward holds those rows
    either way)."""

    @staticmethod
    def _node_terms(x2d, w, attn_l, attn_r):
        """``feat`` (N, H, D) and the logits ``el``, ``er`` (N, H)."""
        H, D = attn_l.shape
        f3 = (x2d.float() @ w.float()).view(-1, H, D)
        return (f3, (f3 * attn_l.float()).sum(-1),
                (f3 * attn_r.float()).sum(-1))

    @staticmethod
    def forward(ctx, x2d, w, attn_l, attn_r, g, slope: float,
                clip: Optional[float], impl: str):
        f3, el, er = GATLayerFused._node_terms(x2d, w, attn_l, attn_r)
        feat_e, s, out = _node_fused_forward(f3.view(f3.shape[0], -1), el,
                                             er, g, slope, clip, impl,
                                             _pack_dt(x2d))
        ctx.save_for_backward(x2d, w, attn_l, attn_r, feat_e, s, out)
        ctx.g, ctx.slope, ctx.clip, ctx.impl = g, slope, clip, impl
        return out.reshape(out.shape[0], -1).to(x2d.dtype)

    @staticmethod
    def _pullback(x2d, w, attn_l, attn_r, f3, d_feat, d_el, d_er):
        """The gradients of ``(x2d, w, attn_l, attn_r)`` from those of
        ``feat`` (N, H*D), ``el`` and ``er`` (N, H), at node scale."""
        n, H, D = f3.shape
        d_f3 = (d_feat.view(n, H, D) + d_el[..., None] * attn_l.float()
                + d_er[..., None] * attn_r.float())
        d_al = (d_el[..., None] * f3).sum(0)
        d_ar = (d_er[..., None] * f3).sum(0)
        d_f2 = d_f3.view(n, H * D)
        dx = d_f2 @ w.float().t()
        dw = x2d.float().t() @ d_f2
        return (dx.to(x2d.dtype), dw.to(w.dtype), d_al.to(attn_l.dtype),
                d_ar.to(attn_r.dtype), None, None, None, None)

    @staticmethod
    def backward(ctx, ct):
        x2d, w, attn_l, attn_r, feat_e, s, out = ctx.saved_tensors
        f3, el, er = GATLayerFused._node_terms(x2d, w, attn_l, attn_r)
        d_feat, d_el, d_er = _node_fused_backward(
            ct, feat_e, el, er, s, out, ctx.g, ctx.slope, ctx.clip,
            ctx.impl, _pack_dt(x2d))
        return GATLayerFused._pullback(x2d, w, attn_l, attn_r, f3, d_feat,
                                       d_el, d_er)


# ------------------------------------------------------------ Simple-HGN

HGN_BLOCK_BYTES = 4_000_000_000  # a block's (edges, H*D) f32 payload


def hgn_block_edges(width: int) -> int:
    """Edges a block of :class:`NodeFusedHGNAttention` holds by default at
    ``width`` = H*D lanes: a (block, H*D) f32 payload of at most
    :data:`HGN_BLOCK_BYTES`."""
    return max(1, HGN_BLOCK_BYTES // (4 * width))


def _hgn_edges(el, er, ee, g, lo: int, hi: int, slope: float, clip):
    """Canonical edges ``lo:hi``: their sources, destinations, ``raw =
    el[src] + er[dst] + ee[rel]`` and ``z = exp(act(raw))`` (B, H)."""
    src, dst = g.src[lo:hi], g.dst[lo:hi]
    raw = take_rows(el, src) + take_rows(er, dst) + take_rows(ee, g.rel[lo:hi])
    return src, dst, raw, torch.exp(_act_apply(raw, slope, clip))


def _hgn_self(el, er, ee, v0: int, v1: int, slope: float, clip):
    """The self-loops of nodes ``v0:v1`` (edge type the table's last
    row): their ``raw`` and ``z`` (nb, H)."""
    raw = el[v0:v1] + er[v0:v1] + ee[-1]
    return raw, torch.exp(_act_apply(raw, slope, clip))


def _hgn_mix(alpha, prev, beta: float):
    """Residual attention, ``(1 - beta) alpha + beta prev``, under its own
    span; ``alpha`` where there is no ``prev``."""
    if prev is None:
        return alpha
    with spans.inner("res_attn"):
        return alpha * (1 - beta) + prev * beta


def hgn_bytes(num_edges: int, N: int, H: int, HD: int, num_rels: int,
              keep: bool, prev: bool) -> int:
    """A call's least bytes, forward and backward (f32): each edge's
    (self-loops' too) source row read once and each output row written
    once; then each edge's source row and destination cotangent row read
    once and each source gradient written once; the node tables (``el``
    and ``er`` read twice, ``s`` written and read, ``d_el`` and ``d_er``
    written), the edge-type table (read twice, its gradient written) and
    the attention carried out (``keep``, written) or in (``prev``, read
    forward and backward), (E + N, H) each."""
    E1 = num_edges + N
    tables = 8 * N * H + 3 * (num_rels + 1) * H
    carried = E1 * H * (int(keep) + 2 * int(prev))
    return 4 * (3 * E1 * HD + 2 * N * HD + tables + carried)


@spans.function
class NodeFusedHGNAttention(torch.autograd.Function):
    """Simple-HGN's attention and aggregation (HGB's ``myGATConv``) with
    node-sided inputs and a self-loop a node:

        raw_e  = el[src] + er[dst] + ee[rel]   (a self-loop: el[v] + er[v]
                                                + ee[R], R = num_rels)
        a_e    = softmax_v(act(raw))           over v's in-edges and its
                                                self-loop
        m_e    = (1 - beta) a_e + beta prev_e  (prev given), else a_e
        out[v] = sum_{dst(e)=v} m_e feat[src(e)] + m_self feat[v]

    ``forward(feat (N, H*D) head-major, el, er (N, H), ee (R+1, H), prev
    (EP+N, H) or None, g, beta, slope, clip, keep, dst_blocks,
    src_blocks, impl) -> (out (N, H*D), alpha)``: ``alpha`` (EP+N, H)
    holds ``m`` (canonical edges, then the self-loops; 0 on padding
    edges) where ``keep``, else nothing; it carries no gradient, and
    ``prev`` gets none (HGB detaches both).

    The self-loop is a term of each destination's softmax, not an edge
    of the graph.  The edges are walked in node-aligned blocks
    (``graph/blocks.py``): destination blocks over ``in_row_ptr`` for the
    forward's sums and the backward's destination side, source blocks
    over ``out_row_ptr`` through ``out_perm`` for ``d_feat``; no per-edge
    tensor holds more than a block's edges of H*D lanes.  The forward
    saves ``(feat, el, er, ee, s, prev)``, ``s`` the denominators (N, H),
    and the backward recomputes the edge terms from them:

        t1_e    = <feat[src], ct[dst]>,   T_v = sum_{e -> v} a_e t1_e
        draw_e  = (1 - beta) a_e (t1_e - T_v) act'(raw_e)   (no prev: 1)
        d_feat  = sum over sources of m_e ct[dst]; d_er, d_el the sums of
                  draw at destinations and sources; d_ee its sum a
                  relation (the self-loops' into row R)

    Every per-edge payload is f32 and summed by ``seg_sum_sorted``."""

    @staticmethod
    def forward(ctx, feat, el, er, ee, prev, g, beta: float, slope: float,
                clip: Optional[float], keep: bool, dst_blocks, src_blocks,
                impl: str):
        N, HD = feat.shape
        H = el.shape[1]
        EP = g.num_padded_edges
        f = feat.float()
        el_, er_, ee_ = el.float(), er.float(), ee.float()
        out = torch.empty(N, HD, device=feat.device)
        s = torch.empty(N, H, device=feat.device)
        alpha = torch.zeros((EP + N) if keep else 0, H, device=feat.device)
        for v0, v1, lo, hi in dst_blocks:
            ptr = g.in_row_ptr[v0:v1 + 1] - lo
            src, dst, _, z = _hgn_edges(el_, er_, ee_, g, lo, hi, slope, clip)
            _, z_s = _hgn_self(el_, er_, ee_, v0, v1, slope, clip)
            s_b = _sum(z, ptr, None, impl, torch.float32) + z_s
            m = _hgn_mix(z / take_rows(s_b, dst - v0),
                         None if prev is None else prev[lo:hi], beta)
            m_s = _hgn_mix(z_s / s_b, None if prev is None
                           else prev[EP + v0:EP + v1], beta)
            if keep:
                with spans.inner("res_attn"):
                    alpha[lo:hi] = m
                    alpha[EP + v0:EP + v1] = m_s
            rows = take_rows(f, src).view(hi - lo, H, -1)
            rows.mul_(m[..., None])
            agg = _sum(rows.view(hi - lo, HD), ptr, None, impl,
                       torch.float32)
            del rows
            nb = v1 - v0
            torch.addcmul(agg.view(nb, H, -1), m_s[..., None],
                          f[v0:v1].view(nb, H, -1),
                          out=out[v0:v1].view(nb, H, -1))
            s[v0:v1] = s_b
        ctx.save_for_backward(feat, el, er, ee, s, prev)
        ctx.g, ctx.beta, ctx.slope, ctx.clip, ctx.impl = (g, beta, slope,
                                                          clip, impl)
        ctx.blocks = (dst_blocks, src_blocks)
        ctx.mark_non_differentiable(alpha)
        return out.to(feat.dtype), alpha

    @staticmethod
    def backward(ctx, ct, _ct_alpha):
        feat, el, er, ee, s, prev = ctx.saved_tensors
        g, beta, slope, clip, impl = (ctx.g, ctx.beta, ctx.slope, ctx.clip,
                                      ctx.impl)
        dst_blocks, src_blocks = ctx.blocks
        N, HD = feat.shape
        H = el.shape[1]
        EP = g.num_padded_edges
        dev = feat.device
        f, c = feat.float(), ct.float().contiguous()
        el_, er_, ee_ = el.float(), er.float(), ee.float()
        draw, m = torch.zeros(EP, H, device=dev), torch.zeros(EP, H,
                                                              device=dev)
        draw_s, m_s = torch.empty(N, H, device=dev), torch.empty(N, H,
                                                                 device=dev)
        d_er = torch.empty(N, H, device=dev)
        # destination side: the softmax's backward a block
        for v0, v1, lo, hi in dst_blocks:
            nb = v1 - v0
            ptr = g.in_row_ptr[v0:v1 + 1] - lo
            src, dst, raw, z = _hgn_edges(el_, er_, ee_, g, lo, hi, slope,
                                          clip)
            raw_s, z_s = _hgn_self(el_, er_, ee_, v0, v1, slope, clip)
            local = dst - v0
            a = z / take_rows(s[v0:v1], local)
            a_s = z_s / s[v0:v1]
            m[lo:hi] = _hgn_mix(a, None if prev is None else prev[lo:hi],
                                beta)
            m_s[v0:v1] = _hgn_mix(a_s, None if prev is None
                                  else prev[EP + v0:EP + v1], beta)
            rows = take_rows(f, src)
            rows.mul_(take_rows(c, dst))
            t1 = rows.view(hi - lo, H, -1).sum(-1)
            del rows
            t1_s = (f[v0:v1].view(nb, H, -1)
                    * c[v0:v1].view(nb, H, -1)).sum(-1)
            T = _sum(a * t1, ptr, None, impl, torch.float32) + a_s * t1_s
            dr = a * (t1 - take_rows(T, local)) * _act_deriv(raw, slope, clip)
            dr_s = a_s * (t1_s - T) * _act_deriv(raw_s, slope, clip)
            if prev is not None:
                with spans.inner("res_attn"):
                    dr, dr_s = dr * (1 - beta), dr_s * (1 - beta)
            draw[lo:hi], draw_s[v0:v1] = dr, dr_s
            d_er[v0:v1] = _sum(dr, ptr, None, impl, torch.float32) + dr_s
        # source side: d_feat a block, through out_perm
        d_feat = torch.empty(N, HD, device=dev)
        for u0, u1, lo, hi in src_blocks:
            nb = u1 - u0
            pos = g.out_perm[lo:hi]
            rows = take_rows(c, take_rows(g.dst, pos)).view(hi - lo, H, -1)
            rows.mul_(take_rows(m, pos)[..., None])
            agg = _sum(rows.view(hi - lo, HD), g.out_row_ptr[u0:u1 + 1] - lo,
                       None, impl, torch.float32)
            del rows
            torch.addcmul(agg.view(nb, H, -1), m_s[u0:u1, :, None],
                          c[u0:u1].view(nb, H, -1),
                          out=d_feat[u0:u1].view(nb, H, -1))
        d_el = _sum(draw, g.out_row_ptr, g.out_perm, impl,
                    torch.float32) + draw_s
        d_ee = torch.cat([_sum_rel(g, draw, impl), draw_s.sum(0)[None]])
        return (d_feat.to(feat.dtype), d_el.to(el.dtype), d_er.to(er.dtype),
                d_ee.to(ee.dtype)) + (None,) * 9


@spans.op("agg")
def simple_hgn_attention(g, feat: torch.Tensor, el: torch.Tensor,
                         er: torch.Tensor, ee: torch.Tensor,
                         alpha_prev: Optional[torch.Tensor] = None, *,
                         beta: float = 0.0, slope: float,
                         stable: str = "clip", keep_alpha: bool = False,
                         impl: str = "kernel"):
    """Simple-HGN's fused attention and aggregation
    (:class:`NodeFusedHGNAttention`) on a graph whose sources are its
    destinations: feat (N, H*D), el and er (N, H), ee (num_rels + 1, H),
    ``alpha_prev`` (EP + N, H) the previous layer's attention (detached)
    or None.  Returns ``out`` (N, H*D) and, where ``keep_alpha``, this
    layer's attention for the next (EP + N, H), else None.  ``stable`` is
    "clip" or "raw".  A block holds :func:`hgn_block_edges` edges, a
    payload of at most :data:`HGN_BLOCK_BYTES`.  The span counts the
    call's blocks a side, its least bytes (:func:`hgn_bytes`) and the
    bytes of the attention it carries to the next layer, which it carries
    whole (``alpha_carried_bytes``), not recomputed from node tables."""
    N, HD = feat.shape
    H = el.shape[1]
    EP = g.num_padded_edges
    if stable not in ("raw", "clip"):
        raise ValueError(f"stable must be 'raw' or 'clip', got {stable!r}")
    if N != g.num_nodes or g.src_space != N:
        raise ValueError("the self-loops need node-sided inputs on a graph "
                         "whose sources are its destinations")
    if tuple(ee.shape) != (g.num_rels + 1, H) or HD % H:
        raise ValueError(f"ee {tuple(ee.shape)} is not (num_rels + 1, "
                         f"{H}), or feat's {HD} lanes are not H heads")
    if alpha_prev is not None and tuple(alpha_prev.shape) != (EP + N, H):
        raise ValueError(f"alpha_prev {tuple(alpha_prev.shape)} is not "
                         f"({EP + N}, {H})")
    n = hgn_block_edges(HD)
    dst_blocks = graph_blocks(g, "dst", n)
    src_blocks = graph_blocks(g, "src", n)
    spans.count(dst_blocks=len(dst_blocks), src_blocks=len(src_blocks),
                bytes=hgn_bytes(g.num_edges, N, H, HD, g.num_rels,
                                keep_alpha, alpha_prev is not None),
                alpha_carried_bytes=4 * (EP + N) * H if keep_alpha else 0)
    out, alpha = NodeFusedHGNAttention.apply(
        feat, el, er, ee,
        None if alpha_prev is None else alpha_prev.detach(), g, beta, slope,
        _clip(stable), keep_alpha, dst_blocks, src_blocks, impl)
    return out, (alpha if keep_alpha else None)
