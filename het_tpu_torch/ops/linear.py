"""Relation-typed linears and relation-typed inner products.

Counterpart of ``het_tpu/ops/linear.py``:

* :func:`segment_matmul` multiplies each relation's rows by that
  relation's weight, from one input row for every head or one a head
  (HGT's per-head inputs): one dense matmul per relation over the row
  slice ``seg_ptrs_static[r]:seg_ptrs_static[r+1]`` (batched over the
  heads) where the offsets are known on the host (the JAX package's
  static-mix plan, ``segment_matmul_static_mix``; there too the matmul is
  left to the compiler's library, here ``torch.matmul``), the
  segment-matmul kernels where they live only on the device (a shard of
  a partitioned graph); :func:`segment_matmul_pullback` is its backward
  for ops that recompute the matmul;
* :func:`ntype_linear` is the per-node-type linear over ``ntype_seg``,
  whose gathers in and out are injective: both backwards are masked
  gathers;
* :func:`compact_typed_linear` gathers node rows into the unique
  (relation, node) compact rows and applies :func:`segment_matmul`.  The
  gather's backward is the sorted segment sum over ``node_row_ptr`` with
  ``node_sort_perm``, as ``_compact_gather`` has it;
* :func:`edge_typed_linear` does the same per edge: node rows gathered
  into the relation-sorted edge rows (``edge_rel_seg``), multiplied, and
  read back in canonical edge order.  The gather's backward is a sorted
  segment sum over the source or destination CSR, reading the cotangent
  rows through a permutation, as ``_make_edge_row_gather`` has it;
* :func:`expand_compact` reads compact rows per edge (its backward the
  sorted segment sum through ``edge_sort_perm``), and
  :func:`compact_dst_inner` is HGT's single-sided compact score, whose
  backward sums over the canonical (dst, rel) runs and the source-sorted
  edges;
* :func:`edge_rel_inner` and :func:`segment_rel_inner` are the
  attention-logit inner products ``<feat[h], a[rel, h]>``; their ``a``
  gradient is the grouped dW kernel (``kernels.segment_matmul_dw``);
* :func:`node_linear`, :func:`attention_projection` and
  :func:`edge_type_logits` are Simple-HGN's node-level linears (no
  counterpart in the JAX package): plain matmuls under ``linear:`` spans.

``impl`` ("kernel" or "plain") picks the version of every kernel an op
runs; see ``kernels/_dispatch.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..utils import spans
from .common import (gather_nodes, gather_rows_injective, sorted_gather,
                     take_rows, take_rows_injective)
from .kernels import (seg_sum_sorted, segment_matmul_dw, segment_matmul_dx,
                      segment_matmul_fwd)


def _flat_weight(w_r: torch.Tensor) -> torch.Tensor:
    """(H, K, O) -> (K, H*O), head-major output columns."""
    H, K, O = w_r.shape
    return w_r.permute(1, 0, 2).reshape(K, H * O)


def _as_heads(x_rows: torch.Tensor, H: int) -> torch.Tensor:
    """(n_rows, K) or (n_rows, Hx, K) -> (n_rows, Hx, K), Hx in {1, H}."""
    x3 = x_rows[:, None, :] if x_rows.dim() == 2 else x_rows
    if x3.dim() != 3 or x3.shape[1] not in (1, H):
        raise ValueError(f"x_rows {tuple(x_rows.shape)} is not (n_rows, K) "
                         f"or (n_rows, Hx, K) with Hx in (1, {H})")
    return x3


def _static_fwd(x3, w, ptrs):
    """Forward on host-known offsets: one ``torch.matmul`` a relation over
    its row slice, batched over the heads where x has a row a head.  The
    output takes x's dtype; x and w of two dtypes (an f32 activation
    against a bf16 weight) are multiplied in f32, as JAX promotes them
    (``_static_mix_fwd_impl``)."""
    S, H, _, O = w.shape
    Hx = x3.shape[1]
    y_dtype = x3.dtype
    if w.dtype != x3.dtype:
        x3, w = x3.float(), w.float()
    # the slices tile [0, n_rows) exactly, so every row is written
    y = x3.new_empty(x3.shape[0], H, O)
    for r in range(S):
        lo, hi = ptrs[r], ptrs[r + 1]
        if hi == lo:
            continue
        if Hx == 1:
            torch.matmul(x3[lo:hi, 0], _flat_weight(w[r]),
                         out=y[lo:hi].view(hi - lo, H * O))
        else:  # (H, n, K) @ (H, K, O)
            y[lo:hi] = torch.matmul(x3[lo:hi].transpose(0, 1),
                                    w[r]).transpose(0, 1)
    return y.to(y_dtype)


def _static_bwd(x3, w, ptrs, ct, need_dx: bool, need_dw: bool):
    """The pullback of :func:`_static_fwd` for an f32 cotangent: each
    slice's dx into its disjoint rows and dW per relation, both f32
    (``_static_mix_bwd_impl``, whose mixed bf16 x f32 products promote
    to f32)."""
    S, H, K, O = w.shape
    Hx = x3.shape[1]
    x3, w = x3.float(), w.float()
    dx = torch.empty_like(x3) if need_dx else None
    dw = torch.zeros_like(w) if need_dw else None
    for r in range(S):
        lo, hi = ptrs[r], ptrs[r + 1]
        if hi == lo:
            continue
        cs = ct[lo:hi]  # (n, H, O)
        if Hx == 1:
            c2 = cs.reshape(hi - lo, H * O)
            if dx is not None:
                torch.matmul(c2, _flat_weight(w[r]).t(), out=dx[lo:hi, 0])
            if dw is not None:
                dw[r] = (x3[lo:hi, 0].t() @ c2).view(K, H, O).permute(1, 0, 2)
        else:
            ch = cs.transpose(0, 1)  # (H, n, O)
            if dx is not None:
                dx[lo:hi] = torch.matmul(ch, w[r].transpose(1, 2)
                                         ).transpose(0, 1)
            if dw is not None:
                # one (H*K, H*O) product over the rows, its diagonal blocks
                # kept: cuBLAS splits the long reduction of this shape,
                # where a batch of (K, n) @ (n, O), one small tile a head,
                # ran 100x slower on the card
                full = x3[lo:hi].reshape(hi - lo, H * K).t() @ cs.reshape(
                    hi - lo, H * O)
                dw[r] = full.view(H, K, H, O).diagonal(
                    dim1=0, dim2=2).permute(2, 0, 1)
    return dx, dw


def _rows_fwd(x3, w, seg, impl: str):
    """Forward on device-only offsets: the segment-matmul kernel, x read
    as (n_rows, Hx*K)."""
    x2 = x3.reshape(x3.shape[0], -1).contiguous()
    return segment_matmul_fwd(x2, w.contiguous(), seg, impl=impl)


def _rows_bwd(x3, w, seg, ct, need_dx: bool, need_dw: bool, impl: str):
    """The pullback of :func:`_rows_fwd`: the dX kernel (per head where x
    has a row a head) and the grouped dW kernel."""
    n, Hx, K = x3.shape
    ct2 = ct.reshape(n, -1).float().contiguous()
    w = w.contiguous()
    dx = dw = None
    if need_dx:
        dx = segment_matmul_dx(ct2, w, seg, Hx, impl=impl).view(n, Hx, K)
    if need_dw:
        dw = segment_matmul_dw(x3.reshape(n, Hx * K).contiguous(), ct2,
                               tuple(w.shape), seg, impl=impl)
    return dx, dw


def segment_matmul_pullback(x_rows: torch.Tensor, w: torch.Tensor, seg,
                            ct: torch.Tensor, *, need_dx: bool = True,
                            need_dw: bool = True, impl: str = "kernel"
                            ) -> Tuple[Optional[torch.Tensor],
                                       Optional[torch.Tensor]]:
    """``(dx, dW)`` of :func:`segment_matmul` at ``(x_rows, w)`` for the
    cotangent ``ct`` (n_rows, H, O): dx in ``x_rows``' shape, dW f32;
    None where not asked.  For ops that recompute a matmul in their own
    backward (``jax.vjp``'s role)."""
    x3 = _as_heads(x_rows, w.shape[1])
    ct = ct.reshape(x3.shape[0], w.shape[1], w.shape[3]).float()
    if seg.seg_ptrs_static is None:
        dx, dw = _rows_bwd(x3, w, seg, ct, need_dx, need_dw, impl)
    else:
        dx, dw = _static_bwd(x3, w, seg.seg_ptrs_static, ct, need_dx,
                             need_dw)
    if dx is not None:
        dx = dx.view(x_rows.shape).to(x_rows.dtype)
    return dx, (dw.to(w.dtype) if dw is not None else None)


@spans.function
class _SegmentMatmul(torch.autograd.Function):
    """Per-segment matmul: per-relation ``torch.matmul`` over host-known
    row slices, or the segment-matmul kernels where the offsets live only
    on the device (a shard of a partitioned graph, as
    ``segment_matmul_rows_pallas`` has them); dX only where the input
    needs a gradient."""

    @staticmethod
    def forward(ctx, x_rows, w, seg, impl: str):
        x3 = _as_heads(x_rows, w.shape[1])
        ctx.save_for_backward(x_rows, w)
        ctx.seg, ctx.impl = seg, impl
        if seg.seg_ptrs_static is None:
            return _rows_fwd(x3, w, seg, impl)
        return _static_fwd(x3, w, seg.seg_ptrs_static)

    @staticmethod
    def backward(ctx, ct):
        x_rows, w = ctx.saved_tensors
        dx, dw = segment_matmul_pullback(
            x_rows, w, ctx.seg, ct, need_dx=ctx.needs_input_grad[0],
            need_dw=ctx.needs_input_grad[1], impl=ctx.impl)
        return dx, dw, None, None


@spans.op("linear")
def segment_matmul(x_rows: torch.Tensor, w: torch.Tensor, seg, *,
                   impl: str = "kernel") -> torch.Tensor:
    """x_rows (n_rows, K), or (n_rows, Hx, K) with Hx in {1, H} (one row
    for every head, or one a head), of the segment row space; w (S, H, K,
    O) -> (n_rows, H, O): row ``i`` of segment ``s`` times ``w[s]``.

    Dispatches as the JAX package's pallas backend does: host-known
    offsets take the per-relation ``torch.matmul`` slices; offsets that
    live only on the device (``seg_ptrs_static is None``) take the
    segment-matmul kernels, which read them there and read Hx from x's
    width."""
    if seg.n_rows != x_rows.shape[0]:
        raise ValueError("x_rows does not span the segment row space")
    return _SegmentMatmul.apply(x_rows, w, seg, impl)


OFFSETS = ("host", "device")


def _offsets(seg, offsets: str):
    """``seg`` as a typed linear's matmul reads it: with its host offsets
    (one ``torch.matmul`` a relation) where ``offsets`` is "host" and it
    has them, on the device only (the segment-matmul kernels, one launch
    over all relations, as on a shard) where ``offsets`` is "device"."""
    if offsets not in OFFSETS:
        raise ValueError(f"offsets must be one of {OFFSETS}, got {offsets!r}")
    if offsets == "device" and seg.seg_ptrs_static is not None:
        return dataclasses.replace(seg, seg_ptrs_static=None)
    return seg


@spans.op("linear")
def ntype_linear(g, x: torch.Tensor, w: torch.Tensor, *,
                 impl: str = "kernel") -> torch.Tensor:
    """Per-node-type linear ``y_n = x[n] @ W[ntype(n)]``: x (N, K), w (T,
    H, K, O) -> (N, H, O) at node rows.  The rows are arranged into
    ``g.ntype_seg`` by an injective gather and read back by another, whose
    transposes are masked gathers: no scatter either way
    (``het_tpu/ops/linear.py::ntype_linear``)."""
    seg = g.ntype_seg
    if x.shape[0] != seg.n_src:
        raise ValueError(f"x has {x.shape[0]} rows, the graph's node types "
                         f"{seg.n_src}")
    rows = gather_rows_injective(x, seg.perm, seg.inv, seg.row_valid)
    return take_rows_injective(segment_matmul(rows, w, seg, impl=impl),
                               seg.inv, seg.perm, seg.row_valid)


@spans.op("linear")
def compact_typed_linear(g, x: torch.Tensor, w: torch.Tensor,
                         side: str = "src", *, impl: str = "kernel",
                         offsets: str = "host") -> torch.Tensor:
    """Typed linear over unique (relation, node) rows of one side:
    returns (compact n_rows, H, O), one row per (relation, node) pair,
    zero on padding rows.  ``offsets="device"`` multiplies on the
    segment-matmul kernels whatever offsets the host knows
    (:func:`_offsets`)."""
    seg = g.compact_src.seg if side == "src" else g.compact_dst.seg
    return segment_matmul(compact_rows(g, x, side, impl=impl), w,
                          _offsets(seg, offsets), impl=impl)


def compact_rows(g, x: torch.Tensor, side: str = "src", *,
                 impl: str = "kernel") -> torch.Tensor:
    """Node rows ``x`` (the side's rows, ...) gathered into the side's
    unique (relation, node) compact rows, zero on padding rows; the
    gradient is the sorted segment sum over ``node_row_ptr`` through
    ``node_sort_perm`` (``_compact_gather``)."""
    info = g.compact_src if side == "src" else g.compact_dst
    if info is None:
        raise ValueError("graph built without compact indices")
    rows = _side_rows(g, side)
    if x.shape[0] != rows:
        raise ValueError(f"x has {x.shape[0]} rows, the graph's {side} "
                         f"side {rows}")
    row_idx = torch.where(info.seg.row_valid, info.node_ids,
                          torch.full_like(info.node_ids, rows))
    return sorted_gather(x, row_idx, info.node_row_ptr, info.node_sort_perm,
                         impl=impl)


def _side_rows(g, side: str) -> int:
    """Rows of the features a side indexes: the source space (the halo
    buffer on a shard) or the local destinations."""
    return g.src_space if side == "src" else g.num_nodes


def _edge_row_idx(g, side: str) -> torch.Tensor:
    """Node row of each relation-sorted edge row: ``src`` or ``dst`` of
    the edge it holds, the side's sentinel row on padding rows."""
    idx = g.src if side == "src" else g.dst
    seg = g.edge_rel_seg
    return torch.where(seg.row_valid, take_rows(idx, seg.perm),
                       torch.full_like(seg.perm, _side_rows(g, side)))


@spans.function
class _EdgeRowGather(torch.autograd.Function):
    """Node rows -> relation-sorted edge rows (zero on padding rows).

    Backward, without writing a permuted copy of the cotangent: the
    destination side reads row ``seg.inv[e]`` for canonical edge ``e``
    (dst-sorted) and sums over ``in_row_ptr``; the source side reads row
    ``seg.inv[out_perm[p]]`` for src-sorted position ``p`` and sums over
    ``out_row_ptr``.  Padding edges lie past both row pointers' ends."""

    @staticmethod
    def forward(ctx, x, g, side: str, impl: str):
        if x.shape[0] != _side_rows(g, side):
            raise ValueError(f"x has {x.shape[0]} rows, the graph's {side} "
                             f"side {_side_rows(g, side)}")
        ctx.g, ctx.side, ctx.impl = g, side, impl
        ctx.x_shape = x.shape
        return gather_nodes(x, _edge_row_idx(g, side))

    @staticmethod
    def backward(ctx, ct_rows):
        g, seg = ctx.g, ctx.g.edge_rel_seg
        flat = ct_rows.reshape(ct_rows.shape[0], -1).contiguous()
        if ctx.side == "src":
            perm = take_rows(seg.inv, g.out_perm)
            dx = seg_sum_sorted(flat, g.out_row_ptr, perm, impl=ctx.impl)
        else:
            dx = seg_sum_sorted(flat, g.in_row_ptr, seg.inv, impl=ctx.impl)
        return dx.view(ctx.x_shape).to(ct_rows.dtype), None, None, None


@spans.op("linear")
def edge_typed_linear(g, x: torch.Tensor, w: torch.Tensor,
                      side: str = "src", *, impl: str = "kernel",
                      offsets: str = "host") -> torch.Tensor:
    """Per-edge typed linear ``y_e = x[side(e)] @ W[rel(e)]``: x (N, K),
    w (R, H, K, O) -> (num_padded_edges, H, O) in canonical edge order,
    exactly zero on padding edges.  ``offsets="device"`` multiplies on the
    segment-matmul kernels whatever offsets the host knows
    (:func:`_offsets`)."""
    seg = g.edge_rel_seg
    x_rows = _EdgeRowGather.apply(x, g, side, impl)
    y = segment_matmul(x_rows, w, _offsets(seg, offsets), impl=impl)
    return take_rows_injective(y, seg.inv, seg.perm, seg.row_valid)


@spans.op("linear")
def edge_rows_typed_linear(g, x_e: torch.Tensor, w: torch.Tensor, *,
                           impl: str = "kernel",
                           offsets: str = "host") -> torch.Tensor:
    """Per-edge typed linear of per-edge rows, ``y_e = x_e @ W[rel(e)]``:
    x_e (EP, K) in canonical order, w (R, H, K, O) -> (EP, H, O), zero on
    padding edges.  The rows are arranged into ``edge_rel_seg`` and read
    back by injective gathers, whose transposes are masked gathers."""
    seg = g.edge_rel_seg
    rows = gather_rows_injective(x_e, seg.perm, seg.inv, seg.row_valid)
    y = segment_matmul(rows, w, _offsets(seg, offsets), impl=impl)
    return take_rows_injective(y, seg.inv, seg.perm, seg.row_valid)


def expand_compact(g, c: torch.Tensor, side: str = "src", *,
                   impl: str = "kernel") -> torch.Tensor:
    """Compact (relation, node) rows of one side, (n_rows, ...), expanded
    to canonical edge order (EP, ...); padding edges read row 0, as in
    het_tpu.  The gradient is one sorted segment sum over ``edge_row_ptr``
    through ``edge_sort_perm`` at every width (het_tpu sends payloads
    under 16 lanes to XLA's scatter-add, which sums the same values)."""
    info = g.compact_src if side == "src" else g.compact_dst
    if info is None:
        raise ValueError("graph built without compact indices")
    return sorted_gather(c, info.edge_map, info.edge_row_ptr,
                         info.edge_sort_perm, impl=impl)


@spans.function
class _CompactDstInner(torch.autograd.Function):
    """``score[e, h] = <c2d[rowD(e)] (head h), x[src(e), h]>``.  Backward
    (``_cdi_bwd``): ``d_c`` one segment sum over the canonical (dst, rel)
    runs, read back through ``canon_to_row``; ``d_x`` one over the
    source-sorted edges (:func:`~.common.scatter_sum_src`'s sum)."""

    @staticmethod
    def _edge_terms(c2d, x, g):
        EP = g.num_padded_edges
        H, dk = x.shape[1], x.shape[2]
        c_e = take_rows(c2d, g.compact_dst.edge_map).float().view(EP, H, dk)
        x_e = gather_nodes(x, g.src).float().view(EP, H, dk)
        return c_e, x_e

    @staticmethod
    def forward(ctx, c2d, x, g, impl: str):
        ctx.save_for_backward(c2d, x)
        ctx.g, ctx.impl = g, impl
        c_e, x_e = _CompactDstInner._edge_terms(c2d, x, g)
        return (c_e * x_e).sum(-1).to(x.dtype)

    @staticmethod
    def backward(ctx, ct):
        c2d, x = ctx.saved_tensors
        g, impl = ctx.g, ctx.impl
        infoD = g.compact_dst
        EP = g.num_padded_edges
        c_e, x_e = _CompactDstInner._edge_terms(c2d, x, g)
        ct = ct.float()[..., None]
        red = seg_sum_sorted((ct * x_e).view(EP, -1), infoD.canon_ptr,
                             impl=impl)
        d_c = gather_nodes(red, infoD.canon_to_row)
        d_x = seg_sum_sorted((ct * c_e).view(EP, -1), g.out_row_ptr,
                             g.out_perm, impl=impl)
        return (d_c.to(c2d.dtype), d_x.view(x.shape).to(x.dtype), None,
                None)


def compact_dst_inner(g, c_dst: torch.Tensor, x_src: torch.Tensor, *,
                      impl: str = "kernel") -> torch.Tensor:
    """``score_e[h] = <c_dst[compact_dst_row(e), h], x_src[src(e), h]>``:
    c_dst (UCd, H, dk) on destination compact rows, x_src (src_space, H,
    dk) -> (EP, H), the single-sided compact SDDMM of HGT's attention
    score.  Per-edge rows exist only inside the op."""
    if g.compact_dst is None or g.compact_dst.canon_ptr is None:
        raise ValueError("graph built without compact indices")
    UC, H, dk = c_dst.shape
    return _CompactDstInner.apply(c_dst.reshape(UC, H * dk), x_src, g, impl)


@spans.function
class _RelInner(torch.autograd.Function):
    """``score[i, h] = <feat[i, h], a[rel[i], h]>``.  Backward: ``d_feat
    = ct * a[rel]``; ``d_a`` is the grouped dW over the segments of
    ``seg``, with rows taken in segment order through ``perm`` (None when
    the rows already are) and the cotangent zeroed on invalid rows."""

    @staticmethod
    def forward(ctx, feat, a, rel, seg, perm: Optional[torch.Tensor],
                impl: str):
        ctx.save_for_backward(feat, a, rel)
        ctx.seg, ctx.perm, ctx.impl = seg, perm, impl
        # a dot product: f32 products and sums, rounded once (bf16 runs)
        return (feat.float() * take_rows(a, rel).float()).sum(-1).to(
            feat.dtype)

    @staticmethod
    def backward(ctx, ct):
        feat, a, rel = ctx.saved_tensors
        d_feat = (ct[..., None] * take_rows(a, rel)).to(feat.dtype)
        da = _rel_inner_da(feat, ct.to(feat.dtype), a.shape[0], ctx.seg,
                           ctx.perm, ctx.impl)
        return d_feat, da.to(a.dtype), None, None, None, None


def _rel_inner_da(feat, ct, R: int, seg, perm, impl: str) -> torch.Tensor:
    """``d_a[r, h] = sum_{i in segment r} feat[i, h] * ct[i, h]`` (R, H,
    D) f32: the grouped dW over the segments of ``seg`` on ``feat`` and
    ``ct`` in their dtype (f32, or bf16 as het_tpu's ``_eri_bwd`` sends
    them), rows taken in segment order through ``perm`` (None when they
    already are) and ``ct`` zeroed on invalid rows."""
    fr, cr = feat, ct
    if perm is not None:
        fr, cr = take_rows(fr, perm), take_rows(cr, perm)
    cr = torch.where(seg.row_valid[:, None], cr, torch.zeros_like(cr))
    H, D = fr.shape[1], fr.shape[2]
    return segment_matmul_dw(fr.contiguous(), cr[..., None], (R, H, D, 1),
                             seg, impl=impl)[..., 0]


def edge_rel_scale_grad(g, score_e: torch.Tensor, ct_e: torch.Tensor, *,
                        impl: str = "kernel",
                        rows: bool = False) -> torch.Tensor:
    """The gradient of ``mu`` (R, H) in ``raw_e = score_e * mu[rel_e]``
    for the cotangent ``ct_e`` of ``raw``, both (EP, H) in canonical order,
    or, where ``rows``, already in the relation-sorted edge rows (n_rows,
    H; ``score_e`` finite on every row): the inner product's ``d_a`` at D
    = 1, the grouped dW over the relation-sorted edge rows (no atomics: a
    segment's rows in chunks, each summed in a fixed order)."""
    seg = g.edge_rel_seg
    return _rel_inner_da(score_e[..., None], ct_e, g.num_rels, seg,
                         None if rows else seg.perm, impl)[..., 0]


def edge_rel_inner(g, feat_e: torch.Tensor, a: torch.Tensor, *,
                   impl: str = "kernel") -> torch.Tensor:
    """``score_e[h] = <feat_e[h], a[rel_e, h]>``: feat_e (EP, H, D) in
    canonical edge order, a (R, H, D) -> (EP, H).  The ``a`` gradient
    reads the edges in relation order (``edge_rel_seg.perm``)."""
    seg = g.edge_rel_seg
    return _RelInner.apply(feat_e, a, g.rel, seg, seg.perm, impl)


def segment_rel_inner(x_rows: torch.Tensor, a: torch.Tensor, seg, *,
                      impl: str = "kernel") -> torch.Tensor:
    """``score[i, h] = <x_rows[i, h], a[segment(i), h]>`` for rows already
    in the segment space of ``seg`` (compact rows): (n_rows, H, D),
    (R, H, D) -> (n_rows, H)."""
    return _RelInner.apply(x_rows, a, seg.row_seg, seg, None, impl)


# ------------------------------------------- node-level linears (Simple-HGN)


@spans.op("linear")
def node_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` at node rows: x (N, K), w (K, O) -> (N, O)."""
    return x @ w


@spans.op("linear")
def attention_projection(x: torch.Tensor, w: torch.Tensor,
                         attn_l: torch.Tensor, attn_r: torch.Tensor):
    """GAT's projection and its two logits a head: ``feat = x W`` (N,
    H*D) head-major, and ``el``, ``er`` (N, H) with ``el[n, h] = <feat[n,
    h], attn_l[h]>``, taken as ``x (W attn_l)`` (the weights multiplied
    first, (K, H)) so that no (N, H*D) product is built for them."""
    H, D = attn_l.shape
    w3 = w.view(w.shape[0], H, D)
    lr = x @ torch.cat([(w3 * attn_l).sum(-1), (w3 * attn_r).sum(-1)], 1)
    return x @ w, lr[:, :H], lr[:, H:]


@spans.op("linear")
def edge_type_logits(emb: torch.Tensor, w_e: torch.Tensor,
                     attn_e: torch.Tensor) -> torch.Tensor:
    """Simple-HGN's edge-type term a head, ``ee[r, h] = <(emb[r] W_e)_h,
    attn_e[h]>``: emb (T, F), w_e (F, H*Fe), attn_e (H, Fe) -> (T, H)."""
    H, Fe = attn_e.shape
    return ((emb @ w_e).view(-1, H, Fe) * attn_e).sum(-1)

