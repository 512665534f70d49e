"""Relation-typed linears and relation-typed inner products.

Counterpart of ``het_tpu/ops/linear.py``:

* :func:`segment_matmul` multiplies each relation's rows by that
  relation's weight: one dense matmul per relation over the row slice
  ``seg_ptrs_static[r]:seg_ptrs_static[r+1]`` where the offsets are known
  on the host (the JAX package's static-mix plan,
  ``segment_matmul_static_mix``; there too the matmul is left to the
  compiler's library, here ``torch.matmul``), the segment-matmul kernels
  where they live only on the device (a shard of a partitioned graph);
* :func:`compact_typed_linear` gathers node rows into the unique
  (relation, node) compact rows and applies :func:`segment_matmul`.  The
  gather's backward is the sorted segment sum over ``node_row_ptr`` with
  ``node_sort_perm``, as ``_compact_gather`` has it;
* :func:`edge_typed_linear` does the same per edge: node rows gathered
  into the relation-sorted edge rows (``edge_rel_seg``), multiplied, and
  read back in canonical edge order.  The gather's backward is a sorted
  segment sum over the source or destination CSR, reading the cotangent
  rows through a permutation, as ``_make_edge_row_gather`` has it;
* :func:`edge_rel_inner` and :func:`segment_rel_inner` are the
  attention-logit inner products ``<feat[h], a[rel, h]>``; their ``a``
  gradient is the grouped dW kernel (``kernels.segment_matmul_dw``).

``impl`` ("kernel" or "plain") picks the version of every kernel an op
runs; see ``kernels/_dispatch.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .common import (gather_nodes, sorted_gather, take_rows,
                     take_rows_injective)
from .kernels import (seg_sum_sorted, segment_matmul_dw, segment_matmul_dx,
                      segment_matmul_fwd)


def _flat_weight(w_r: torch.Tensor) -> torch.Tensor:
    """(H, K, O) -> (K, H*O), head-major output columns."""
    H, K, O = w_r.shape
    return w_r.permute(1, 0, 2).reshape(K, H * O)


class _SegmentMatmul(torch.autograd.Function):
    """Per-relation dense matmul over static row slices; the backward
    writes each slice's dx into its disjoint rows and dW per relation
    (``_static_mix_bwd_impl``)."""

    @staticmethod
    def forward(ctx, x_rows, w, seg_ptrs: Tuple[int, ...]):
        S, H, K, O = w.shape
        # the slices tile [0, n_rows) exactly, so every row is written
        y = x_rows.new_empty(x_rows.shape[0], H * O)
        for r in range(S):
            lo, hi = seg_ptrs[r], seg_ptrs[r + 1]
            if hi > lo:
                torch.matmul(x_rows[lo:hi], _flat_weight(w[r]), out=y[lo:hi])
        ctx.save_for_backward(x_rows, w)
        ctx.seg_ptrs = seg_ptrs
        return y.view(-1, H, O)

    @staticmethod
    def backward(ctx, ct):
        x_rows, w = ctx.saved_tensors
        S, H, K, O = w.shape
        ct2 = ct.reshape(ct.shape[0], H * O)
        dx = torch.empty_like(x_rows) if ctx.needs_input_grad[0] else None
        dw = torch.zeros_like(w) if ctx.needs_input_grad[1] else None
        for r in range(S):
            lo, hi = ctx.seg_ptrs[r], ctx.seg_ptrs[r + 1]
            if hi == lo:
                continue
            if dx is not None:
                torch.matmul(ct2[lo:hi], _flat_weight(w[r]).t(),
                             out=dx[lo:hi])
            if dw is not None:
                dwr = x_rows[lo:hi].t() @ ct2[lo:hi]  # (K, H*O)
                dw[r] = dwr.view(K, H, O).permute(1, 0, 2)
        return dx, dw, None


class _SegmentMatmulRows(torch.autograd.Function):
    """Segment matmul whose offsets live only on the device (a shard of a
    partitioned graph): forward and dX by the CUDA kernels of
    ``kernels.segment_matmul_fwd`` / ``segment_matmul_dx``, dW by the
    grouped ``segment_matmul_dw``, as ``segment_matmul_rows_pallas`` has
    them; dX only where the input needs a gradient."""

    @staticmethod
    def forward(ctx, x_rows, w, seg, impl: str):
        ctx.save_for_backward(x_rows, w)
        ctx.seg, ctx.impl = seg, impl
        return segment_matmul_fwd(x_rows, w, seg, impl=impl)

    @staticmethod
    def backward(ctx, ct):
        x_rows, w = ctx.saved_tensors
        seg, impl = ctx.seg, ctx.impl
        ct = ct.float().contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = segment_matmul_dx(ct, w, seg, 1, impl=impl).to(x_rows.dtype)
        if ctx.needs_input_grad[1]:
            dw = segment_matmul_dw(x_rows, ct, tuple(w.shape), seg,
                                   impl=impl).to(w.dtype)
        return dx, dw, None, None


def segment_matmul(x_rows: torch.Tensor, w: torch.Tensor, seg, *,
                   impl: str = "kernel") -> torch.Tensor:
    """x_rows (n_rows, K) of the segment row space, w (S, H, K, O) ->
    (n_rows, H, O): row ``i`` of segment ``s`` times ``w[s]``.

    Dispatches as the JAX package's pallas backend does: host-known
    offsets take the per-relation ``torch.matmul`` slices; offsets that
    live only on the device (``seg_ptrs_static is None``) take the
    segment-matmul kernels, which read them there."""
    if x_rows.dim() != 2:
        raise NotImplementedError(
            "segment_matmul takes (n_rows, K) rows; per-head (n_rows, H, K) "
            "inputs have no caller on the ported paths yet (ROADMAP.md "
            "queue 1)"
        )
    if seg.n_rows != x_rows.shape[0]:
        raise ValueError("x_rows does not span the segment row space")
    if seg.seg_ptrs_static is None:
        return _SegmentMatmulRows.apply(x_rows.contiguous(), w.contiguous(),
                                        seg, impl)
    return _SegmentMatmul.apply(x_rows, w, seg.seg_ptrs_static)


def compact_typed_linear(g, x: torch.Tensor, w: torch.Tensor,
                         side: str = "src", *,
                         impl: str = "kernel") -> torch.Tensor:
    """Typed linear over unique (relation, node) rows of one side:
    returns (compact n_rows, H, O), one row per (relation, node) pair,
    zero on padding rows."""
    info = g.compact_src if side == "src" else g.compact_dst
    if info is None:
        raise ValueError("graph built without compact indices")
    seg = info.seg
    rows = _side_rows(g, side)
    if x.shape[0] != rows:
        raise ValueError(f"x has {x.shape[0]} rows, the graph's {side} "
                         f"side {rows}")
    row_idx = torch.where(seg.row_valid, info.node_ids,
                          torch.full_like(info.node_ids, rows))
    x_rows = sorted_gather(x, row_idx, info.node_row_ptr,
                           info.node_sort_perm, impl=impl)
    return segment_matmul(x_rows, w, seg, impl=impl)


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
        flat = ct_rows.reshape(ct_rows.shape[0], -1).float().contiguous()
        if ctx.side == "src":
            perm = take_rows(seg.inv, g.out_perm)
            dx = seg_sum_sorted(flat, g.out_row_ptr, perm, impl=ctx.impl)
        else:
            dx = seg_sum_sorted(flat, g.in_row_ptr, seg.inv, impl=ctx.impl)
        return dx.view(ctx.x_shape).to(ct_rows.dtype), None, None, None


def edge_typed_linear(g, x: torch.Tensor, w: torch.Tensor,
                      side: str = "src", *,
                      impl: str = "kernel") -> torch.Tensor:
    """Per-edge typed linear ``y_e = x[side(e)] @ W[rel(e)]``: x (N, K),
    w (R, H, K, O) -> (num_padded_edges, H, O) in canonical edge order,
    exactly zero on padding edges."""
    seg = g.edge_rel_seg
    x_rows = _EdgeRowGather.apply(x, g, side, impl)
    return take_rows_injective(segment_matmul(x_rows, w, seg, impl=impl),
                               seg.inv, seg.perm, seg.row_valid)


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
        return (feat * take_rows(a, rel)).sum(-1)

    @staticmethod
    def backward(ctx, ct):
        feat, a, rel = ctx.saved_tensors
        seg, perm = ctx.seg, ctx.perm
        ct = ct.float()
        d_feat = (ct[..., None] * take_rows(a, rel)).to(feat.dtype)
        fr, cr = feat.float(), ct
        if perm is not None:
            fr, cr = take_rows(fr, perm), take_rows(cr, perm)
        cr = torch.where(seg.row_valid[:, None], cr, torch.zeros_like(cr))
        R, H, D = a.shape
        da = segment_matmul_dw(fr.contiguous(), cr[..., None], (R, H, D, 1),
                               seg, impl=ctx.impl)[..., 0]
        return d_feat, da.to(a.dtype), None, None, None, None


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
