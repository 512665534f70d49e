"""Relation-typed linears over compact rows.

Counterpart of the compact path of ``het_tpu/ops/linear.py``:

* :func:`segment_matmul` multiplies each relation's rows by that
  relation's weight, one dense matmul per relation over the row slice
  ``seg_ptrs_static[r]:seg_ptrs_static[r+1]`` (the JAX package's
  static-mix plan, ``segment_matmul_static_mix``; there too the matmul is
  left to the compiler's library, here ``torch.matmul``);
* :func:`compact_typed_linear` gathers node rows into the unique
  (relation, node) compact rows and applies :func:`segment_matmul`.  The
  gather's backward is the sorted segment sum over ``node_row_ptr`` with
  ``node_sort_perm``, as ``_compact_gather`` has it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .common import gather_nodes
from .kernels import seg_sum_sorted


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


def segment_matmul(x_rows: torch.Tensor, w: torch.Tensor,
                   seg) -> torch.Tensor:
    """x_rows (n_rows, K) of the segment row space, w (S, H, K, O) ->
    (n_rows, H, O): row ``i`` of segment ``s`` times ``w[s]``."""
    if x_rows.dim() != 2:
        raise NotImplementedError(
            "segment_matmul takes (n_rows, K) rows; per-head inputs belong "
            "to the plain RGAT path (ROADMAP.md, 'The rest of RGAT')"
        )
    if seg.seg_ptrs_static[-1] != x_rows.shape[0]:
        raise ValueError("x_rows does not span the segment row space")
    return _SegmentMatmul.apply(x_rows, w, seg.seg_ptrs_static)


class _CompactGather(torch.autograd.Function):
    """Node rows -> compact rows; sentinel rows read zeros.  Backward: the
    cotangent rows, taken in node order through ``node_sort_perm``, are
    summed per node over ``node_row_ptr`` (padding rows sort past its
    end and are never read)."""

    @staticmethod
    def forward(ctx, x, row_idx, info, impl: str):
        ctx.info, ctx.impl = info, impl
        ctx.x_shape = x.shape
        return gather_nodes(x, row_idx)

    @staticmethod
    def backward(ctx, ct):
        info = ctx.info
        flat = ct.reshape(ct.shape[0], -1).float().contiguous()
        dx = seg_sum_sorted(flat, info.node_row_ptr, info.node_sort_perm,
                            impl=ctx.impl)
        return dx.view(ctx.x_shape).to(ct.dtype), None, None, None


def compact_typed_linear(g, x: torch.Tensor, w: torch.Tensor,
                         side: str = "src", *,
                         seg_sum_impl: str = "kernel") -> torch.Tensor:
    """Typed linear over unique (relation, node) rows of one side:
    returns (compact n_rows, H, O), one row per (relation, node) pair,
    zero on padding rows."""
    info = g.compact_src if side == "src" else g.compact_dst
    if info is None:
        raise ValueError("graph built without compact indices")
    seg = info.seg
    row_idx = torch.where(seg.row_valid, info.node_ids,
                          torch.full_like(info.node_ids, g.num_nodes))
    x_rows = _CompactGather.apply(x, row_idx, info, seg_sum_impl)
    return segment_matmul(x_rows, w, seg)
