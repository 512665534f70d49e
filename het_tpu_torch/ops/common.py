"""Shared gathers and the destination sum over the canonical edge layout.

They keep the padding discipline of ``het_tpu.ops.common``: a node gather
accepts the sentinel index ``x.shape[0]`` (padding edges, padding compact
rows) and returns a zero row for it.
"""

from __future__ import annotations

import torch

from .kernels import seg_sum_sorted


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` along the first axis (``idx`` int32 or int64)."""
    return x.index_select(0, idx)


def gather_nodes(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` where ``idx`` may hold the sentinel ``x.shape[0]``, which
    reads a zero row."""
    src = torch.cat([x, x.new_zeros((1,) + x.shape[1:])], dim=0)
    return take_rows(src, idx)


class _TakeRowsInjective(torch.autograd.Function):
    """``y[inv]``; backward ``ct[perm]`` zeroed on invalid rows."""

    @staticmethod
    def forward(ctx, y, inv, perm, row_valid):
        ctx.save_for_backward(perm, row_valid)
        return take_rows(y, inv)

    @staticmethod
    def backward(ctx, ct):
        perm, row_valid = ctx.saved_tensors
        dy = take_rows(ct, perm)
        mask = row_valid.view((-1,) + (1,) * (dy.dim() - 1))
        return torch.where(mask, dy, torch.zeros_like(dy)), None, None, None


def take_rows_injective(y: torch.Tensor, inv: torch.Tensor,
                        perm: torch.Tensor,
                        row_valid: torch.Tensor) -> torch.Tensor:
    """``y[inv]`` where ``inv`` and ``perm`` are mutually inverse
    injections (source rows <-> valid rows of a padded segment space).  The
    transpose of an injective gather is the masked gather ``ct[perm]``, not
    the atomic scatter of ``index_select``'s own backward.  Cotangents on
    invalid rows are dropped: nothing reads those rows back."""
    return _TakeRowsInjective.apply(y, inv, perm, row_valid)


class _SortedGather(torch.autograd.Function):
    """``x[idx]`` with the sentinel reading a zero row.  Backward: the
    cotangent rows summed into ``x``'s rows by one sorted segment sum over
    ``ptr``, reading them through ``perm`` (the gather's transpose in a
    fixed order, not ``index_select``'s atomic scatter)."""

    @staticmethod
    def forward(ctx, x, idx, ptr, perm, impl: str):
        ctx.save_for_backward(ptr, perm)
        ctx.impl, ctx.x_shape = impl, x.shape
        return gather_nodes(x, idx)

    @staticmethod
    def backward(ctx, ct):
        ptr, perm = ctx.saved_tensors
        flat = ct.reshape(ct.shape[0], -1).float().contiguous()
        dx = seg_sum_sorted(flat, ptr, perm, impl=ctx.impl)
        return dx.view(ctx.x_shape).to(ct.dtype), None, None, None, None


def sorted_gather(x: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor,
                  perm: torch.Tensor, *, impl: str = "kernel") -> torch.Tensor:
    """``x[idx]`` (sentinel ``x.shape[0]`` -> zero row) whose gradient is
    ``seg_sum_sorted(ct, ptr, perm)``: ``perm`` lists the gathered rows
    grouped by the row of ``x`` they read, ``ptr`` (``x.shape[0] + 1``,)
    the start of each group; sentinel rows lie past ``ptr[-1]``."""
    return _SortedGather.apply(x, idx, ptr, perm, impl)


def gather_dst(g, node_vals: torch.Tensor) -> torch.Tensor:
    """Per-edge rows of ``node_vals`` at each edge's destination (zero on
    padding edges)."""
    return gather_nodes(node_vals, g.dst)


def gather_src(g, node_vals: torch.Tensor) -> torch.Tensor:
    """Per-edge rows of ``node_vals`` at each edge's source."""
    return gather_nodes(node_vals, g.src)


class _ScatterSumDst(torch.autograd.Function):
    """Per-edge rows summed into their destinations: one sorted segment
    sum over ``in_row_ptr`` (canonical order is destination-sorted, and
    padding edges lie past its end).  Backward: the destination gather."""

    @staticmethod
    def forward(ctx, vals, g, impl: str):
        ctx.g = g
        flat = vals.reshape(vals.shape[0], -1).float().contiguous()
        out = seg_sum_sorted(flat, g.in_row_ptr, impl=impl)
        return out.view((out.shape[0],) + vals.shape[1:]).to(vals.dtype)

    @staticmethod
    def backward(ctx, ct):
        return gather_dst(ctx.g, ct), None, None


def scatter_sum_dst(g, edge_vals: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """Sum per-edge rows (EP, ...) in canonical order into destination
    nodes (num_nodes, ...), without atomics; zero rows where a node has no
    incoming edge."""
    return _ScatterSumDst.apply(edge_vals, g, impl)


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with 0 where ``den == 0``."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))
