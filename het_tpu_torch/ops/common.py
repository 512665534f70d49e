"""Shared gathers and sums over the canonical edge layout.

They keep the padding discipline of ``het_tpu.ops.common``: a node gather
accepts the sentinel index ``x.shape[0]`` (padding edges, padding compact
rows) and returns a zero row for it.  Each gather whose input may need a
gradient has the sorted transpose as its backward, never
``index_select``'s atomic scatter: the edge gathers at destinations and
sources sum into the nodes over ``in_row_ptr`` and ``out_row_ptr``
(``scatter_sum_dst`` / ``scatter_sum_src``), the injective gathers by the
inverse gather.  A backward's segment sum reads the cotangent in its own
dtype (bf16 in a bf16 run) into f32 sums, cast back to that dtype, as
het_tpu's ``seg_sum_sorted_packed`` callers pass ``pack_dt = ct.dtype``.
The compiler's sums over relations and node types (``edge_rel_sum``,
``edge_rel_gather``'s gradient, ``ntype_sum``) are sorted segment sums too.
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


class _GatherRowsInjective(torch.autograd.Function):
    """``x[perm]`` zeroed on invalid rows; backward ``ct[inv]``."""

    @staticmethod
    def forward(ctx, x, perm, inv, row_valid):
        ctx.save_for_backward(inv)
        rows = take_rows(x, perm)
        mask = row_valid.view((-1,) + (1,) * (rows.dim() - 1))
        return torch.where(mask, rows, torch.zeros_like(rows))

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        return take_rows(ct, inv), None, None, None


def gather_rows_injective(x: torch.Tensor, perm: torch.Tensor,
                          inv: torch.Tensor,
                          row_valid: torch.Tensor) -> torch.Tensor:
    """Source rows arranged into a padded segment space, ``x[perm]`` with
    zeros on invalid rows, where ``perm`` and ``inv`` are mutually inverse
    injections: its transpose is the gather ``ct[inv]``
    (``het_tpu/ops/linear.py::_gather_rows_injective``)."""
    return _GatherRowsInjective.apply(x, perm, inv, row_valid)


class _SortedGather(torch.autograd.Function):
    """``x[idx]`` (with ``sentinel``, the sentinel reading a zero row).
    Backward: the cotangent rows summed into ``x``'s rows by one sorted
    segment sum over ``ptr``, reading them through ``perm`` (the gather's
    transpose in a fixed order, not ``index_select``'s atomic scatter)."""

    @staticmethod
    def forward(ctx, x, idx, ptr, perm, impl: str, sentinel: bool):
        ctx.save_for_backward(ptr, perm)
        ctx.impl, ctx.x_shape = impl, x.shape
        return gather_nodes(x, idx) if sentinel else take_rows(x, idx)

    @staticmethod
    def backward(ctx, ct):
        ptr, perm = ctx.saved_tensors
        flat = ct.reshape(ct.shape[0], -1).contiguous()
        dx = seg_sum_sorted(flat, ptr, perm, impl=ctx.impl)
        return (dx.view(ctx.x_shape).to(ct.dtype), None, None, None, None,
                None)


def sorted_gather(x: torch.Tensor, idx: torch.Tensor, ptr: torch.Tensor,
                  perm: torch.Tensor, *, impl: str = "kernel",
                  sentinel: bool = True) -> torch.Tensor:
    """``x[idx]`` (sentinel ``x.shape[0]`` -> zero row) whose gradient is
    ``seg_sum_sorted(ct, ptr, perm)``: ``perm`` lists the gathered rows
    grouped by the row of ``x`` they read, ``ptr`` (``x.shape[0] + 1``,)
    the start of each group; sentinel rows lie past ``ptr[-1]``.  With
    ``sentinel=False`` every index is a row of ``x``, and the gather reads
    ``x`` without the copy that appends the zero row (a large table)."""
    return _SortedGather.apply(x, idx, ptr, perm, impl, sentinel)


def _sum_dst(g, flat: torch.Tensor, impl: str) -> torch.Tensor:
    """(EP, C) rows in canonical order summed into their destinations:
    one sorted segment sum over ``in_row_ptr`` (canonical order is
    destination-sorted; padding edges lie past its end)."""
    return seg_sum_sorted(flat.contiguous(), g.in_row_ptr, impl=impl)


def _sum_src(g, flat: torch.Tensor, impl: str) -> torch.Tensor:
    """(EP, C) rows in canonical order summed into their sources: one
    sorted segment sum over ``out_row_ptr``, reading the rows through
    ``out_perm`` (padding edges lie past its end)."""
    return seg_sum_sorted(flat.contiguous(), g.out_row_ptr, g.out_perm,
                          impl=impl)


class _GatherSide(torch.autograd.Function):
    """Per-edge rows of node rows at each edge's destination or source
    (zero on padding edges).  Backward: the transpose, one sorted segment
    sum into the nodes (:func:`_sum_dst`, :func:`_sum_src`), not
    ``index_select``'s atomic scatter."""

    @staticmethod
    def forward(ctx, x, g, side: str, impl: str):
        ctx.g, ctx.side, ctx.impl, ctx.x_shape = g, side, impl, x.shape
        return gather_nodes(x, g.dst if side == "dst" else g.src)

    @staticmethod
    def backward(ctx, ct):
        flat = ct.reshape(ct.shape[0], -1)
        total = _sum_dst if ctx.side == "dst" else _sum_src
        dx = total(ctx.g, flat, ctx.impl)
        return dx.view(ctx.x_shape).to(ct.dtype), None, None, None


def gather_dst(g, node_vals: torch.Tensor, *,
               impl: str = "kernel") -> torch.Tensor:
    """Per-edge rows of ``node_vals`` at each edge's destination (zero on
    padding edges); the gradient is :func:`scatter_sum_dst`'s sum."""
    return _GatherSide.apply(node_vals, g, "dst", impl)


def gather_src(g, node_vals: torch.Tensor, *,
               impl: str = "kernel") -> torch.Tensor:
    """Per-edge rows of ``node_vals`` at each edge's source (zero on
    padding edges); the gradient is :func:`scatter_sum_src`'s sum."""
    return _GatherSide.apply(node_vals, g, "src", impl)


class _ScatterSum(torch.autograd.Function):
    """Per-edge rows summed into their destinations or sources by one
    sorted segment sum.  Backward: the gather at each edge's node."""

    @staticmethod
    def forward(ctx, vals, g, side: str, impl: str):
        ctx.g, ctx.side = g, side
        total = _sum_dst if side == "dst" else _sum_src
        out = total(g, vals.reshape(vals.shape[0], -1), impl)
        return out.view((out.shape[0],) + vals.shape[1:]).to(vals.dtype)

    @staticmethod
    def backward(ctx, ct):
        idx = ctx.g.dst if ctx.side == "dst" else ctx.g.src
        return gather_nodes(ct, idx), None, None, None


def scatter_sum_dst(g, edge_vals: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """Sum per-edge rows (EP, ...) in canonical order into destination
    nodes (num_nodes, ...), without atomics; zero rows where a node has no
    incoming edge."""
    return _ScatterSum.apply(edge_vals, g, "dst", impl)


def scatter_sum_src(g, edge_vals: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """Sum per-edge rows (EP, ...) in canonical order into source nodes
    (src_space, ...) through the source-sorted ``out_perm``, without
    atomics (``het_tpu/ops/common.py::scatter_sum_src``)."""
    return _ScatterSum.apply(edge_vals, g, "src", impl)


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with 0 where ``den == 0``."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def _edge_valid(g) -> torch.Tensor:
    """(EP,) True on real edges, False on padding edges."""
    return g.dst < g.num_nodes


def _masked_edges(g, vals: torch.Tensor) -> torch.Tensor:
    """``vals`` (EP, ...) with the padding edges' rows zeroed."""
    mask = _edge_valid(g).view((-1,) + (1,) * (vals.dim() - 1))
    return torch.where(mask, vals, torch.zeros_like(vals))


def _sum_rel(g, flat: torch.Tensor, impl: str) -> torch.Tensor:
    """(EP, C) rows in canonical order summed over each relation's real
    edges: one sorted segment sum over ``edge_rel_seg``'s row pointer
    through its ``perm``, padding rows (and the padding edges, which the
    relation-sorted rows mark invalid) reading an appended zero row."""
    seg = g.edge_rel_seg
    EP = flat.shape[0]
    perm = torch.where(seg.row_valid, seg.perm, torch.full_like(seg.perm, EP))
    rows = torch.cat([flat, flat.new_zeros(1, flat.shape[1])])
    return seg_sum_sorted(rows.contiguous(), seg.seg_ptrs, perm, impl=impl)


class _EdgeRelSum(torch.autograd.Function):
    """Per-edge rows summed into their relations (padding edges add
    nothing); backward the read of each real edge's relation row."""

    @staticmethod
    def forward(ctx, vals, g, impl: str):
        ctx.g = g
        out = _sum_rel(g, vals.reshape(vals.shape[0], -1), impl)
        return out.view((g.num_rels,) + vals.shape[1:]).to(vals.dtype)

    @staticmethod
    def backward(ctx, ct):
        return _masked_edges(ctx.g, take_rows(ct, ctx.g.rel)), None, None


def edge_rel_sum(g, edge_vals: torch.Tensor, *,
                 impl: str = "kernel") -> torch.Tensor:
    """``out[r] = sum_{rel(e) = r} edge_vals[e]`` over the real edges:
    edge_vals (EP, ...) in canonical order -> (num_rels, ...), one sorted
    segment sum over the relation-sorted edge rows, not a scatter-add
    (``jax.ops.segment_sum(edge_mask(v), rel)`` in het_tpu's lowering)."""
    return _EdgeRelSum.apply(edge_vals, g, impl)


class _EdgeRelGather(torch.autograd.Function):
    """``w[rel]`` per canonical edge; backward :func:`edge_rel_sum`."""

    @staticmethod
    def forward(ctx, w, g, impl: str):
        ctx.g, ctx.impl = g, impl
        return take_rows(w, g.rel)

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        dw = _sum_rel(g, ct.reshape(ct.shape[0], -1), ctx.impl)
        return dw.view((g.num_rels,) + ct.shape[1:]).to(ct.dtype), None, None


def edge_rel_gather(g, w: torch.Tensor, *,
                    impl: str = "kernel") -> torch.Tensor:
    """Each canonical edge's row of a relation-typed tensor, ``w[rel]``
    (EP, ...), whose gradient is :func:`edge_rel_sum` (the padding edges'
    cotangent dropped), not ``index_select``'s atomic scatter."""
    return _EdgeRelGather.apply(w, g, impl)


def _ntype_ptr(g, device) -> torch.Tensor:
    return torch.tensor(g.ntype_offsets, dtype=torch.int32, device=device)


class _NtypeSum(torch.autograd.Function):
    """Node rows summed into their node types (each type a contiguous
    range of node ids); backward the read of each node's type row."""

    @staticmethod
    def forward(ctx, vals, g, impl: str):
        ctx.g = g
        flat = vals.reshape(vals.shape[0], -1).contiguous()
        out = seg_sum_sorted(flat, _ntype_ptr(g, vals.device), impl=impl)
        return out.view((g.num_ntypes,) + vals.shape[1:]).to(vals.dtype)

    @staticmethod
    def backward(ctx, ct):
        g = ctx.g
        ptr = _ntype_ptr(g, ct.device).long()
        types = torch.repeat_interleave(
            torch.arange(g.num_ntypes, device=ct.device), ptr[1:] - ptr[:-1],
            output_size=g.num_nodes)
        return take_rows(ct, types), None, None


def ntype_sum(g, node_vals: torch.Tensor, *,
              impl: str = "kernel") -> torch.Tensor:
    """``out[t] = sum of node_vals over the nodes of type t``: node_vals
    (num_nodes, ...) -> (num_ntypes, ...), one sorted segment sum over
    ``ntype_offsets`` (het_tpu's lowering: ``jax.ops.segment_sum`` over
    each node's type)."""
    return _NtypeSum.apply(node_vals, g, impl)
