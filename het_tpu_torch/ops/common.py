"""Shared gathers over the canonical edge layout.

They keep the padding discipline of ``het_tpu.ops.common``: a node gather
accepts the sentinel index ``x.shape[0]`` (padding edges, padding compact
rows) and returns a zero row for it.
"""

from __future__ import annotations

import torch


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


def gather_dst(g, node_vals: torch.Tensor) -> torch.Tensor:
    """Per-edge rows of ``node_vals`` at each edge's destination (zero on
    padding edges)."""
    return gather_nodes(node_vals, g.dst)


def safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` with 0 where ``den == 0``."""
    ok = den != 0
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))
