"""Edge blocks aligned to nodes: ranges of a CSR's row pointer that an op
walks one block at a time, so that no per-edge tensor it builds holds
more than a block's edges.

A block is ``(v0, v1, lo, hi)``: the nodes ``[v0, v1)`` and their edges,
positions ``[lo, hi) = [row_ptr[v0], row_ptr[v1])`` of the CSR's edge
order (canonical order for ``in_row_ptr``, ``out_perm``'s order for
``out_row_ptr``).  Every node lies in exactly one block, in node order, so
a segment sum over a block's row pointer gives its nodes' whole sums.
"""

from __future__ import annotations

from typing import Tuple

import torch

Block = Tuple[int, int, int, int]
SIDES = ("dst", "src")


def node_blocks(row_ptr: torch.Tensor, block_edges: int
                ) -> Tuple[Block, ...]:
    """The blocks of ``row_ptr`` (n + 1,): each the longest run of nodes
    whose edges number at most ``block_edges``, or one node alone where
    that node has more."""
    if block_edges < 1:
        raise ValueError(f"block_edges must be positive, got {block_edges}")
    ptr = row_ptr.to("cpu", torch.int64)
    n = ptr.numel() - 1
    out, v0 = [], 0
    while v0 < n:
        lo = int(ptr[v0])
        last = int(torch.searchsorted(ptr, lo + block_edges, right=True)) - 1
        v1 = min(max(last, v0 + 1), n)
        out.append((v0, v1, lo, int(ptr[v1])))
        v0 = v1
    return tuple(out)


def graph_blocks(g, side: str, block_edges: int) -> Tuple[Block, ...]:
    """The blocks of ``g``'s destination CSR (``in_row_ptr``, side "dst")
    or source CSR (``out_row_ptr``, side "src"), worked out once a graph
    and block size (the row pointer is read back from the card once) and
    kept on the graph object; a graph moved or replaced works them out
    anew."""
    if side not in SIDES:
        raise ValueError(f"side must be one of {SIDES}, got {side!r}")
    cache = g.__dict__.setdefault("_node_blocks", {})
    key = (side, block_edges)
    if key not in cache:
        ptr = g.in_row_ptr if side == "dst" else g.out_row_ptr
        cache[key] = node_blocks(ptr, block_edges)
    return cache[key]
