"""Host-side (numpy) construction of :class:`HeteroGraph`.

The same layout ``het_tpu.graph.build`` produces, field for field and bit
for bit: one canonical dst-sorted edge order, tile-padded relation
segments and the dual-list compact materialization with its sorted
segmentations.  The result holds CPU tensors; move it with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from .convert import canonical_sort, counting_argsort, unique_pairs
from .structures import CompactInfo, HeteroGraph, Segments

__all__ = ["build_segments", "build_heterograph"]

# canonical edge arrays: padded to a multiple of EDGE_PAD, plus EDGE_EXTRA
# sentinel rows, as the JAX package pads them (its Pallas DMA guard rows)
EDGE_PAD, EDGE_EXTRA = 128, 1024


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


def build_segments(seg_of_row: np.ndarray, n_segments: int,
                   tile: int) -> Segments:
    """Group source rows by segment id, padding each segment to a multiple
    of ``tile`` rows so every row tile is single-segment."""
    seg_of_row = np.asarray(seg_of_row)
    n_src = int(seg_of_row.shape[0])
    order = counting_argsort(seg_of_row)
    counts = np.bincount(seg_of_row, minlength=n_segments).astype(np.int64)
    padded = ((counts + tile - 1) // tile * tile) if tile > 1 else counts
    seg_ptrs = np.zeros(n_segments + 1, dtype=np.int64)
    np.cumsum(padded, out=seg_ptrs[1:])
    n_rows = int(seg_ptrs[-1])

    perm = np.zeros(n_rows, dtype=np.int64)
    row_valid = np.zeros(n_rows, dtype=bool)
    row_seg = np.zeros(n_rows, dtype=np.int64)
    inv = np.zeros(n_src, dtype=np.int64)
    src_ptr = np.zeros(n_segments + 1, dtype=np.int64)
    np.cumsum(counts, out=src_ptr[1:])
    for s in range(n_segments):
        c = counts[s]
        lo = seg_ptrs[s]
        rows = order[src_ptr[s]: src_ptr[s + 1]]
        perm[lo: lo + c] = rows
        inv[rows] = np.arange(lo, lo + c)
        row_valid[lo: lo + c] = True
        row_seg[seg_ptrs[s]: seg_ptrs[s + 1]] = s

    n_tiles = n_rows // tile if tile > 0 else 0
    tile_seg = row_seg[::tile][:n_tiles] if tile > 0 else row_seg[:0]
    return Segments(
        n_src=n_src,
        n_rows=n_rows,
        n_segments=n_segments,
        tile=tile,
        seg_ptrs=_i32(seg_ptrs),
        tile_seg=_i32(tile_seg),
        row_seg=_i32(row_seg),
        perm=_i32(perm),
        inv=_i32(inv),
        row_valid=torch.from_numpy(row_valid),
        seg_ptrs_static=tuple(int(p) for p in seg_ptrs),
    )


def _build_compact(rel: np.ndarray, node: np.ndarray, num_nodes: int,
                   num_rels: int, tile: int,
                   num_padded_edges: int) -> CompactInfo:
    """Unique (relation, node) pairs, the direct-index edge map and its
    sorted segmentations (see :class:`CompactInfo`)."""
    pair_rel, pair_node, inverse = unique_pairs(rel, node, num_nodes)
    E = int(rel.shape[0])
    seg = build_segments(pair_rel, num_rels, tile)
    inv = seg.inv.numpy()
    node_ids = np.zeros(seg.n_rows, dtype=np.int64)
    node_ids[inv] = pair_node
    # canonical edge -> padded compact row; padding edges map to row 0
    edge_map = np.zeros(num_padded_edges, dtype=np.int64)
    edge_map[:E] = inv[inverse]
    # real edges ordered by compact row, padding appended past
    # edge_row_ptr[-1], where the segment sum never reads
    edge_sort = counting_argsort(edge_map[:E])
    edge_sort_perm = np.concatenate(
        [edge_sort, np.arange(E, num_padded_edges, dtype=np.int64)]
    )
    edge_row_ptr = np.zeros(seg.n_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(edge_map[:E], minlength=seg.n_rows),
              out=edge_row_ptr[1:])
    # compact rows ordered by node id; padding rows sort past
    # node_row_ptr[-1]
    real_node = seg.row_valid.numpy() & (node_ids < num_nodes)
    node_key = np.where(real_node, node_ids, num_nodes)
    node_sort_perm = counting_argsort(node_key)
    node_row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(node_ids[real_node], minlength=num_nodes),
              out=node_row_ptr[1:])
    return CompactInfo(
        seg=seg,
        node_ids=_i32(node_ids),
        edge_map=_i32(edge_map),
        edge_sort_perm=_i32(edge_sort_perm),
        edge_row_ptr=_i32(edge_row_ptr),
        node_sort_perm=_i32(node_sort_perm),
        node_row_ptr=_i32(node_row_ptr),
    )


def _canonical_runs(c_dst: np.ndarray, c_rel: np.ndarray,
                    compact_dst: CompactInfo):
    """``canon_ptr`` and ``canon_to_row``: the canonical (dst, rel) runs
    are contiguous, so dst-compact reductions need no edge permute."""
    E = int(c_dst.shape[0])
    if E:
        change = (c_dst[1:] != c_dst[:-1]) | (c_rel[1:] != c_rel[:-1])
        starts = np.concatenate([[0], np.nonzero(change)[0] + 1])
        starts = starts.astype(np.int64)
    else:
        starts = np.zeros(0, dtype=np.int64)
    n_runs = int(starts.shape[0])
    runs_cap = compact_dst.seg.n_src
    assert n_runs <= runs_cap, (n_runs, runs_cap)
    canon_ptr = np.concatenate(
        [starts, np.full(runs_cap - n_runs + 1, E, dtype=np.int64)]
    )
    run_row = compact_dst.edge_map.numpy()[starts]
    to_run = np.full(compact_dst.seg.n_rows, runs_cap, dtype=np.int64)
    to_run[run_row] = np.arange(n_runs, dtype=np.int64)
    return _i32(canon_ptr), _i32(to_run)


def build_heterograph(
    src: np.ndarray,
    dst: np.ndarray,
    rel: np.ndarray,
    num_nodes: int,
    num_rels: Optional[int] = None,
    *,
    ntype_offsets: Optional[Sequence[int]] = None,
    rel_names: Optional[Sequence[str]] = None,
    tile: int = 128,
    build_compact: bool = True,
    compact_union: bool = False,
) -> HeteroGraph:
    """Build a :class:`HeteroGraph` from COO arrays in any edge order.

    ``tile`` is the relation-segment padding granularity.  Node types are
    the contiguous id ranges of ``ntype_offsets`` (one type by default)."""
    if compact_union:
        raise NotImplementedError(
            "union-list compact (compact_union) is not ported yet; "
            "see ROADMAP.md, 'The rest of RGAT: the union-compact branch'"
        )
    src = np.asarray(src).astype(np.int64).ravel()
    dst = np.asarray(dst).astype(np.int64).ravel()
    rel = np.asarray(rel).astype(np.int64).ravel()
    E = int(src.shape[0])
    if dst.shape[0] != E or rel.shape[0] != E:
        raise ValueError("src, dst and rel must have one entry per edge")
    if num_rels is None:
        num_rels = int(rel.max()) + 1 if E else 1
    if E and not (
        0 <= src.min() and src.max() < num_nodes
        and 0 <= dst.min() and dst.max() < num_nodes
        and 0 <= rel.min() and rel.max() < num_rels
    ):
        raise ValueError("edge endpoint or relation id out of range")
    if num_nodes >= 2**31 or E >= 2**31:
        raise ValueError("graph too large for int32 indices")

    order = canonical_sort(src, dst, rel)
    c_src, c_dst, c_rel = src[order], dst[order], rel[order]

    EP = max(round_up(E, EDGE_PAD), EDGE_PAD) + EDGE_EXTRA
    pad = EP - E
    p_src = np.concatenate([c_src, np.full(pad, num_nodes, dtype=np.int64)])
    p_dst = np.concatenate([c_dst, np.full(pad, num_nodes, dtype=np.int64)])
    p_rel = np.concatenate([c_rel, np.zeros(pad, dtype=np.int64)])
    p_eid = np.concatenate([order, np.zeros(pad, dtype=np.int64)])

    in_deg = np.bincount(c_dst, minlength=num_nodes).astype(np.int64)
    out_deg = np.bincount(c_src, minlength=num_nodes).astype(np.int64)
    in_row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(in_deg, out=in_row_ptr[1:])

    # src-sorted canonical positions; padding slots point at padding edges
    out_perm = np.concatenate(
        [counting_argsort(c_src), np.arange(E, EP, dtype=np.int64)]
    )
    out_row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(out_deg, out=out_row_ptr[1:])

    # relation segments cover every padded edge slot (padding edges go to
    # relation 0 and are marked invalid)
    edge_rel_seg = build_segments(p_rel, num_rels, tile)
    erv = edge_rel_seg.row_valid.numpy() & (
        p_src[edge_rel_seg.perm.numpy()] < num_nodes
    )
    edge_rel_seg = dataclasses.replace(
        edge_rel_seg, row_valid=torch.from_numpy(erv)
    )

    if ntype_offsets is None:
        ntype_offsets = (0, num_nodes)
    ntype_offsets = tuple(int(o) for o in ntype_offsets)
    num_ntypes = len(ntype_offsets) - 1
    node_ntype = np.zeros(num_nodes, dtype=np.int64)
    for t in range(num_ntypes):
        node_ntype[ntype_offsets[t]: ntype_offsets[t + 1]] = t
    ntype_seg = build_segments(node_ntype, num_ntypes, tile)

    compact_src = compact_dst = None
    if build_compact:
        compact_src = _build_compact(c_rel, c_src, num_nodes, num_rels,
                                     tile, EP)
        compact_dst = _build_compact(c_rel, c_dst, num_nodes, num_rels,
                                     tile, EP)
        canon_ptr, canon_to_row = _canonical_runs(c_dst, c_rel, compact_dst)
        compact_dst = dataclasses.replace(compact_dst, canon_ptr=canon_ptr,
                               canon_to_row=canon_to_row)

    if rel_names is None:
        rel_names = tuple(f"rel{i}" for i in range(num_rels))
    return HeteroGraph(
        num_nodes=int(num_nodes),
        num_edges=E,
        num_padded_edges=EP,
        num_rels=int(num_rels),
        num_ntypes=num_ntypes,
        ntype_offsets=ntype_offsets,
        rel_names=tuple(rel_names),
        src=_i32(p_src),
        dst=_i32(p_dst),
        rel=_i32(p_rel),
        eid_orig=_i32(p_eid),
        in_row_ptr=_i32(in_row_ptr),
        edge_rel_seg=edge_rel_seg,
        out_perm=_i32(out_perm),
        out_row_ptr=_i32(out_row_ptr),
        ntype_seg=ntype_seg,
        compact_src=compact_src,
        compact_dst=compact_dst,
        in_deg=_i32(in_deg),
        out_deg=_i32(out_deg),
    )

