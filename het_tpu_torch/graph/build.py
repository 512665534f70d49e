"""Host-side construction of :class:`HeteroGraph`.

The same layout ``het_tpu.graph.build`` produces, field for field and bit
for bit: one canonical dst-sorted edge order, tile-padded relation
segments and the dual-list compact materialization with its sorted
segmentations.  The result holds CPU tensors; move it with ``.to(device)``.

The sorts and counts run in the port's host library
(``graph/native.py``) where het_tpu's builder runs its native library;
``sorts="plain"`` takes their numpy versions (``graph/convert.py``)
instead, for a caller comparing the two.  Both give the same graph.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..utils import spans
from . import convert, native
from .structures import CompactInfo, HeteroGraph, Segments

__all__ = ["build_segments", "build_heterograph", "reverse_heterograph"]

# canonical edge arrays: padded to a multiple of EDGE_PAD, plus EDGE_EXTRA
# sentinel rows, as the JAX package pads them (its Pallas DMA guard rows)
EDGE_PAD, EDGE_EXTRA = 128, 1024


class HostSorts(NamedTuple):
    """The builder's sorts and counts, each with ``graph/native.py``'s
    signature."""

    canonical_sort: Callable  # (src, dst, rel, num_nodes, num_rels)
    counting_argsort: Callable  # (keys, num_keys)
    unique_pairs: Callable  # (rel, node, num_nodes, num_rels)
    bincount: Callable  # (ids, num_bins)


SORTS = {
    "native": HostSorts(native.canonical_sort, native.counting_argsort,
                        native.unique_pairs, native.bincount),
    "plain": HostSorts(
        lambda src, dst, rel, n, r: convert.canonical_sort(src, dst, rel),
        lambda keys, n: convert.counting_argsort(keys),
        lambda rel, node, n, r: convert.unique_pairs(rel, node, n),
        lambda ids, n: np.bincount(ids, minlength=n)),
}


def _sorts(sorts: str) -> HostSorts:
    if sorts not in SORTS:
        raise ValueError(f"sorts={sorts!r}: expected one of {list(SORTS)}")
    return SORTS[sorts]


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _i32(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.int32)))


def build_segments(seg_of_row: np.ndarray, n_segments: int,
                   tile: int, force_rows: Optional[int] = None,
                   sorts: str = "native") -> Segments:
    """Group source rows by segment id, padding each segment to a multiple
    of ``tile`` rows so every row tile is single-segment.

    ``force_rows`` pads the total to a fixed size (the extra invalid rows
    go to the last segment), so that the shards of a partitioned graph
    share their shapes (``het_tpu_torch.parallel.partition``)."""
    hs = _sorts(sorts)
    seg_of_row = np.asarray(seg_of_row)
    n_src = int(seg_of_row.shape[0])
    order = hs.counting_argsort(seg_of_row, n_segments)
    counts = hs.bincount(seg_of_row, n_segments).astype(np.int64)
    padded = ((counts + tile - 1) // tile * tile) if tile > 1 else counts
    seg_ptrs = np.zeros(n_segments + 1, dtype=np.int64)
    np.cumsum(padded, out=seg_ptrs[1:])
    if force_rows is not None:
        if force_rows < seg_ptrs[-1] or force_rows % max(tile, 1):
            raise ValueError(f"force_rows={force_rows} is below "
                             f"{seg_ptrs[-1]} rows or not a multiple of "
                             f"the tile {tile}")
        seg_ptrs[-1] = force_rows
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
                   num_rels: int, tile: int, num_padded_edges: int,
                   force_rows: Optional[int] = None,
                   force_pairs: Optional[int] = None,
                   sorts: str = "native") -> CompactInfo:
    """Unique (relation, node) pairs, the direct-index edge map and its
    sorted segmentations (see :class:`CompactInfo`).

    ``force_pairs`` pads the pair count with dummy (last relation,
    sentinel node) pairs so that partitioned shards share one shape: a
    dummy row gathers the zero sentinel row and no edge refers to it, so
    its gradient is exactly zero.  ``force_rows`` is
    :func:`build_segments`'."""
    pair_rel, pair_node, inverse = _sorts(sorts).unique_pairs(
        rel, node, num_nodes, num_rels)
    return _compact_from_pairs(pair_rel, pair_node, inverse,
                               int(rel.shape[0]), num_nodes, num_rels, tile,
                               num_padded_edges, force_rows, force_pairs,
                               sorts=sorts)


def _compact_from_pairs(pair_rel, pair_node, inverse, E: int,
                        num_nodes: int, num_rels: int, tile: int,
                        num_padded_edges: int, force_rows: Optional[int],
                        force_pairs: Optional[int],
                        seg: Optional[Segments] = None,
                        node_ids: Optional[np.ndarray] = None,
                        sorts: str = "native") -> CompactInfo:
    """Segment and pad the unique pairs, unless a shared ``seg`` and its
    ``node_ids`` are given (the union-list build), and attach the edge
    map and the sorted segmentations."""
    hs = _sorts(sorts)
    if seg is None:
        pair_rel = pair_rel.astype(np.int64)
        pair_node = pair_node.astype(np.int64)
        if force_pairs is not None:
            extra = force_pairs - int(pair_rel.shape[0])
            if extra < 0:
                raise ValueError(f"force_pairs={force_pairs} is below the "
                                 f"{pair_rel.shape[0]} pairs")
            pair_rel = np.concatenate(
                [pair_rel, np.full(extra, num_rels - 1, dtype=np.int64)])
            pair_node = np.concatenate(
                [pair_node, np.full(extra, num_nodes, dtype=np.int64)])
        seg = build_segments(pair_rel, num_rels, tile, force_rows=force_rows,
                             sorts=sorts)
        node_ids = np.zeros(seg.n_rows, dtype=np.int64)
        node_ids[seg.inv.numpy()] = pair_node
    inv = seg.inv.numpy()
    # canonical edge -> padded compact row; padding edges map to row 0
    edge_map = np.zeros(num_padded_edges, dtype=np.int64)
    edge_map[:E] = inv[inverse]
    # real edges ordered by compact row, padding appended past
    # edge_row_ptr[-1], where the segment sum never reads
    edge_sort = hs.counting_argsort(edge_map[:E], seg.n_rows)
    edge_sort_perm = np.concatenate(
        [edge_sort, np.arange(E, num_padded_edges, dtype=np.int64)]
    )
    edge_row_ptr = np.zeros(seg.n_rows + 1, dtype=np.int64)
    np.cumsum(hs.bincount(edge_map[:E], seg.n_rows), out=edge_row_ptr[1:])
    # compact rows ordered by node id; padding rows sort past
    # node_row_ptr[-1]
    real_node = seg.row_valid.numpy() & (node_ids < num_nodes)
    node_key = np.where(real_node, node_ids, num_nodes)
    node_sort_perm = hs.counting_argsort(node_key, num_nodes + 1)
    node_row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
    np.cumsum(hs.bincount(node_ids[real_node], num_nodes),
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


def _build_compact_union(rel: np.ndarray, src: np.ndarray, dst: np.ndarray,
                         num_nodes: int, num_rels: int, tile: int,
                         num_padded_edges: int,
                         force_rows: Optional[int] = None,
                         force_pairs: Optional[int] = None,
                         sorts: str = "native"):
    """Union-list compact rows (the reference's default ``Enabled``
    kind): one unique (relation, node) row space over the sources and the
    destinations together, returned as a (source view, destination view)
    pair over the same padded rows.  One projection a union row then
    serves both attention sides.  Needs one node space."""
    E = int(rel.shape[0])
    pair_rel, pair_node, inverse = _sorts(sorts).unique_pairs(
        np.concatenate([rel, rel]), np.concatenate([src, dst]), num_nodes,
        num_rels)
    info_src = _compact_from_pairs(pair_rel, pair_node, inverse[:E], E,
                                   num_nodes, num_rels, tile,
                                   num_padded_edges, force_rows, force_pairs,
                                   sorts=sorts)
    info_dst = _compact_from_pairs(None, None, inverse[E:], E, num_nodes,
                                   num_rels, tile, num_padded_edges, None,
                                   None, seg=info_src.seg,
                                   node_ids=info_src.node_ids.numpy()
                                   .astype(np.int64), sorts=sorts)
    return info_src, info_dst


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


def _with_canonical_runs(c_dst, c_rel,
                         compact_dst: CompactInfo) -> CompactInfo:
    """``compact_dst`` with its canonical (dst, rel) runs."""
    canon_ptr, canon_to_row = _canonical_runs(c_dst, c_rel, compact_dst)
    return dataclasses.replace(compact_dst, canon_ptr=canon_ptr,
                               canon_to_row=canon_to_row)


def _node_types(num_nodes, ntype_offsets, node_ntype, tile, force_rows,
                sorts):
    """``ntype_offsets``, the type count and ``ntype_seg``: node types from
    contiguous id ranges, or from an explicit per-node array (a shard's
    destination range may span type boundaries)."""
    if ntype_offsets is None:
        ntype_offsets = (0, num_nodes)
    ntype_offsets = tuple(int(o) for o in ntype_offsets)
    num_ntypes = len(ntype_offsets) - 1
    if node_ntype is not None:
        node_ntype = np.asarray(node_ntype, dtype=np.int64)
        if node_ntype.shape[0] != num_nodes:
            raise ValueError("node_ntype needs one entry per node")
        if num_nodes:
            num_ntypes = max(num_ntypes, int(node_ntype.max()) + 1)
    else:
        node_ntype = np.zeros(num_nodes, dtype=np.int64)
        for t in range(num_ntypes):
            node_ntype[ntype_offsets[t]: ntype_offsets[t + 1]] = t
    ntype_seg = build_segments(node_ntype, num_ntypes, tile,
                               force_rows=force_rows, sorts=sorts)
    return ntype_offsets, num_ntypes, ntype_seg


@spans.setup("graph.build")
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
    force_sizes: Optional[Dict[str, int]] = None,
    src_space: Optional[int] = None,
    node_ntype: Optional[np.ndarray] = None,
    sorts: str = "native",
) -> HeteroGraph:
    """Build a :class:`HeteroGraph` from COO arrays in any edge order.

    ``tile`` is the relation-segment padding granularity.  Node types are
    the contiguous id ranges of ``ntype_offsets`` (one type by default),
    or ``node_ntype``, one type per node.  ``src_space`` is the number of
    source rows when it differs from ``num_nodes`` (a shard of a
    partitioned graph); padding edges then take ``src = src_space``.
    ``force_sizes`` pads the sizes a partitioned graph's shards must share
    (keys as ``het_tpu_torch.parallel.partition._force_size_keys``).
    ``compact_union`` builds the union-list compact kind: ``compact_src``
    and ``compact_dst`` are two views of one row space
    (``compact_shared``).  ``sorts`` is "native" (the host library) or
    "plain" (numpy); the graph is the same."""
    src = np.asarray(src).astype(np.int64).ravel()
    dst = np.asarray(dst).astype(np.int64).ravel()
    rel = np.asarray(rel).astype(np.int64).ravel()
    E = int(src.shape[0])
    if dst.shape[0] != E or rel.shape[0] != E:
        raise ValueError("src, dst and rel must have one entry per edge")
    if num_rels is None:
        num_rels = int(rel.max()) + 1 if E else 1
    if src_space is None:
        src_space = num_nodes
    if E and not (
        0 <= src.min() and src.max() < src_space
        and 0 <= dst.min() and dst.max() < num_nodes
        and 0 <= rel.min() and rel.max() < num_rels
    ):
        raise ValueError("edge endpoint or relation id out of range")
    if max(num_nodes, src_space) >= 2**31 or E >= 2**31:
        raise ValueError("graph too large for int32 indices")
    force = force_sizes or {}
    hs = _sorts(sorts)

    with spans.setup("graph.sort"):
        # the canonical sort's key bound: a shard's sources index its
        # source space
        order = hs.canonical_sort(src, dst, rel, max(num_nodes, src_space),
                                  num_rels)
        c_src, c_dst, c_rel = src[order], dst[order], rel[order]

        EP = max(round_up(E, EDGE_PAD), EDGE_PAD) + EDGE_EXTRA
        EP = max(EP, force.get("num_padded_edges", 0))
        pad = EP - E
        p_src = np.concatenate([c_src, np.full(pad, src_space,
                                               dtype=np.int64)])
        p_dst = np.concatenate([c_dst, np.full(pad, num_nodes,
                                               dtype=np.int64)])
        p_rel = np.concatenate([c_rel, np.zeros(pad, dtype=np.int64)])
        p_eid = np.concatenate([order, np.zeros(pad, dtype=np.int64)])

    with spans.setup("graph.segments"):
        in_deg = hs.bincount(c_dst, num_nodes).astype(np.int64)
        out_deg = hs.bincount(c_src, src_space).astype(np.int64)
        in_row_ptr = np.zeros(num_nodes + 1, dtype=np.int64)
        np.cumsum(in_deg, out=in_row_ptr[1:])

        # src-sorted canonical positions; padding slots point at padding
        # edges
        out_perm = np.concatenate(
            [hs.counting_argsort(c_src, src_space + 1),
             np.arange(E, EP, dtype=np.int64)]
        )
        out_row_ptr = np.zeros(src_space + 1, dtype=np.int64)
        np.cumsum(out_deg, out=out_row_ptr[1:])

        # relation segments cover every padded edge slot (padding edges go
        # to relation 0 and are marked invalid)
        edge_rel_seg = build_segments(p_rel, num_rels, tile,
                                      force_rows=force.get("edge_rel_rows"),
                                      sorts=sorts)
        erv = edge_rel_seg.row_valid.numpy() & (
            p_src[edge_rel_seg.perm.numpy()] < src_space
        )
        edge_rel_seg = dataclasses.replace(
            edge_rel_seg, row_valid=torch.from_numpy(erv)
        )

    with spans.setup("graph.ntypes"):
        ntype_offsets, num_ntypes, ntype_seg = _node_types(
            num_nodes, ntype_offsets, node_ntype, tile,
            force.get("ntype_rows"), sorts)

    compact_src = compact_dst = None
    if build_compact and compact_union:
        if src_space != num_nodes:
            raise ValueError("union-list compact needs one node space; the "
                             "shards of a partitioned graph use the "
                             "dual-list kind")
        with spans.setup("graph.compact.union"):
            compact_src, compact_dst = _build_compact_union(
                c_rel, c_src, c_dst, num_nodes, num_rels, tile, EP,
                force_rows=force.get("compact_src_rows"),
                force_pairs=force.get("compact_src_pairs"), sorts=sorts)
            compact_dst = _with_canonical_runs(c_dst, c_rel, compact_dst)
    elif build_compact:
        with spans.setup("graph.compact.src"):
            compact_src = _build_compact(
                c_rel, c_src, src_space, num_rels, tile, EP,
                force_rows=force.get("compact_src_rows"),
                force_pairs=force.get("compact_src_pairs"), sorts=sorts)
        with spans.setup("graph.compact.dst"):
            compact_dst = _with_canonical_runs(c_dst, c_rel, _build_compact(
                c_rel, c_dst, num_nodes, num_rels, tile, EP,
                force_rows=force.get("compact_dst_rows"),
                force_pairs=force.get("compact_dst_pairs"), sorts=sorts))

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
        num_src_space=0 if src_space == num_nodes else int(src_space),
        compact_shared=bool(build_compact and compact_union),
    )


def reverse_heterograph(g: HeteroGraph, **kw) -> HeteroGraph:
    """``g`` with every edge reversed, every derived structure built anew
    (``het_tpu/graph/build.py::reverse_heterograph``): the same nodes,
    relations, node types, relation names and tile; ``kw`` goes to
    :func:`build_heterograph` (``build_compact``, ...)."""
    E = g.num_edges
    return build_heterograph(
        g.dst[:E].cpu().numpy(), g.src[:E].cpu().numpy(),
        g.rel[:E].cpu().numpy(), g.num_nodes, g.num_rels,
        ntype_offsets=g.ntype_offsets, rel_names=g.rel_names,
        tile=g.edge_rel_seg.tile, **kw)
