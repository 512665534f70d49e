"""Host-side partitioning of a heterograph by destination ranges.

Counterpart of ``het_tpu/parallel/partition.py``.  Edges are split into
``n_parts`` contiguous destination ranges, so that every aggregation stays
on the shard that owns its destinations and the only exchange a layer
needs is of source rows (``dp.halo_gather`` or ``dp.halo_exchange``).

Nodes are relabeled into a padded global space of ``n_parts *
nodes_per_part`` rows.  Each shard graph has local destinations
(``num_nodes = nodes_per_part``) and a source space of its own
(``HeteroGraph.src_space``): the padded global space for the all-gather,
or the boundary buffer ``[own sources | rows received from each peer]``.
Every size the shards share is padded to the largest shard's, as the JAX
package pads them for SPMD, so both packages build the same shards.

:func:`partition_by_dst` returns a list of shard graphs, one a rank: the
JAX package stacks them for ``shard_map``, the port has nothing to stack.
Relation offsets that differ between shards are dropped to
``seg_ptrs_static = None``, as there; a shard's typed linears then read
them on the device (``ops.linear.segment_matmul``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..graph.build import _i32, build_heterograph, round_up
from ..graph.structures import HeteroGraph

__all__ = ["PartitionInfo", "halo_back_index", "partition_by_dst"]


@dataclass(frozen=True)
class PartitionInfo:
    n_parts: int
    orig_per_part: int  # uniform node-range size per part (node-balanced)
    nodes_per_part: int  # padded (tile-aligned) per-shard node count
    num_global_nodes: int  # original N (before relabeling)
    # edge-balanced ranges: bounds[p] .. bounds[p+1] is part p's original
    # node range; None means uniform ranges of orig_per_part
    bounds: Optional[Tuple[int, ...]] = None

    @property
    def num_padded_global_nodes(self) -> int:
        return self.n_parts * self.nodes_per_part

    def part_of(self, node_ids: np.ndarray) -> np.ndarray:
        node_ids = np.asarray(node_ids)
        if self.bounds is None:
            return node_ids // self.orig_per_part
        return np.searchsorted(np.asarray(self.bounds), node_ids,
                               side="right") - 1

    def part_range(self, p: int) -> Tuple[int, int]:
        if self.bounds is None:
            lo = p * self.orig_per_part
            return lo, min(lo + self.orig_per_part, self.num_global_nodes)
        return self.bounds[p], self.bounds[p + 1]

    def relabel(self, node_ids: np.ndarray) -> np.ndarray:
        """Original node id -> padded global id."""
        node_ids = np.asarray(node_ids)
        part = self.part_of(node_ids)
        if self.bounds is None:
            local = node_ids % self.orig_per_part
        else:
            local = node_ids - np.asarray(self.bounds)[part]
        return part * self.nodes_per_part + local

    def pad_node_data(self, data: np.ndarray, fill=0) -> np.ndarray:
        """(N, ...) node-indexed data -> (num_padded_global_nodes, ...)."""
        data = np.asarray(data)
        out = np.full((self.num_padded_global_nodes,) + data.shape[1:], fill,
                      dtype=data.dtype)
        out[self.relabel(np.arange(self.num_global_nodes))] = data
        return out


def halo_back_index(self_idx: np.ndarray, send_idx: np.ndarray,
                    num_rows: int, valid=None) -> tuple:
    """The boundary exchange's backward as a sorted segment sum: the
    buffer slots ``[self_idx | send_idx rows]`` (each a local row id)
    stably sorted by local row, and the row pointer over ``num_rows``
    local rows, both int32 tensors.  ``seg_sum_sorted(ct_slots, ptr,
    perm)`` then adds every slot's cotangent into its row in slot order,
    without atomics.  Slots where ``valid`` (flat, slot order) is False,
    the padding, go past ``ptr[-1]`` and are never read: no edge reads
    them, so their cotangent is zero, which is all ``index_add_`` added."""
    rows = np.concatenate([np.asarray(self_idx).ravel(),
                           np.asarray(send_idx).ravel()]).astype(np.int64)
    valid = (np.ones(len(rows), bool) if valid is None
             else np.asarray(valid, bool).ravel())
    key = np.where(valid, rows, num_rows)  # padding sorts past every row
    perm = np.argsort(key, kind="stable")
    ptr = np.zeros(num_rows + 1, np.int64)
    np.cumsum(np.bincount(rows[valid], minlength=num_rows), out=ptr[1:])
    return _i32(ptr), _i32(perm)


def _force_size_keys(g: HeteroGraph) -> Dict[str, int]:
    d = {
        "num_padded_edges": g.num_padded_edges,
        "edge_rel_rows": g.edge_rel_seg.n_rows,
        "ntype_rows": g.ntype_seg.n_rows,
    }
    if g.compact_src is not None:
        d["compact_src_rows"] = g.compact_src.seg.n_rows
        d["compact_dst_rows"] = g.compact_dst.seg.n_rows
        d["compact_src_pairs"] = g.compact_src.seg.n_src
        d["compact_dst_pairs"] = g.compact_dst.seg.n_src
    return d


def _edge_balanced_bounds(dst, num_nodes, n_parts):
    """Range boundaries on the cumulative in-degree, so that each part
    owns about E / P edges; ranges strictly increasing and non-empty."""
    indeg = np.bincount(dst, minlength=num_nodes)
    cum = np.concatenate([[0], np.cumsum(indeg)])
    targets = np.arange(1, n_parts) * (len(dst) / n_parts)
    cuts = np.searchsorted(cum, targets, side="left")
    bounds = np.concatenate([[0], cuts, [num_nodes]])
    for p in range(1, n_parts + 1):
        bounds[p] = max(bounds[p], bounds[p - 1] + 1)
    bounds = np.minimum(bounds, num_nodes)
    bounds[-1] = num_nodes
    if not (np.diff(bounds) > 0).all():
        raise ValueError(f"too few nodes ({num_nodes}) for {n_parts} parts")
    return tuple(int(b) for b in bounds)


def partition_by_dst(
    src: np.ndarray,
    dst: np.ndarray,
    rel: np.ndarray,
    num_nodes: int,
    num_rels: int,
    n_parts: int,
    *,
    tile: int = 128,
    build_compact: bool = False,
    ntype_offsets=None,
    balance: str = "nodes",
    halo: str = "gather",
) -> Tuple[List[HeteroGraph], PartitionInfo]:
    """Split the edges into ``n_parts`` contiguous destination ranges:
    one shard graph a part, all of one shape, and the relabeling.

    ``balance="nodes"``: uniform destination ranges.  ``balance="edges"``:
    boundaries on the cumulative in-degree, so each shard owns about E / P
    edges (what skewed graphs need).

    ``halo`` picks the source exchange each layer makes:

    * ``"gather"``: shards index the padded global source space, and each
      layer all-gathers every node row;
    * ``"boundary"``: the unique source rows each (sender, receiver) pair
      needs are listed here; a shard's edges index the buffer
      ``[own sources | B_off rows from each peer]`` and each layer
      exchanges only those rows (``dp.halo_exchange``);
    * ``"auto"``: boundary, unless that buffer is no smaller than the
      all-gather's.  A shard built for the boundary exchange has
      ``halo_send_idx``; one built for the all-gather has None there."""
    src = np.asarray(src).astype(np.int64).ravel()
    dst = np.asarray(dst).astype(np.int64).ravel()
    rel = np.asarray(rel).astype(np.int64).ravel()
    if balance not in ("nodes", "edges"):
        raise ValueError(f"balance must be 'nodes' or 'edges', got {balance!r}")
    if halo not in ("gather", "boundary", "auto"):
        raise ValueError(f"halo must be 'gather', 'boundary' or 'auto', got "
                         f"{halo!r}")
    orig_per = -(-num_nodes // n_parts)
    if balance == "edges":
        bounds = _edge_balanced_bounds(dst, num_nodes, n_parts)
        widest = max(b - a for a, b in zip(bounds[:-1], bounds[1:]))
        per = round_up(widest, max(tile, 128))
    else:
        bounds = None
        per = round_up(orig_per, max(tile, 128))
    info = PartitionInfo(n_parts=n_parts, orig_per_part=orig_per,
                         nodes_per_part=per, num_global_nodes=num_nodes,
                         bounds=bounds)
    n_glob = info.num_padded_global_nodes
    part_of_dst = info.part_of(dst)

    # boundary lists: bl[p][q], the sorted unique original source ids in
    # part p's range that shard q's edges read
    halo_mode = "gather"
    bl = None
    b_self = b_off = 0
    if halo != "gather":
        part_of_src = info.part_of(src)
        bl = [[None] * n_parts for _ in range(n_parts)]
        for q in range(n_parts):
            m = part_of_dst == q
            sq, pq = src[m], part_of_src[m]
            for p in range(n_parts):
                bl[p][q] = np.unique(sq[pq == p])
        b_self = round_up(max([1] + [len(bl[q][q]) for q in range(n_parts)]),
                          8)
        b_off = round_up(max([1] + [len(bl[p][q]) for p in range(n_parts)
                                    for q in range(n_parts) if p != q]), 8)
        if halo == "boundary" or b_self + n_parts * b_off < n_parts * per:
            halo_mode = "boundary"

    def _src_boundary_ids(q: int, s: np.ndarray) -> np.ndarray:
        """Original source ids -> rows of shard q's boundary buffer."""
        p = info.part_of(s)
        out = np.empty(len(s), np.int64)
        for pp in range(n_parts):
            mm = p == pp
            if not mm.any():
                continue
            ranks = np.searchsorted(bl[pp][q], s[mm])
            out[mm] = (0 if pp == q else b_self + pp * b_off) + ranks
        return out

    # per-node types in original ids; a shard's destination range may span
    # type boundaries, so shards carry an explicit node_ntype array
    node_ntype_glob = None
    num_ntypes = 1
    if ntype_offsets is not None:
        ntype_offsets = tuple(int(o) for o in ntype_offsets)
        num_ntypes = len(ntype_offsets) - 1
        node_ntype_glob = np.zeros(num_nodes, dtype=np.int64)
        for t in range(num_ntypes):
            node_ntype_glob[ntype_offsets[t]: ntype_offsets[t + 1]] = t

    def _part_ntype(p: int):
        if node_ntype_glob is None:
            return None
        lo, hi = info.part_range(p)
        out = np.zeros(per, dtype=np.int64)
        out[: hi - lo] = node_ntype_glob[lo:hi]
        return out

    def build_part(p: int, force: Optional[dict]) -> HeteroGraph:
        m = part_of_dst == p
        if halo_mode == "boundary":
            part_src = _src_boundary_ids(p, src[m])
            space = b_self + n_parts * b_off
        else:
            part_src = info.relabel(src[m])
            space = n_glob
        return build_heterograph(
            part_src, dst[m] - info.part_range(p)[0], rel[m],
            num_nodes=per, num_rels=num_rels, tile=tile,
            build_compact=build_compact, force_sizes=force, src_space=space,
            node_ntype=_part_ntype(p),
            ntype_offsets=((0,) * num_ntypes + (per,)
                           if node_ntype_glob is not None else None),
        )

    # three sizing passes: forcing the padded edge total moves relation 0's
    # segment (padding edges live there) and forcing the compact pair counts
    # grows the last compact segment, so the row counts derived from them
    # are final only once those are fixed
    parts = [build_part(p, None) for p in range(n_parts)]

    def _maxes(keys):
        return {k: max(_force_size_keys(g)[k] for g in parts) for k in keys}

    keys0 = set(_force_size_keys(parts[0]))
    rows = {"edge_rel_rows", "compact_src_rows", "compact_dst_rows"}
    force = _maxes(keys0 - rows)
    parts = [build_part(p, force) for p in range(n_parts)]
    force.update(_maxes(keys0 & rows))
    parts = [build_part(p, force) for p in range(n_parts)]
    # every shard counts the largest edge total (extra slots are sentinel
    # edges), as the JAX package's static metadata must agree
    max_e = max(g.num_edges for g in parts)
    parts = [dataclasses.replace(g, num_edges=max_e) for g in parts]
    if halo_mode == "boundary":
        # shard p's own source rows and the rows it sends each peer q, as
        # local row ids
        def _local(p: int, ids: np.ndarray, width: int) -> np.ndarray:
            out = np.zeros(width, np.int64)
            out[: len(ids)] = ids - info.part_range(p)[0]
            return out

        for p in range(n_parts):
            own = _local(p, bl[p][p], b_self)
            send = np.stack([_local(p, bl[p][q] if q != p else bl[p][q][:0],
                                    b_off) for q in range(n_parts)])
            real = [len(bl[p][p])] + [len(bl[p][q]) if q != p else 0
                                      for q in range(n_parts)]
            valid = np.concatenate([
                np.arange(w) < k
                for k, w in zip(real, [b_self] + [b_off] * n_parts)])
            ptr, perm = halo_back_index(own, send, per, valid)
            parts[p] = dataclasses.replace(
                parts[p], halo_self_idx=_i32(own), halo_send_idx=_i32(send),
                halo_back_perm=perm, halo_back_ptr=ptr)
    return _drop_unshared_static(parts), info


def _drop_unshared_static(parts: List[HeteroGraph]) -> List[HeteroGraph]:
    """``seg_ptrs_static = None`` on every segmentation whose offsets
    differ between shards (per-shard relation sizes generally differ; only
    totals are forced equal).

    The JAX package does this because one SPMD program runs every shard.
    Here each rank runs its own program and could keep its own host
    offsets; they are dropped for parity with het_tpu's dispatch, which
    sends such shards' typed linears to the segment-matmul kernels
    (forward, dX, grouped dW), so a shard reaches those kernels as there.
    Per-relation ``torch.matmul`` on per-rank host offsets is the other
    choice (ROADMAP.md queue 1, "Per-rank host offsets on a shard")."""

    def fix_seg(segs):
        if segs[0] is None or all(s.seg_ptrs_static == segs[0].seg_ptrs_static
                                  for s in segs):
            return segs
        return [dataclasses.replace(s, seg_ptrs_static=None) for s in segs]

    def fix_ci(cis):
        if cis[0] is None:
            return cis
        segs = fix_seg([c.seg for c in cis])
        return [dataclasses.replace(c, seg=s) for c, s in zip(cis, segs)]

    ers = fix_seg([g.edge_rel_seg for g in parts])
    nts = fix_seg([g.ntype_seg for g in parts])
    css = fix_ci([g.compact_src for g in parts])
    cds = fix_ci([g.compact_dst for g in parts])
    return [dataclasses.replace(g, edge_rel_seg=e, ntype_seg=n,
                                compact_src=cs, compact_dst=cd)
            for g, e, n, cs, cd in zip(parts, ers, nts, css, cds)]
