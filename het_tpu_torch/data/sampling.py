"""Neighbour sampling of seed nodes' in-neighbourhoods (counterpart of
``het_tpu/data/sampling.py``): each batch becomes an ordinary
:class:`HeteroGraph`, so the whole op and kernel stack runs on it as on a
full graph.

A batch is made in two parts, timed apart by the minibatch trainer:

* :meth:`NeighborSampler.draw` walks the in-CSR hop by hop in the port's
  host library (``graph/native.py::sample_fanout``, the counterpart of
  het_tpu's native sampler) and returns the local edge lists and
  ``node_map`` (local id -> node id).  The seeds take the first local
  ids, de-duplicated in first-seen order; a node with in-degree at most
  ``fanout`` takes all its in-edges in CSR order, any other node
  ``fanout`` distinct ones uniformly at random (Floyd's draws); new nodes
  take local ids in order of first appearance, hop by hop; past the caps
  ``max_edges`` / ``max_nodes`` a hop ends or a new node is dropped.
  Each draw seeds the library's ``mt19937_64`` with one
  ``integers(0, 2**63 - 1)`` of the sampler's generator, as het_tpu's
  ``sample`` does, so the two packages draw the same batches from the
  same ``seed`` and the same calls.
* :meth:`NeighborSampler.draw_plain` is the plain version, vectorised in
  numpy over each hop's frontier: the same contract, a node's picks kept
  in CSR order, its random stream its own (``rng.random``).
* :meth:`NeighborSampler.finalize` builds the subgraph from them, padded
  to fixed sizes (``pad_nodes_to`` extra isolated nodes mapped to node 0,
  ``pad_edges_to`` padded edges, and with ``build_compact`` the compact
  tables forced to their worst-case size), as het_tpu's ``_finalize``
  does, so that both packages build the same graph from one draw.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..graph import native
from ..graph.build import build_heterograph
from ..graph.convert import coo_to_csr
from ..graph.structures import HeteroGraph


def _ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """``concatenate([arange(s, s + c) for s, c in zip(starts, counts)])``
    without a Python loop."""
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(counts)
    shift = np.repeat(starts - (ends - counts), counts)
    return np.arange(total, dtype=np.int64) + shift


class NeighborSampler:
    """Uniform fanout sampling of in-neighbourhoods around seed nodes."""

    def __init__(self, src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                 num_nodes: int, num_rels: int, fanout: int = 10,
                 num_hops: int = 2, seed: int = 0):
        src = np.asarray(src).astype(np.int64).ravel()
        dst = np.asarray(dst).astype(np.int64).ravel()
        rel = np.asarray(rel).astype(np.int64).ravel()
        self.num_nodes = int(num_nodes)
        self.num_rels = int(num_rels)
        self.fanout = int(fanout)
        self.num_hops = int(num_hops)
        self.rng = np.random.default_rng(seed)
        # in-CSR: the in-edges of node v at ptr[v]:ptr[v + 1]
        self.ptr, _, packed = coo_to_csr(dst, src, np.stack([src, rel], 1),
                                         num_nodes)
        self.nbr_src = np.ascontiguousarray(packed[:, 0])
        self.nbr_rel = np.ascontiguousarray(packed[:, 1])
        native.check_csr(self.ptr, self.nbr_src, self.nbr_rel,
                         self.num_nodes)
        # node -> local id of the batch being drawn (-1: not in it); reset
        # after each draw on the entries it set
        self._local = np.full(self.num_nodes, -1, dtype=np.int64)

    def max_edges(self, n_seeds: int) -> int:
        """The most edges a draw of ``n_seeds`` seeds can take."""
        return n_seeds * sum(self.fanout ** h
                             for h in range(1, self.num_hops + 1))

    def _pick(self, frontier: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The in-edges each frontier node takes, as CSR positions in
        frontier order, and the number each node takes."""
        lo = self.ptr[frontier]
        deg = self.ptr[frontier + 1] - lo
        pos = _ranges(lo, deg)
        owner = np.repeat(np.arange(frontier.size), deg)
        big = deg > self.fanout
        if big.any():
            # a random permutation of each large node's edges: keep the
            # first ``fanout`` of it, then restore CSR order
            cand = np.flatnonzero(big[owner])
            key = owner[cand] + self.rng.random(cand.size)
            order = cand[np.argsort(key, kind="stable")]
            starts = np.cumsum(deg[big]) - deg[big]
            rank = np.arange(order.size) - np.repeat(starts, deg[big])
            keep = np.ones(pos.size, dtype=bool)
            keep[order[rank >= self.fanout]] = False
            pos = pos[keep]
        return pos, np.minimum(deg, self.fanout)

    def _caps(self, seeds, max_edges, max_nodes):
        """The caps of a draw of ``seeds``: by default the most a draw of
        ``len(seeds)`` seeds can take (plus one edge, as het_tpu's)."""
        seeds = np.asarray(seeds).astype(np.int64).ravel()
        cap_e = (self.max_edges(len(seeds)) + 1 if max_edges is None
                 else max_edges)
        cap_n = cap_e + len(seeds) if max_nodes is None else max_nodes
        return seeds, cap_e, cap_n

    def draw(self, seeds: np.ndarray, *, max_edges: Optional[int] = None,
             max_nodes: Optional[int] = None
             ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """``(edges_src, edges_dst, edges_rel, node_map)``: the sampled
        edges in local ids (``int64``) and each local node's id, drawn in
        the host library."""
        seeds, cap_e, cap_n = self._caps(seeds, max_edges, max_nodes)
        return native.sample_fanout(
            self.ptr, self.nbr_src, self.nbr_rel, seeds, self.fanout,
            self.num_hops, int(self.rng.integers(0, 2**63 - 1)),
            self.num_nodes, cap_e, cap_n, local=self._local,
            csr_checked=True)

    def draw_plain(self, seeds: np.ndarray, *,
                   max_edges: Optional[int] = None,
                   max_nodes: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                              np.ndarray]:
        """:meth:`draw`'s plain version, in numpy: the same contract, its
        own random stream."""
        seeds, cap_e, cap_n = self._caps(seeds, max_edges, max_nodes)
        if seeds.size and (seeds.min() < 0
                           or seeds.max() >= self.num_nodes):
            raise ValueError("draw_plain: a seed is not a node id")
        local = self._local
        _, first = np.unique(seeds, return_index=True)
        frontier = seeds[np.sort(first)][:cap_n]
        local[frontier] = np.arange(frontier.size)
        nodes = [frontier]
        n_nodes, n_edges = int(frontier.size), 0
        es, ed, er = [], [], []
        try:
            for _ in range(self.num_hops):
                pos, counts = self._pick(frontier)
                node_of = np.repeat(np.arange(frontier.size), counts)
                u = self.nbr_src[pos]
                # new nodes in order of first appearance
                fresh = np.flatnonzero(local[u] < 0)
                uniq, first = np.unique(u[fresh], return_index=True)
                order = np.argsort(first, kind="stable")
                new, first_pick = uniq[order], fresh[first[order]]
                # past the node cap a new node is dropped with its edges
                room = cap_n - n_nodes
                kept = np.ones(u.size, dtype=bool)
                if room < new.size:
                    local[new[room:]] = -2
                    kept = local[u] != -2
                    local[new[room:]] = -1
                # the edge cap: the hop ends at the first node whose picks
                # do not fit beside the edges kept before it
                per = np.bincount(node_of[kept], minlength=frontier.size)
                kept_before = np.cumsum(per) - per
                over = np.flatnonzero(n_edges + kept_before + counts > cap_e)
                n_new = min(room, new.size)
                if over.size:
                    kept &= node_of < over[0]
                    n_new = min(n_new, int(np.count_nonzero(
                        node_of[first_pick] < over[0])))
                new = new[:n_new]
                local[new] = n_nodes + np.arange(new.size)
                es.append(local[u[kept]])
                ed.append(local[frontier[node_of[kept]]])
                er.append(self.nbr_rel[pos[kept]])
                n_edges += int(np.count_nonzero(kept))
                n_nodes += int(new.size)
                nodes.append(new)
                frontier = new
                if frontier.size == 0:
                    break
            node_map = np.concatenate(nodes)
        finally:
            for part in nodes:
                local[part] = -1
        empty = np.zeros(0, dtype=np.int64)
        return (np.concatenate(es) if es else empty,
                np.concatenate(ed) if ed else empty,
                np.concatenate(er) if er else empty, node_map)

    def finalize(self, edges_s: np.ndarray, edges_d: np.ndarray,
                 edges_r: np.ndarray, node_map: np.ndarray, *,
                 tile: int = 8, pad_edges_to: Optional[int] = None,
                 pad_nodes_to: Optional[int] = None,
                 build_compact: bool = False
                 ) -> Tuple[HeteroGraph, np.ndarray]:
        """The subgraph of a draw and its ``node_map``, padded to fixed
        sizes so that every batch has the same shapes: ``pad_nodes_to``
        nodes (the extra ones isolated, mapped to node 0) and
        ``pad_edges_to`` padded edges with the relation rows and node-type
        rows forced to match; with ``build_compact`` the compact tables
        forced to the worst case, every edge its own (relation, node)
        pair (``het_tpu/data/sampling.py::_finalize``)."""
        node_map = np.asarray(node_map).astype(np.int64)
        n_local = len(node_map)
        if pad_nodes_to is not None:
            if pad_nodes_to < n_local:
                raise ValueError(f"{n_local} sampled nodes do not fit "
                                 f"pad_nodes_to={pad_nodes_to}")
            node_map = np.concatenate(
                [node_map, np.zeros(pad_nodes_to - n_local, np.int64)])
        num_nodes = pad_nodes_to or n_local
        force = None
        if pad_edges_to:
            t = max(tile, 1)
            rows_cap = -(-pad_edges_to // t) * t + self.num_rels * t
            force = {"num_padded_edges": pad_edges_to,
                     "edge_rel_rows": rows_cap,
                     "ntype_rows": -(-num_nodes // t) * t}
            if build_compact:
                force.update(compact_src_pairs=pad_edges_to,
                             compact_dst_pairs=pad_edges_to,
                             compact_src_rows=rows_cap,
                             compact_dst_rows=rows_cap)
        sub = build_heterograph(
            np.asarray(edges_s), np.asarray(edges_d), np.asarray(edges_r),
            num_nodes=num_nodes, num_rels=self.num_rels, tile=tile,
            force_sizes=force, build_compact=build_compact)
        return sub, node_map

    def sample(self, seeds: np.ndarray, *, tile: int = 8,
               pad_edges_to: Optional[int] = None,
               pad_nodes_to: Optional[int] = None,
               build_compact: bool = False
               ) -> Tuple[HeteroGraph, np.ndarray]:
        """``(subgraph, node_map)`` of one batch: :meth:`draw` capped at
        the pads (or at the most a draw can take), then
        :meth:`finalize`."""
        cap_e = pad_edges_to or self.max_edges(len(seeds)) + 1
        drawn = self.draw(seeds, max_edges=cap_e,
                          max_nodes=pad_nodes_to or cap_e + len(seeds))
        return self.finalize(*drawn, tile=tile, pad_edges_to=pad_edges_to,
                             pad_nodes_to=pad_nodes_to,
                             build_compact=build_compact)
