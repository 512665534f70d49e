"""Graph containers: ``Segments``, ``CompactInfo`` and ``HeteroGraph``.

Counterparts of ``het_tpu.graph.structures`` with the same field names, as
plain frozen dataclasses holding torch index tensors (int32, ``row_valid``
bool).  Left out are the fields that only served TPU kernels: the
one-hot-reduce scheduling tables (``TileTables``, ``in_tables``,
``out_tables``, ``edge_tables``, ``node_tables``, ``canon_tables``) and
the ``perm_*`` maps of the perm_direct backward.

Canonical edge order is destination-sorted: edges stably sorted by
(dst, rel, src), padded with sentinel edges whose ``dst == num_nodes``.
Every aggregation is then a sorted segment sum over a row pointer, which
needs no atomics on the GPU either.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import torch


def _to(obj, device):
    """``dataclasses.replace`` with every tensor field moved to ``device``."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            kw[f.name] = v.to(device)
        elif dataclasses.is_dataclass(v):
            kw[f.name] = v.to(device)
    return dataclasses.replace(obj, **kw)


@dataclass(frozen=True)
class Segments:
    """A tile-padded, segment-partitioned row space: segment ``s`` occupies
    rows ``seg_ptrs[s]:seg_ptrs[s+1]``, a multiple of ``tile`` long."""

    n_src: int  # real (unpadded) source rows
    n_rows: int  # padded total rows
    n_segments: int
    tile: int
    seg_ptrs: torch.Tensor  # (n_segments + 1,)
    tile_seg: torch.Tensor  # (n_rows // tile,) segment id per row tile
    row_seg: torch.Tensor  # (n_rows,) segment id per padded row
    perm: torch.Tensor  # (n_rows,) source row per padded row (0 on padding)
    inv: torch.Tensor  # (n_src,) source row -> padded row
    row_valid: torch.Tensor  # (n_rows,) bool, False on padding rows
    # host copy of seg_ptrs: the per-relation row slices of segment_matmul.
    # None where the offsets live only in ``seg_ptrs`` on the device (the
    # shards of a partitioned graph whose relation sizes differ)
    seg_ptrs_static: Optional[Tuple[int, ...]] = None

    def to(self, device) -> "Segments":
        return _to(self, device)


@dataclass(frozen=True)
class CompactInfo:
    """Unique-(relation, node) compact rows of one edge endpoint side.

    ``edge_map`` maps each canonical edge to the padded compact row of its
    (relation, endpoint) pair (0 on padding edges).  The two sorted
    segmentations are the transposes of that expansion and of the
    node -> compact-row gather, so both backward passes are sorted segment
    sums:

    * ``edge_sort_perm`` / ``edge_row_ptr``: real edges ordered by compact
      row, padding edges appended past ``edge_row_ptr[-1]``;
    * ``node_sort_perm`` / ``node_row_ptr``: compact rows ordered by node
      id, padding rows past ``node_row_ptr[-1]``;
    * destination side only, ``canon_ptr`` / ``canon_to_row``: the
      canonical (dst, rel) runs, contiguous in canonical order, and the run
      of each compact row (sentinel ``n_runs`` on padding rows).
    """

    seg: Segments
    node_ids: torch.Tensor  # (seg.n_rows,)
    edge_map: torch.Tensor  # (num_padded_edges,)
    edge_sort_perm: torch.Tensor  # (num_padded_edges,)
    edge_row_ptr: torch.Tensor  # (seg.n_rows + 1,)
    node_sort_perm: torch.Tensor  # (seg.n_rows,)
    node_row_ptr: torch.Tensor  # (num_nodes + 1,)
    canon_ptr: Optional[torch.Tensor] = None  # (n_runs + 1,)
    canon_to_row: Optional[torch.Tensor] = None  # (seg.n_rows,)

    def to(self, device) -> "CompactInfo":
        return _to(self, device)


@dataclass(frozen=True)
class HeteroGraph:
    """Relation-partitioned heterogeneous graph in canonical edge order.

    Per-edge tensors are indexed by canonical edge position: edges stably
    sorted by (dst, rel, src), padded to ``num_padded_edges`` with sentinel
    edges (``dst == num_nodes``)."""

    num_nodes: int
    num_edges: int  # real edges
    num_padded_edges: int
    num_rels: int
    num_ntypes: int
    ntype_offsets: Tuple[int, ...]
    rel_names: Tuple[str, ...]

    src: torch.Tensor  # (EP,)
    dst: torch.Tensor  # (EP,) == num_nodes on padding
    rel: torch.Tensor  # (EP,)
    eid_orig: torch.Tensor  # (EP,) input edge id of each canonical edge
    in_row_ptr: torch.Tensor  # (num_nodes + 1,) CSR over dst
    edge_rel_seg: Segments  # relation-sorted view of the edges
    out_perm: torch.Tensor  # (EP,) canonical positions sorted by src
    out_row_ptr: torch.Tensor  # (num_nodes + 1,)
    ntype_seg: Segments
    compact_src: Optional[CompactInfo]
    compact_dst: Optional[CompactInfo]
    in_deg: torch.Tensor  # (num_nodes,)
    out_deg: torch.Tensor  # (src_space,)
    # Source-index space, 0 when it is the destination space.  On a shard
    # of a partitioned graph (``het_tpu_torch.parallel``) destinations are
    # local rows while sources index the halo buffer: the padded-global
    # node space of the all-gather, or the boundary buffer
    # ``[own rows | rows received from each peer]``.
    num_src_space: int = 0
    # boundary halo exchange (``parallel.dp.halo_exchange``): this shard's
    # own source rows (B_self,) and, per peer, the local rows it sends
    # (n_parts, B_off); both local row ids, None without the exchange
    halo_self_idx: Optional[torch.Tensor] = None
    halo_send_idx: Optional[torch.Tensor] = None
    # port only: the exchange's backward as one sorted segment sum of the
    # buffer's cotangent rows [own | returned from each peer] into the
    # local rows: slots stably sorted by local row (B_self + n_parts *
    # B_off,) and the row pointer over them (num_nodes + 1,)
    halo_back_perm: Optional[torch.Tensor] = None
    halo_back_ptr: Optional[torch.Tensor] = None
    # True when compact_src and compact_dst are two views of one union-list
    # row space (unique (relation, node) over sources and destinations
    # together, the reference's default compact kind): one projection a
    # row serves both attention sides.  False: independent per-side lists
    compact_shared: bool = False

    @property
    def src_space(self) -> int:
        """Rows of the source-side features ``x`` the graph indexes."""
        return self.num_src_space or self.num_nodes

    def to(self, device) -> "HeteroGraph":
        return _to(self, device)

    def compact_duplication(self, side: str = "src") -> Optional[float]:
        """Edges per unique (relation, node) row of one side: the factor
        compaction divides that side's typed-linear work by.  A union-list
        row space counts both sides' pairs, so there each side counts the
        rows its edges reference.  None without compact rows."""
        info = self.compact_src if side == "src" else self.compact_dst
        if info is None:
            return None
        if self.compact_shared:
            rows = int(torch.unique(info.edge_map[:self.num_edges]).numel())
        else:
            rows = info.seg.n_src
        return self.num_edges / max(rows, 1)

    def describe(self) -> str:
        text = (f"HeteroGraph(nodes={self.num_nodes}, edges={self.num_edges}"
                f" (padded {self.num_padded_edges}), rels={self.num_rels},"
                f" ntypes={self.num_ntypes}")
        if self.compact_src is not None:
            kind = "union" if self.compact_shared else "dual"
            text += (f", {kind}-list compact rows src "
                     f"{self.compact_src.seg.n_rows} dst "
                     f"{self.compact_dst.seg.n_rows}, duplication src "
                     f"{self.compact_duplication('src'):.3f} dst "
                     f"{self.compact_duplication('dst'):.3f}")
        return text + ")"
