"""Synthetic heterograph generator for tests: a relation-typed
Erdos-Renyi graph, or a power-law variant whose skewed destination
degrees stress load balancing.  The same arguments give the same graph
as ``het_tpu.graph.random_heterograph``."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .build import build_heterograph
from .structures import HeteroGraph


def random_heterograph(
    num_nodes: int,
    num_edges: int,
    num_rels: int,
    *,
    seed: int = 0,
    ntype_offsets: Optional[Sequence[int]] = None,
    tile: int = 8,
    power_law: bool = False,
) -> HeteroGraph:
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / (1.0 + np.arange(num_nodes))
        w /= w.sum()
        dst = rng.choice(num_nodes, size=num_edges, p=w)
    else:
        dst = rng.integers(0, num_nodes, size=num_edges)
    src = rng.integers(0, num_nodes, size=num_edges)
    rel = rng.integers(0, num_rels, size=num_edges)
    return build_heterograph(src, dst, rel, num_nodes, num_rels,
                             ntype_offsets=ntype_offsets, tile=tile)
