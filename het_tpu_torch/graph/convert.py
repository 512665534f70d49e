"""Host-side (numpy) orderings of COO edge lists.

The sorts that turn an edge list into the canonical layout.  Each is
stable, so its result is fully determined by its keys: the JAX package
computes the same orderings (with an optional native library), and the
graphs the two packages build agree bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def canonical_sort(src: np.ndarray, dst: np.ndarray,
                   rel: np.ndarray) -> np.ndarray:
    """Stable argsort of edges by (dst, rel, src)."""
    return np.lexsort((src, rel, dst))


def counting_argsort(keys: np.ndarray) -> np.ndarray:
    """Stable argsort of non-negative integer keys."""
    return np.argsort(np.asarray(keys, np.int64), kind="stable")


def unique_pairs(
    rel: np.ndarray, node: np.ndarray, num_nodes: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted unique (rel, node) pairs and the inverse map of each input
    pair into them."""
    key = rel.astype(np.int64) * np.int64(num_nodes) + node.astype(np.int64)
    uniq, inverse = np.unique(key, return_inverse=True)
    return uniq // num_nodes, uniq % num_nodes, inverse.reshape(-1)
