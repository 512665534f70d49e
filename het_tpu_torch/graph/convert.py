"""Host-side (numpy) orderings and sparse-format conversions of COO edge
lists.

The sorts that turn an edge list into the canonical layout, and the
CSR/COO conversions of ``het_tpu/graph/convert.py`` (the in-CSR the
neighbour sampler walks).  Each is stable, so its result is fully
determined by its keys: the JAX package computes the same orderings
(with an optional native library), and the graphs the two packages build
agree bit for bit.
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


def coo_to_csr(row: np.ndarray, col: np.ndarray, data: np.ndarray,
               num_rows: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """COO -> CSR by a stable sort on ``row``: ``(row_ptr, col, data)``
    with ``int64`` pointers, the entries of a row in input order."""
    row = np.asarray(row)
    order = np.argsort(row, kind="stable")
    row_ptr = np.zeros(num_rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(row, minlength=num_rows), out=row_ptr[1:])
    return row_ptr, np.asarray(col)[order], np.asarray(data)[order]


def csr_to_coo(row_ptr: np.ndarray,
               col: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> COO: ``(row, col)``, each entry's row repeated out of
    ``row_ptr``."""
    num_rows = len(row_ptr) - 1
    row = np.repeat(np.arange(num_rows, dtype=np.int64), np.diff(row_ptr))
    return row, np.asarray(col)


def transpose_csr(row_ptr: np.ndarray, col: np.ndarray, eids: np.ndarray,
                  rel_types: np.ndarray, num_cols: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Transpose a CSR carrying an edge id and a relation an entry:
    ``(row_ptr, col, eids, rel_types)`` of the transpose, each of its rows
    in the order of the rows it came from, so that transposing twice
    gives the input back with each row's entries ordered by column."""
    row, _ = csr_to_coo(row_ptr, col)
    t_ptr, t_col, packed = coo_to_csr(
        np.asarray(col), row,
        np.stack([np.asarray(eids), np.asarray(rel_types)], 1), num_cols)
    return t_ptr, t_col, packed[:, 0], packed[:, 1]


def integrated_coo_to_separate_coo(
    src: np.ndarray, dst: np.ndarray, rel: np.ndarray, num_rels: int
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Edges stably sorted by relation: ``(rel_ptrs, src, dst, eids)``,
    relation ``r``'s edges at ``rel_ptrs[r]:rel_ptrs[r + 1]``."""
    order = np.argsort(rel, kind="stable")
    rel_ptrs = np.zeros(num_rels + 1, dtype=np.int64)
    np.cumsum(np.bincount(rel, minlength=num_rels), out=rel_ptrs[1:])
    return rel_ptrs, np.asarray(src)[order], np.asarray(dst)[order], order
