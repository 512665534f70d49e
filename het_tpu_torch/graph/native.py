"""Bindings of the port's host library (``csrc/graphops.cpp``): the
canonical edge sort, the counting argsort, degree counting, unique
(relation, node) pairs, the degree sort and the fanout sampler, with the
signatures and results of ``het_tpu.graph.native``.

The library is built with ``g++`` at first use
(``ops/kernels/_build.py``); a failed build raises ``RuntimeError`` with
the compiler's output, and nothing falls back to numpy.  The numpy
versions of the sorts are ``graph/convert.py``'s, and the sampler's is
``NeighborSampler.draw_plain``: the graph builder and the sampler take
them only when asked to.

The C++ sorts index their count tables by key unchecked, so every
function here checks its keys first and raises ``ValueError`` for one out
of range.  Arrays go to the library as C-contiguous ``int64``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_I64 = ctypes.c_int64
VERSION = 3

_LIB: Optional[ctypes.CDLL] = None


def library() -> ctypes.CDLL:
    """The host library, built and bound on first use."""
    global _LIB
    if _LIB is None:
        from ..ops.kernels import _build

        lib = _build.load("graphops")
        lib.hetg_counting_sort.argtypes = [_I64P, _I64, _I64,
                                           ctypes.c_void_p, _I64P]
        lib.hetg_counting_sort.restype = None
        lib.hetg_canonical_sort.argtypes = [_I64P, _I64P, _I64P, _I64, _I64,
                                            _I64, _I64P]
        lib.hetg_canonical_sort.restype = None
        lib.hetg_bincount.argtypes = [_I64P, _I64, _I64, _I64P]
        lib.hetg_bincount.restype = None
        lib.hetg_unique_pairs.argtypes = [_I64P, _I64P, _I64, _I64, _I64,
                                          _I64P, _I64P, _I64P]
        lib.hetg_unique_pairs.restype = _I64
        lib.hetg_degree_sort.argtypes = [_I64P, _I64, _I64P]
        lib.hetg_degree_sort.restype = None
        lib.hetg_sample_fanout.argtypes = [
            _I64P, _I64P, _I64P, _I64P, _I64, _I64, _I64, ctypes.c_uint64,
            _I64, _I64, _I64P, _I64P, _I64P, _I64P, _I64P, _I64P]
        lib.hetg_sample_fanout.restype = _I64
        lib.hetg_version.restype = _I64
        if lib.hetg_version() != VERSION:
            raise RuntimeError(f"graphops library version "
                               f"{lib.hetg_version()}, expected {VERSION}")
        _LIB = lib
    return _LIB


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).ravel(), dtype=np.int64)


def _check(keys: np.ndarray, bound: int, what: str) -> None:
    """Raise ``ValueError`` unless every key lies in ``[0, bound)``."""
    if bound < 0:
        raise ValueError(f"{what}: negative key bound {bound}")
    if keys.size and (int(keys.min()) < 0 or int(keys.max()) >= bound):
        raise ValueError(f"{what}: keys in [{int(keys.min())}, "
                         f"{int(keys.max())}] outside [0, {bound})")


def canonical_sort(src: np.ndarray, dst: np.ndarray, rel: np.ndarray,
                   num_nodes: int, num_rels: int) -> np.ndarray:
    """Stable argsort of edges by (dst, rel, src); node ids below
    ``num_nodes``, relations below ``num_rels``."""
    src, dst, rel = _i64(src), _i64(dst), _i64(rel)
    n = src.size
    if dst.size != n or rel.size != n:
        raise ValueError("canonical_sort: src, dst and rel differ in length")
    _check(src, num_nodes, "canonical_sort src")
    _check(dst, num_nodes, "canonical_sort dst")
    _check(rel, num_rels, "canonical_sort rel")
    out = np.empty(n, dtype=np.int64)
    library().hetg_canonical_sort(src, dst, rel, n, num_nodes, num_rels, out)
    return out


def counting_argsort(keys: np.ndarray, num_keys: int) -> np.ndarray:
    """Stable argsort of keys in ``[0, num_keys)``: one counting sort,
    O(n + num_keys)."""
    keys = _i64(keys)
    _check(keys, num_keys, "counting_argsort")
    out = np.empty(keys.size, dtype=np.int64)
    library().hetg_counting_sort(keys, keys.size, num_keys, None, out)
    return out


def bincount(ids: np.ndarray, num_bins: int) -> np.ndarray:
    """``np.bincount(ids, minlength=num_bins)`` for ids in
    ``[0, num_bins)``, as ``int64``."""
    ids = _i64(ids)
    _check(ids, num_bins, "bincount")
    out = np.empty(num_bins, dtype=np.int64)
    library().hetg_bincount(ids, ids.size, num_bins, out)
    return out


def unique_pairs(rel: np.ndarray, node: np.ndarray, num_nodes: int,
                 num_rels: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sorted unique (rel, node) pairs and the inverse map of each input
    pair into them: ``np.unique`` over ``rel * num_nodes + node``."""
    rel, node = _i64(rel), _i64(node)
    n = rel.size
    if node.size != n:
        raise ValueError("unique_pairs: rel and node differ in length")
    _check(rel, num_rels, "unique_pairs rel")
    _check(node, num_nodes, "unique_pairs node")
    ur = np.empty(n, dtype=np.int64)
    un = np.empty(n, dtype=np.int64)
    inv = np.empty(n, dtype=np.int64)
    nu = library().hetg_unique_pairs(rel, node, n, num_nodes, num_rels, ur,
                                     un, inv)
    return ur[:nu].copy(), un[:nu].copy(), inv


def degree_sort(deg: np.ndarray) -> np.ndarray:
    """Node ids ordered by descending degree, ties by id."""
    deg = _i64(deg)
    out = np.empty(deg.size, dtype=np.int64)
    library().hetg_degree_sort(deg, deg.size, out)
    return out


def check_csr(ptr: np.ndarray, nbr_src: np.ndarray, nbr_rel: np.ndarray,
              num_nodes: int) -> None:
    """Raise ``ValueError`` unless ``ptr`` / ``nbr_src`` / ``nbr_rel`` are
    an in-CSR over ``num_nodes`` nodes the sampler can walk safely."""
    ptr = np.asarray(ptr)
    if ptr.shape != (num_nodes + 1,):
        raise ValueError(f"sample_fanout: ptr has shape {ptr.shape}, "
                         f"expected ({num_nodes + 1},)")
    if ptr[0] != 0 or (np.diff(ptr) < 0).any() \
            or ptr[-1] > min(len(nbr_src), len(nbr_rel)):
        raise ValueError("sample_fanout: ptr is not a row pointer over "
                         "the neighbour arrays")
    _check(np.asarray(nbr_src), num_nodes, "sample_fanout nbr_src")


def sample_fanout(ptr: np.ndarray, nbr_src: np.ndarray, nbr_rel: np.ndarray,
                  seeds: np.ndarray, fanout: int, num_hops: int,
                  rng_seed: int, num_nodes: int, max_edges: int,
                  max_nodes: int, *, local: Optional[np.ndarray] = None,
                  csr_checked: bool = False
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Uniform fanout sampling over the in-CSR: ``(edges_src_local,
    edges_dst_local, edges_rel, node_map)``, drawn from
    ``mt19937_64(rng_seed)`` as het_tpu's native sampler draws.

    ``local`` is a node -> local id buffer (``num_nodes`` int64, all -1)
    that the call leaves as it found it, so a caller drawing many batches
    allocates it once.  ``csr_checked`` skips :func:`check_csr` for a
    caller that checked its CSR once already; the seeds are always
    checked."""
    ptr, nbr_src, nbr_rel = _i64(ptr), _i64(nbr_src), _i64(nbr_rel)
    seeds = _i64(seeds)
    if not csr_checked:
        check_csr(ptr, nbr_src, nbr_rel, num_nodes)
    _check(seeds, num_nodes, "sample_fanout seeds")
    if max_edges < 0 or max_nodes < 0:
        raise ValueError("sample_fanout: negative cap")
    if local is None:
        local = np.full(num_nodes, -1, dtype=np.int64)
    elif local.dtype != np.int64 or local.shape != (num_nodes,) \
            or not local.flags.c_contiguous:
        raise ValueError("sample_fanout: local must be num_nodes "
                         "C-contiguous int64 entries")
    es = np.empty(max_edges, dtype=np.int64)
    ed = np.empty(max_edges, dtype=np.int64)
    er = np.empty(max_edges, dtype=np.int64)
    nm = np.empty(max_nodes, dtype=np.int64)
    nn = np.zeros(1, dtype=np.int64)
    ne = library().hetg_sample_fanout(
        ptr, nbr_src, nbr_rel, seeds, seeds.size, int(fanout), int(num_hops),
        int(rng_seed), int(max_edges), int(max_nodes), local, es, ed, er, nm,
        nn)
    n_nodes = int(nn[0])
    return es[:ne].copy(), ed[:ne].copy(), er[:ne].copy(), nm[:n_nodes].copy()
