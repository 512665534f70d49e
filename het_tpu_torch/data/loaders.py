"""Dataset loaders.

Every named dataset has a deterministic synthetic stand-in at its
published scale (times ``scale``): the same ``(name, scale, seed)`` gives
the same graph, labels and split as ``het_tpu.data.loaders._synthetic``.
Real data in the reference's on-disk format (a directory of per-relation
``(2, E)`` COO ``.npy`` shards) loads from directories the caller names
in ``data_roots``; nothing is searched by default.
"""

from __future__ import annotations

import glob
import os
import zlib
from dataclasses import dataclass, field
from typing import Dict, Optional, Sequence

import numpy as np

from ..graph.build import build_heterograph
from ..graph.structures import HeteroGraph

# name -> (num_nodes, num_edges, num_rels), the reference's scale facts
SYNTH_SCALES = {
    "aifb": (8285, 66371, 91),
    "mutag": (23644, 172098, 47),
    "bgs": (333845, 2166243, 207),
    "am": (881680, 5668682, 217),
    "fb15k": (14541, 620232, 474),
    "wikikg2": (2500604, 16109182, 535),
    "biokg": (93773, 4762678, 51),
    "mag": (1939743, 21111007, 4),
    "cora": (2708, 10556, 1),
    "citeseer": (3327, 9228, 1),
    "pubmed": (19717, 88651, 1),
    "arxiv": (169343, 1166243, 1),
    "reddit": (232965, 114615892, 1),
}


@dataclass
class Dataset:
    name: str
    graph: HeteroGraph
    labels: np.ndarray
    train_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    meta: Dict = field(default_factory=dict)


def _planted_labels(g: HeteroGraph, num_classes: int,
                    seed: int) -> np.ndarray:
    """Labels from the majority relation of each node's incoming edges,
    so synthetic datasets are learnable, not noise."""
    rng = np.random.default_rng(seed)
    E = g.num_edges
    rel = g.rel.numpy()[:E].astype(np.int64)
    dst = g.dst.numpy()[:E].astype(np.int64)
    votes = np.zeros((g.num_nodes, num_classes), dtype=np.int64)
    np.add.at(votes, (dst, rel % num_classes), 1)
    labels = votes.argmax(1)
    iso = votes.sum(1) == 0
    labels[iso] = rng.integers(0, num_classes, iso.sum())
    return labels


def _synthetic(
    name: str,
    *,
    scale: float = 1.0,
    num_classes: int = 8,
    seed: int = 0,
    tile: int = 128,
    build_compact: bool = True,
    compact_union: bool = False,
) -> Dataset:
    n, e, r = SYNTH_SCALES[name]
    n, e = max(int(n * scale), 64), max(int(e * scale), 256)
    # zlib.crc32, not hash(): str hash is salted per interpreter
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 2**16)
    # power-law-ish dst degrees, like real KGs
    w = 1.0 / np.sqrt(1.0 + rng.permutation(n))
    w /= w.sum()
    dst = rng.choice(n, size=e, p=w)
    src = rng.integers(0, n, size=e)
    # zipf-ish relation sizes
    rw = 1.0 / (1.0 + np.arange(r))
    rw /= rw.sum()
    rel = rng.choice(r, size=e, p=rw)
    g = build_heterograph(src, dst, rel, n, r, tile=tile,
                          build_compact=build_compact,
                          compact_union=compact_union)
    labels = _planted_labels(g, num_classes, seed)
    idx = rng.permutation(n)
    split = int(0.8 * n)
    return Dataset(
        name=name,
        graph=g,
        labels=labels,
        train_idx=idx[:split],
        test_idx=idx[split:],
        num_classes=num_classes,
        meta={"synthetic": True, "scale": scale},
    )


def load_npy_shards(root: str, *, tile: int = 128,
                    build_compact: bool = True,
                    compact_union: bool = False) -> Optional[HeteroGraph]:
    """Load a directory of per-relation ``(2, E)`` COO ``.npy`` shards,
    one relation per file in sorted file-name order."""
    files = sorted(glob.glob(os.path.join(root, "*_coo_*.npy"))) or sorted(
        glob.glob(os.path.join(root, "*.npy"))
    )
    if not files:
        return None
    srcs, dsts, rels, names = [], [], [], []
    for i, f in enumerate(files):
        coo = np.load(f)
        if coo.ndim != 2 or coo.shape[0] != 2:
            raise ValueError(f"{f}: expected a (2, E) COO array")
        srcs.append(coo[0])
        dsts.append(coo[1])
        rels.append(np.full(coo.shape[1], i, dtype=np.int64))
        names.append(os.path.basename(f).split("_coo")[0])
    src, dst, rel = map(np.concatenate, (srcs, dsts, rels))
    num_nodes = int(max(src.max(), dst.max())) + 1
    return build_heterograph(src, dst, rel, num_nodes, len(files),
                             rel_names=names, tile=tile,
                             build_compact=build_compact,
                             compact_union=compact_union)


def load_dataset(
    name: str,
    *,
    scale: float = 1.0,
    num_classes: int = 8,
    seed: int = 0,
    tile: int = 128,
    build_compact: bool = True,
    compact_union: bool = False,
    data_roots: Sequence[str] = (),
) -> Dataset:
    """Load ``name`` from COO shards under one of ``data_roots`` (with
    planted labels and a seeded 80/20 split), else synthesize it."""
    name = name.lower()
    for root in data_roots:
        for cand in (os.path.join(root, name),
                     os.path.join(root, f"ogbn_{name}_0.1"),
                     os.path.join(root, f"{name}_0.1")):
            if not os.path.isdir(cand):
                continue
            g = load_npy_shards(cand, tile=tile, build_compact=build_compact,
                                compact_union=compact_union)
            if g is None:
                continue
            rng = np.random.default_rng(seed)
            idx = rng.permutation(g.num_nodes)
            split = int(0.8 * g.num_nodes)
            return Dataset(
                name=name,
                graph=g,
                labels=_planted_labels(g, num_classes, seed),
                train_idx=idx[:split],
                test_idx=idx[split:],
                num_classes=num_classes,
                meta={"synthetic": False, "path": cand,
                      "synthetic_labels": True},
            )
    if name not in SYNTH_SCALES:
        raise ValueError(
            f"unknown dataset {name!r}; known: {sorted(SYNTH_SCALES)}"
        )
    return _synthetic(name, scale=scale, num_classes=num_classes, seed=seed,
                      tile=tile, build_compact=build_compact,
                      compact_union=compact_union)
