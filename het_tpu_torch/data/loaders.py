"""Dataset loaders.

Every named dataset has a deterministic synthetic stand-in at its
published scale (times ``scale``): the same ``(name, scale, seed)`` gives
the same graph, labels and split as ``het_tpu.data.loaders._synthetic``.
Real data in the reference's on-disk format (a directory of per-relation
``(2, E)`` COO ``.npy`` shards) loads from directories the caller names
in ``data_roots``; nothing is searched by default.  Beside the shards,
``labels.npy`` (one label a node), ``train_idx.npy`` / ``test_idx.npy``
and ``features.npy`` make the labels, split and features real, as
``het_tpu/data/loaders.py`` reads them.
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

# the files beside the COO shards that are not shards
SIDE_FILES = ("labels.npy", "train_idx.npy", "test_idx.npy", "features.npy")


@dataclass
class Dataset:
    name: str
    graph: HeteroGraph
    labels: np.ndarray
    train_idx: np.ndarray
    test_idx: np.ndarray
    num_classes: int
    # node features read beside real COO shards (features.npy), else None
    features: Optional[np.ndarray] = None
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
    one relation per file in sorted file-name order: the ``*_coo_*.npy``
    files, else every ``.npy`` file but the label, split and feature
    files (``SIDE_FILES``)."""
    files = sorted(glob.glob(os.path.join(root, "*_coo_*.npy"))) or sorted(
        f for f in glob.glob(os.path.join(root, "*.npy"))
        if os.path.basename(f) not in SIDE_FILES)
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


def _seeded_split(num_nodes: int, seed: int):
    """The seeded 80/20 train/test split of the nodes."""
    idx = np.random.default_rng(seed).permutation(num_nodes)
    split = int(0.8 * num_nodes)
    return idx[:split], idx[split:]


def _shard_dataset(name: str, root: str, g: HeteroGraph, num_classes: int,
                   seed: int) -> Dataset:
    """The dataset of COO shards under ``root``: with ``labels.npy`` beside
    them, its labels (one a node; as many classes as its largest label
    plus one), ``train_idx.npy`` (else the seeded split; ``test_idx.npy``,
    else the nodes not in training) and ``features.npy`` where present;
    without it, planted labels and the seeded split."""
    labels_f = os.path.join(root, "labels.npy")
    if not os.path.exists(labels_f):
        train_idx, test_idx = _seeded_split(g.num_nodes, seed)
        return Dataset(name=name, graph=g,
                       labels=_planted_labels(g, num_classes, seed),
                       train_idx=train_idx, test_idx=test_idx,
                       num_classes=num_classes,
                       meta={"synthetic": False, "path": root,
                             "synthetic_labels": True})
    labels = np.load(labels_f).astype(np.int64)
    if labels.shape[0] != g.num_nodes:
        raise ValueError(f"labels.npy has {labels.shape[0]} rows for "
                         f"{g.num_nodes} nodes")
    train_f = os.path.join(root, "train_idx.npy")
    test_f = os.path.join(root, "test_idx.npy")
    if os.path.exists(train_f):
        train_idx = np.load(train_f).astype(np.int64)
        test_idx = (np.load(test_f).astype(np.int64)
                    if os.path.exists(test_f)
                    else np.setdiff1d(np.arange(g.num_nodes), train_idx))
    else:
        train_idx, test_idx = _seeded_split(g.num_nodes, seed)
    feat_f = os.path.join(root, "features.npy")
    return Dataset(name=name, graph=g, labels=labels, train_idx=train_idx,
                   test_idx=test_idx, num_classes=int(labels.max()) + 1,
                   features=(np.load(feat_f) if os.path.exists(feat_f)
                             else None),
                   meta={"synthetic": False, "path": root,
                         "synthetic_labels": False})


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
    """Load ``name`` from COO shards under one of ``data_roots`` (their
    label, split and feature files where present, else planted labels and
    a seeded 80/20 split: ``_shard_dataset``), else synthesize it."""
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
            return _shard_dataset(name, cand, g, num_classes, seed)
    if name not in SYNTH_SCALES:
        raise ValueError(
            f"unknown dataset {name!r}; known: {sorted(SYNTH_SCALES)}"
        )
    return _synthetic(name, scale=scale, num_classes=num_classes, seed=seed,
                      tile=tile, build_compact=build_compact,
                      compact_union=compact_union)
