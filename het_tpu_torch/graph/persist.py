"""Save and load a built :class:`HeteroGraph` (counterpart of
``het_tpu/graph/persist.py``): a large graph is built once on the host and
read back in seconds.

One file, written by ``torch.save`` and read with ``weights_only=True``:
the graph's tensors by field path, and a JSON tree of its dataclasses
with their static fields (sizes, offsets, names, ``seg_ptrs_static``
tuples, the ``None`` of an absent field).  Loading rebuilds only the
three graph dataclasses, by name, and unpickles no code.  A dataclass
object that two fields share (the union-list compact views' ``seg``) is
written once and shared again when loaded.  The file is written under a
temporary name and renamed into place.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Dict

import torch

from .structures import CompactInfo, HeteroGraph, Segments

FORMAT = "het_tpu_torch.HeteroGraph/1"
_CLASSES = {c.__name__: c for c in (HeteroGraph, Segments, CompactInfo)}


def _encode(obj, path: str, tensors: Dict[str, torch.Tensor],
            seen: Dict[int, str]) -> Any:
    """The JSON tree of one field's value, its tensors put in
    ``tensors`` under their field path."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, torch.Tensor):
        tensors[path] = obj.detach().cpu()
        return {"tensor": path}
    if isinstance(obj, tuple):
        return {"tuple": [_encode(v, f"{path}.{i}", tensors, seen)
                          for i, v in enumerate(obj)]}
    if dataclasses.is_dataclass(obj) and type(obj).__name__ in _CLASSES:
        if id(obj) in seen:
            return {"same_as": seen[id(obj)]}
        seen[id(obj)] = path
        return {"class": type(obj).__name__, "path": path, "fields": {
            f.name: _encode(getattr(obj, f.name), f"{path}.{f.name}",
                            tensors, seen)
            for f in dataclasses.fields(obj)}}
    raise TypeError(f"save_heterograph: cannot store {path} "
                    f"({type(obj).__name__})")


def _decode(node, tensors: Dict[str, torch.Tensor],
            made: Dict[str, Any]) -> Any:
    if not isinstance(node, dict):
        return node
    if "tensor" in node:
        return tensors[node["tensor"]]
    if "tuple" in node:
        return tuple(_decode(v, tensors, made) for v in node["tuple"])
    if "same_as" in node:
        return made[node["same_as"]]
    cls = _CLASSES[node["class"]]
    obj = cls(**{k: _decode(v, tensors, made)
                 for k, v in node["fields"].items()})
    made[node["path"]] = obj
    return obj


def save_heterograph(path: str, g: HeteroGraph) -> None:
    """Write ``g`` to ``path`` (its tensors as they are, moved to the
    CPU)."""
    tensors: Dict[str, torch.Tensor] = {}
    tree = _encode(g, "g", tensors, {})
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=directory)
    os.close(fd)
    try:
        torch.save({"format": FORMAT, "tree": json.dumps(tree),
                    "tensors": tensors}, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_heterograph(path: str) -> HeteroGraph:
    """The graph :func:`save_heterograph` wrote to ``path``, on the
    CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a graph saved by "
                         f"save_heterograph ({FORMAT})")
    g = _decode(json.loads(blob["tree"]), blob["tensors"], {})
    if not isinstance(g, HeteroGraph):
        raise ValueError(f"{path} holds no HeteroGraph")
    return g
