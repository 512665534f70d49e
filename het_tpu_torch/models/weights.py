"""Carry parameters over from the JAX package.

``het_tpu.train`` keeps its parameters as
``{"embed": {"params": {"embed"}}, "model": {"params": {group: {...}}}}``
with one flax group a layer: ``RGATLayer_i``, ``RGCNLayer_i``,
``HGTLayer_i``, ``GATLayer_i`` or, for the featureless RGCN,
``SeastarRGCNLayer0_0`` followed by ``RGCNLayer_0``.  A group may nest a
submodule's own group: an HGT layer's ``LayerNorm_0`` (``scale``,
``bias``) is the port's ``norm`` (``weight``, ``bias``).
The port keeps the same arrays under the same leaf names in a
:class:`~het_tpu_torch.train.driver.NodeClassifier` state dict, a layer
at its place in the model (``model.layers.{i}``), which is not always its
flax suffix.  ``het_tpu.parallel.DPGNN.init`` returns a list of per-layer
``{"params": {...}}`` dicts; the port's ``DPGNN`` (and ``RGATModel``,
``RGCNModel``, ``HGTModel``, ``GATModel``) keeps them as ``layers.{i}``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

_GROUP = re.compile(
    r"(RGATLayer|GATLayer|RGCNLayer|HGTLayer|SeastarRGCNLayer0)_(\d+)")
# nested flax groups -> the port's submodule and its leaf names
_NESTED = {"LayerNorm_0": ("norm", {"scale": "weight", "bias": "bias"})}


def _layer_index(name: str, groups) -> int:
    """The port's layer of flax group ``name``: flax counts each module
    class apart, so after the featureless ``SeastarRGCNLayer0_0`` (layer
    0) ``RGCNLayer_i`` is layer ``i + 1``."""
    m = _GROUP.fullmatch(name)
    if m is None or (m.group(1) == "SeastarRGCNLayer0" and m.group(2) != "0"):
        raise KeyError(f"unexpected parameter group {name!r}")
    i = int(m.group(2))
    if m.group(1) == "RGCNLayer" and "SeastarRGCNLayer0_0" in groups:
        i += 1
    return i


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays, shaped as the JAX trainer builds them,
    -> the port's state dict (``embed.embed``, ``model.layers.{i}.{leaf}``
    with het_tpu's leaf names)."""
    out = {"embed.embed": _tensor(tree["embed"]["params"]["embed"])}
    groups = tree["model"]["params"]
    for name, leaves in groups.items():
        i = _layer_index(name, groups)
        out.update(_leaves(f"model.layers.{i}", leaves))
    return out


def dp_params_from_jax(layers: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """``DPGNN.init``'s list of per-layer flax dicts -> the state dict of
    the port's ``DPGNN`` (``layers.{i}.{leaf}``)."""
    out = {}
    for i, layer in enumerate(layers):
        out.update(_leaves(f"layers.{i}", layer["params"]))
    return out


def _leaves(prefix: str, leaves: Mapping) -> Dict[str, torch.Tensor]:
    """One layer's flax leaves under ``prefix``, a nested group's under
    its port submodule (``_NESTED``)."""
    out = {}
    for leaf, value in leaves.items():
        if isinstance(value, Mapping):
            if leaf not in _NESTED:
                raise KeyError(f"unexpected nested group {leaf!r}")
            sub, names = _NESTED[leaf]
            for name, v in value.items():
                out[f"{prefix}.{sub}.{names[name]}"] = _tensor(v)
        else:
            out[f"{prefix}.{leaf}"] = _tensor(value)
    return out


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))
