"""Carry parameters over from the JAX package.

``het_tpu.train`` keeps its parameters as
``{"embed": {"params": {"embed"}}, "model": {"params": {"RGATLayer_i":
{...}}}}``; the port keeps the same arrays under the same leaf names in a
:class:`~het_tpu_torch.train.driver.NodeClassifier` state dict.
``het_tpu.parallel.DPGNN.init`` returns a list of per-layer
``{"params": {...}}`` dicts; the port's ``DPGNN`` (and ``RGATModel``)
keeps them as ``layers.{i}.*``.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Sequence

import numpy as np
import torch


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """Nested dicts of numpy arrays, shaped as the JAX trainer builds them,
    -> the port's state dict (``embed.embed``,
    ``model.layers.{i}.{conv_weights,attn_l,attn_r,h_bias}``)."""
    out = {"embed.embed": _tensor(tree["embed"]["params"]["embed"])}
    for name, leaves in tree["model"]["params"].items():
        m = re.fullmatch(r"RGATLayer_(\d+)", name)
        if m is None:
            raise KeyError(f"unexpected parameter group {name!r}")
        for leaf, value in leaves.items():
            out[f"model.layers.{m.group(1)}.{leaf}"] = _tensor(value)
    return out


def dp_params_from_jax(layers: Sequence[Mapping]) -> Dict[str, torch.Tensor]:
    """``DPGNN.init``'s list of per-layer flax dicts -> the state dict of
    the port's ``DPGNN`` (``layers.{i}.{conv_weights,attn_l,attn_r,
    h_bias}``)."""
    return {f"layers.{i}.{leaf}": _tensor(value)
            for i, layer in enumerate(layers)
            for leaf, value in layer["params"].items()}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))
