"""Carry parameters over from the JAX package.

``het_tpu.train`` keeps its parameters as
``{"embed": {"params": {"embed"}}, "model": {"params": {"RGATLayer_i":
{...}}}}``; the port keeps the same arrays under the same leaf names in a
:class:`~het_tpu_torch.train.driver.NodeClassifier` state dict.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

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


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))
