"""Seeded initial parameters, drawn on the device.

Embeddings uniform on [0, 1), biases zero, HGT's ``relation_pri`` and
``skip`` one, as the port's ``bench/common.py::seeded_state`` draws them;
weights Glorot-uniform over each matrix's own fans (its last two axes),
so that a weight stacked by type, head or relation is drawn as that many
separate matrices.  (``seeded_state`` and the port's own initializer
multiply the fans by the leading axes, flax's convention: that shrinks a
per-head linear by the square root of types times heads, and a 2-layer
HGT's second-layer attention logits to about 1e-7, so that its attention
gets no gradient that a comparison could check.)  All the uniform draws
come from one call of a ``torch.Generator`` on ``device``, carved leaf by
leaf in name order, so the same seed gives the same parameters on the
same device.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Sequence

import torch

ZERO = ("h_bias", ".bias")
ONE = (".relation_pri", ".skip")


def glorot_limit(shape: Sequence[int]) -> float:
    """Glorot's uniform limit for a matrix of the last two axes."""
    return math.sqrt(6.0 / (shape[-2] + shape[-1]))


def seeded_params(shapes: Mapping[str, Sequence[int]], seed: int,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    names = sorted(shapes)
    drawn = [n for n in names if not n.endswith(ZERO + ONE)]
    gen = torch.Generator(device=device)
    gen.manual_seed((seed + 1) % 2**63)  # not the graph's stream
    u = torch.rand(sum(math.prod(shapes[n]) for n in drawn), generator=gen,
                   device=device)
    out, at = {}, 0
    for n in names:
        shape = tuple(shapes[n])
        if n.endswith(ZERO):
            out[n] = torch.zeros(shape, device=device)
        elif n.endswith(ONE):
            out[n] = torch.ones(shape, device=device)
        else:
            size = math.prod(shape)
            a = u[at:at + size].view(shape)
            at += size
            if n != "embed.embed":
                lim = glorot_limit(shape)
                a = a.mul(2 * lim).sub_(lim)
            out[n] = a
    return out
