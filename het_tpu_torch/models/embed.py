"""Learned node embeddings for featureless heterographs (counterpart of
``het_tpu/models/embed.py``): one row per node, trained with the model."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class NodeEmbed(nn.Module):
    def __init__(self, num_nodes: int, embed_dim: int, *,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        # uniform on [0, 1), flax's ``uniform(scale=1.0)``
        self.embed = nn.Parameter(torch.empty(num_nodes, embed_dim))
        with torch.no_grad():
            self.embed.uniform_(0.0, 1.0, generator=generator)

    def forward(self) -> torch.Tensor:
        return self.embed
