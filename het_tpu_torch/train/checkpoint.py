"""Training-state checkpoints (counterpart of
``het_tpu/train/checkpoint.py``), on ``torch.save`` / ``torch.load``.

One file a step, ``step_<n>.pt`` under the checkpoint directory, holds
what a resumed run needs to repeat the uninterrupted one exactly: the
module's state dict, Adam's state dict, the loss-scale state, the dropout
generator's state and the epoch.  A file is written under a temporary
name and renamed into place (``os.replace``), so :func:`latest_step` sees
only whole files: het_tpu's ``latest_step`` counts orbax's temporary
directories as steps, which this does not carry over.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Dict, Optional

import torch

_NAME = re.compile(r"step_(\d+)\.pt$")


def checkpoint_path(path: str, step: int) -> str:
    return os.path.join(path, f"step_{step}.pt")


def save_checkpoint(path: str, state: Dict[str, Any], step: int) -> str:
    """Write ``state`` (tensors, numbers and containers of them) as step
    ``step`` under ``path``; returns the file."""
    os.makedirs(path, exist_ok=True)
    final = checkpoint_path(path, step)
    fd, tmp = tempfile.mkstemp(prefix=f".step_{step}.", suffix=".tmp",
                               dir=path)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(state, f)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    return final


def latest_step(path: str) -> Optional[int]:
    """The largest step saved whole under ``path`` (None if none)."""
    if not os.path.isdir(path):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(path))
             if m]
    return max(steps) if steps else None


def load_checkpoint(path: str, step: Optional[int] = None) -> Dict[str, Any]:
    """The state saved as ``step`` (the latest where None) under
    ``path``, its tensors on the CPU."""
    if step is None:
        step = latest_step(path)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {path}")
    return torch.load(checkpoint_path(path, step), map_location="cpu",
                      weights_only=True)
