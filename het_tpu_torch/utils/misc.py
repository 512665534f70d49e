"""Small runtime helpers."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def nll_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean negative log-likelihood of ``labels`` under
    ``log_softmax(logits)``, computed in f32."""
    logp = F.log_softmax(logits.float(), dim=-1)
    return -logp.gather(1, labels.long()[:, None]).mean()


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    return dev


def exact_matmuls() -> None:
    """TF32 off, and cuBLAS's bf16 reductions in f32 (it reduces bf16
    products in bf16 unless told not to; het_tpu's dots accumulate in
    f32), as every run of the port trains and measures."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


class EarlyStopping:
    """Stop when the monitored value fails to improve for ``patience``
    checks; keeps the best value and step (a copy of
    ``het_tpu/utils/misc.py::EarlyStopping``)."""

    def __init__(self, patience: int = 10, min_delta: float = 0.0,
                 mode: str = "min"):
        assert mode in ("min", "max")
        self.patience = patience
        self.min_delta = min_delta
        self.mode = mode
        self.best: Optional[float] = None
        self.best_step = -1
        self.bad = 0
        self.stopped = False

    def update(self, value: float, step: int = 0) -> bool:
        """Returns True when training should stop."""
        better = (
            self.best is None
            or (self.mode == "min" and value < self.best - self.min_delta)
            or (self.mode == "max" and value > self.best + self.min_delta)
        )
        if better:
            self.best = value
            self.best_step = step
            self.bad = 0
        else:
            self.bad += 1
            if self.bad >= self.patience:
                self.stopped = True
        return self.stopped
