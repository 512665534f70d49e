"""The training-step loop every trainer of the port runs: Adam, whose
defaults (eps outside the square root, bias correction) are
``optax.adam``'s, and each step timed with CUDA events on the card or the
host clock on the CPU."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


def train_steps(
    module: nn.Module,
    step_loss: Callable[[], Tuple[torch.Tensor, torch.Tensor]],
    *,
    steps: int,
    lr: float,
    device: torch.device,
    warmup: int = 0,
    after_backward: Optional[Callable[[], None]] = None,
    log: Optional[Callable[[str], None]] = None,
) -> Dict[str, List]:
    """``warmup`` untimed Adam steps, then ``steps`` timed ones, on
    ``module``'s parameters (one optimizer state throughout).

    ``step_loss()`` runs the forward and returns ``(local, value)``: the
    tensor to differentiate and the loss to record (the same tensor in one
    process; on a rank of a data-parallel run, its share and the whole).
    ``after_backward`` runs between the backward and the update (the
    gradient sum over ranks).  Returns the losses, the step times and the
    timer used."""
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    on_card = device.type == "cuda"

    def update():
        opt.zero_grad(set_to_none=True)
        local, value = step_loss()
        local.backward()
        if after_backward is not None:
            after_backward()
        opt.step()
        return value

    for _ in range(warmup):
        update()
    losses, step_ms = [], []
    for step in range(steps):
        if on_card:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
        else:
            h0 = time.perf_counter()
        value = update()
        if on_card:
            t1.record()
            t1.synchronize()
            ms = t0.elapsed_time(t1)
        else:
            ms = (time.perf_counter() - h0) * 1e3
        losses.append(value.detach().item())
        step_ms.append(ms)
        if log is not None:
            log(f"step {step} loss {losses[-1]:.6f} step_ms {ms:.3f}")
    return {"loss_list": losses, "step_ms_list": step_ms,
            "timer": "cuda_events" if on_card else "host_clock"}
