"""The training-step loop every trainer of the port runs: Adam, whose
defaults (eps outside the square root, bias correction) are
``optax.adam``'s, and each step timed with CUDA events on the card or the
host clock on the CPU."""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


class _Clock:
    """Marks on the card's stream (CUDA events) or on the host clock, and
    the milliseconds between consecutive marks."""

    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.marks: List = []

    def mark(self) -> None:
        if self.on_card:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.marks.append(e)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.on_card:
            m[-1].synchronize()
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


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
    gradient sum over ranks).  Returns the losses, the step times, the
    forward's share of each (from the step's start to the loss) and the
    timer used."""
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    on_card = device.type == "cuda"

    def update(forward_done: Callable[[], None]):
        opt.zero_grad(set_to_none=True)
        local, value = step_loss()
        forward_done()
        local.backward()
        if after_backward is not None:
            after_backward()
        opt.step()
        return value

    for _ in range(warmup):
        update(lambda: None)
    losses, step_ms, forward_ms = [], [], []
    for step in range(steps):
        clock = _Clock(on_card)
        clock.mark()
        value = update(clock.mark)
        clock.mark()
        fwd, bwd = clock.intervals_ms()
        losses.append(value.detach().item())
        step_ms.append(fwd + bwd)
        forward_ms.append(fwd)
        if log is not None:
            log(f"step {step} loss {losses[-1]:.6f} step_ms "
                f"{step_ms[-1]:.3f}")
    return {"loss_list": losses, "step_ms_list": step_ms,
            "forward_ms_list": forward_ms,
            "timer": "cuda_events" if on_card else "host_clock"}
