"""The training-step loop every trainer of the port runs: Adam, whose
defaults (eps outside the square root, bias correction) are
``optax.adam``'s, under a loss-scale policy (``scaling.py``), and each
step timed with CUDA events on the card or the host clock on the CPU."""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from .scaling import LossScaleState, all_finite, make_loss_scale


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
    start: int = 0,
    loss_scale: str = "none",
    resume: Optional[Mapping[str, Any]] = None,
    stop: Optional[Callable[[int, float, Callable[[], Dict[str, Any]]],
                            bool]] = None,
    after_backward: Optional[Callable[[], None]] = None,
    log: Optional[Callable[[str], None]] = None,
) -> Dict[str, Any]:
    """``warmup`` untimed Adam steps, then the timed ones of epochs
    ``start`` to ``steps - 1``, on ``module``'s parameters (one optimizer
    state throughout).

    ``step_loss()`` runs the forward and returns ``(local, value)``: the
    tensor to differentiate and the loss to record (the same tensor in one
    process; on a rank of a data-parallel run, its share and the whole).
    A step scales ``local`` by the loss-scale policy ``loss_scale``
    (``scaling.make_loss_scale``), runs the backward, ``after_backward``
    (the gradient sum over ranks), unscales the gradients and updates
    the scale; under "dynamic" a step whose gradients are not all finite
    skips Adam, so the parameters and Adam's state (its step count
    included) stay as they were.  The recorded loss is the scaled loss
    divided by the scale, as het_tpu reports it.

    ``resume`` (a checkpoint's ``optimizer`` and ``loss_scale`` states)
    is loaded before the first step.  ``stop(epoch, loss, snapshot)``
    runs after each timed step; ``snapshot()`` gives the optimizer's and
    loss scale's states for a checkpoint; True ends the run.  Returns the
    losses, the step times, the forward's share of each (from the step's
    start to the loss), the timer used, the epochs reached and the loss
    scale's final state."""
    opt = torch.optim.Adam(module.parameters(), lr=lr)
    policy, dynamic = make_loss_scale(loss_scale)
    scale_state = policy.init_state()
    if resume is not None:
        opt.load_state_dict(resume["optimizer"])
        scale_state = LossScaleState.from_state_dict(resume["loss_scale"])
    scale_state = scale_state.to(device)
    on_card = device.type == "cuda"
    params = [p for group in opt.param_groups for p in group["params"]]

    def update(forward_done: Callable[[], None]):
        nonlocal scale_state
        opt.zero_grad(set_to_none=True)
        local, value = step_loss()
        forward_done()
        scaled = policy.scale(local, scale_state)
        scaled.backward()
        if scaled is not local:  # het_tpu reports the scaled loss / scale
            value = (policy.scale(value.detach(), scale_state)
                     / scale_state.scale)
        if after_backward is not None:
            after_backward()
        grads = [p.grad for p in params]
        policy.unscale_(grads, scale_state)
        if dynamic:
            finite = all_finite(grads)
            if bool(finite):  # the step's one wait for the card
                opt.step()
            scale_state = policy.update(scale_state, finite)
        else:
            opt.step()
        return value

    def snapshot() -> Dict[str, Any]:
        return {"optimizer": opt.state_dict(),
                "loss_scale": scale_state.state_dict()}

    for _ in range(warmup):
        update(lambda: None)
    losses, step_ms, forward_ms = [], [], []
    done = start
    for epoch in range(start, steps):
        clock = _Clock(on_card)
        clock.mark()
        value = update(clock.mark)
        clock.mark()
        fwd, bwd = clock.intervals_ms()
        losses.append(value.detach().item())
        step_ms.append(fwd + bwd)
        forward_ms.append(fwd)
        if log is not None:
            log(f"step {epoch} loss {losses[-1]:.6f} step_ms "
                f"{step_ms[-1]:.3f}")
        done = epoch + 1
        if stop is not None and stop(epoch, losses[-1], snapshot):
            break
    return {"loss_list": losses, "step_ms_list": step_ms,
            "forward_ms_list": forward_ms,
            "timer": "cuda_events" if on_card else "host_clock",
            "epochs_done": done,
            "loss_scale_state": {"scale": scale_state.scale.item(),
                                 "good_steps": int(scale_state.good_steps)}}
