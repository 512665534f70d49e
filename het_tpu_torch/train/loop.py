"""The training-step loop every trainer of the port runs: Adam, whose
defaults (eps outside the square root, bias correction) are
``optax.adam``'s, under a loss-scale policy (``scaling.py``), each step
run in the phases of ``utils/spans.py::Step`` and timed by its marks:
CUDA events on the card, the host clock on the CPU."""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..utils import spans
from .scaling import LossScaleState, all_finite, make_loss_scale


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

    def update(step: spans.Step):
        nonlocal scale_state
        with step.phase("zero_grad"):
            opt.zero_grad(set_to_none=True)
        with step.phase("forward"):
            local, value = step_loss()
        with step.phase("backward"):
            scaled = policy.scale(local, scale_state)
            scaled.backward()
            if scaled is not local:  # het_tpu reports the scaled loss / scale
                value = (policy.scale(value.detach(), scale_state)
                         / scale_state.scale)
            if after_backward is not None:
                after_backward()
            grads = [p.grad for p in params]
            policy.unscale_(grads, scale_state)
        with step.phase("adam"):
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

    for i in range(warmup):  # untimed; the first ends in a wait
        step = spans.Step(on_card, first=i == 0, timed=False)
        update(step)
        if i == 0:
            with step.phase("sync"):
                if on_card:
                    torch.cuda.synchronize(device)
        step.close()
    losses, step_ms, forward_ms = [], [], []
    done = start
    for epoch in range(start, steps):
        step = spans.Step(on_card, first=warmup == 0 and epoch == start)
        value = update(step)
        with step.phase("sync"):
            fwd, bwd = step.ms()
            losses.append(value.detach().item())
        step.close()
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
