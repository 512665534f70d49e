"""Mixed precision: the parameters' bf16 cast and loss scaling
(counterpart of ``het_tpu/train/scaling.py``).

A bf16 run keeps the master parameters and Adam's state in f32 and runs
the model on bf16 copies of the parameters (:func:`cast_floating` inside
the loss), so the cast's backward returns f32 gradients.  A loss-scale
policy multiplies the loss before the backward and divides the gradients
after it.  :class:`DynamicLossScale` is het_tpu's recipe with its
constants: a step whose gradients are not all finite is skipped (the
trainer leaves the parameters and Adam's state as they were) and halves
the scale; ``growth_interval`` finite steps in a row double it, within
``[min_scale, max_scale]``.  The state is two tensors (the scale, f32, and
the count of finite steps, int32), which a checkpoint carries; the trainer
keeps them on the card, where scaling, unscaling and the update read and
write them without a copy from the host (a copy from pageable host memory
waits for the stream, which would stall the step before its backward).  The
policies are written here rather than taken from ``torch.amp.GradScaler``,
whose constants, clamps and state differ from het_tpu's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Mapping, Optional, Tuple

import torch


def cast_floating(tensors: Mapping[str, torch.Tensor],
                  dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """Every floating tensor of ``tensors`` cast to ``dtype`` (a
    differentiable cast); other tensors as they are."""
    return {k: v.to(dtype) if v.is_floating_point() else v
            for k, v in tensors.items()}


def all_finite(tensors: Iterable[Optional[torch.Tensor]]) -> torch.Tensor:
    """A 0-dim bool tensor: every element of every tensor (None skipped)
    is finite."""
    flags = [torch.isfinite(t).all() for t in tensors if t is not None]
    return torch.stack(flags).all() if flags else torch.tensor(True)


@dataclass
class LossScaleState:
    scale: torch.Tensor  # f32, 0-dim
    good_steps: torch.Tensor  # int32, 0-dim

    def to(self, device) -> "LossScaleState":
        return LossScaleState(self.scale.to(device),
                              self.good_steps.to(device))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        return {"scale": self.scale.clone(),
                "good_steps": self.good_steps.clone()}

    @classmethod
    def from_state_dict(cls, d: Mapping[str, torch.Tensor]):
        return cls(torch.as_tensor(d["scale"], dtype=torch.float32),
                   torch.as_tensor(d["good_steps"], dtype=torch.int32))


def _state(scale: float) -> LossScaleState:
    return LossScaleState(torch.tensor(scale, dtype=torch.float32),
                          torch.tensor(0, dtype=torch.int32))


class NoOpLossScale:
    """No scaling (the default, and f32's), with the policies'
    interface."""

    def init_state(self) -> LossScaleState:
        return _state(1.0)

    def scale(self, loss: torch.Tensor, state: LossScaleState):
        return loss

    def unscale_(self, grads: Iterable[Optional[torch.Tensor]],
                 state: LossScaleState) -> None:
        pass

    def update(self, state: LossScaleState,
               finite: torch.Tensor) -> LossScaleState:
        return state


class StaticLossScale(NoOpLossScale):
    """A fixed scale: the loss times it, the gradients divided by it."""

    def __init__(self, scale: float):
        self.init_scale = float(scale)

    def init_state(self) -> LossScaleState:
        return _state(self.init_scale)

    def scale(self, loss, state):
        return loss * state.scale.to(loss.dtype)

    def unscale_(self, grads, state):
        inv = (1.0 / state.scale).to(torch.float32)
        for g in grads:
            if g is not None:
                g.mul_(inv.to(g.dtype))


@dataclass(frozen=True)
class DynamicLossScale(StaticLossScale):
    """het_tpu's dynamic policy (``train/scaling.py:59-95``)."""

    init_scale: float = 2.0 ** 15
    growth_interval: int = 200
    factor: float = 2.0
    min_scale: float = 1.0
    max_scale: float = 2.0 ** 24

    def update(self, state, finite):
        scale, good = state.scale, state.good_steps
        finite = torch.as_tensor(finite).to(scale.device)
        grown = good + 1 >= self.growth_interval
        new_scale = torch.where(
            finite,
            torch.where(grown, torch.clamp(scale * self.factor,
                                           max=self.max_scale), scale),
            torch.clamp(scale / self.factor, min=self.min_scale))
        new_good = torch.where(finite & ~grown, good + 1,
                               torch.zeros_like(good))
        return LossScaleState(new_scale, new_good)


def make_loss_scale(spec) -> Tuple[NoOpLossScale, bool]:
    """``(policy, dynamic)`` from ``--loss_scale``: "none" (or None, 0),
    "dynamic", or a number, the static scale (``make_loss_scale``,
    ``train/scaling.py:117-139``)."""
    if spec in (None, "none", 0, 0.0):
        return NoOpLossScale(), False
    if spec == "dynamic":
        return DynamicLossScale(), True
    return StaticLossScale(float(spec)), False
