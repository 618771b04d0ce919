"""Train state and EMA teacher (port of self6dpp_tpu/engine/train_state.py).

The JAX package carries an immutable pytree of params, batch stats,
optimizer state and EMA params. Here the student module holds the params
and (frozen) batch stats, the teacher is a copy of it whose parameters
follow the student by EMA, and the optimizer holds its own state; the step
updates all three in place.
"""

from __future__ import annotations

import copy
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

_f32 = np.float32


@dataclass
class TrainState:
    step: int
    model: nn.Module                 # the student
    teacher: nn.Module | None        # mean teacher (None if EMA is off)
    opt: torch.optim.Optimizer

    @torch.no_grad()
    def update_ema(self, decay_fn: Callable[[int], float]) -> None:
        """teacher = teacher * d + (1 - d) * student, d = decay_fn(step)
        (called after the step count is incremented)."""
        if self.teacher is None:
            return
        d = _f32(decay_fn(self.step))
        ema = list(self.teacher.parameters())
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(
            list(self.model.parameters()), float(_f32(1) - d)))


def ema_decay_schedule(base_decay: float, ramp_iters: int = 2000):
    """d(step) = base_decay * (1 - exp(-step / ramp_iters)), in float32.
    The exponential is rounded once from float64 (numpy's float32 exp can be
    an ulp off, and 1 - exp cancels: at step 1 an ulp is 1e-4 of d)."""
    def fn(step: int) -> np.float32:
        e = _f32(np.exp(np.float64(-_f32(step) / _f32(ramp_iters))))
        return _f32(base_decay) * (_f32(1) - e)
    return fn


def create_train_state(model: nn.Module, opt: torch.optim.Optimizer,
                       with_ema: bool = True) -> TrainState:
    teacher = None
    if with_ema:
        teacher = copy.deepcopy(model)
        teacher.requires_grad_(False)
    return TrainState(step=0, model=model, teacher=teacher, opt=opt)
