"""Train state and EMA teacher (port of self6dpp_tpu/engine/train_state.py).

The JAX package carries an immutable pytree of params, batch stats,
optimizer state and EMA params, and runs the teacher on the EMA params
with the student's batch stats. Here the student module holds the params
and the batch stats, the teacher is a copy of it in eval mode whose
parameters follow the student by EMA and whose batch-norm buffers are the
student's own tensors (so a stage-I step that trains BN moves the
teacher's statistics with the student's), and the optimizer holds its own
state; the step updates all three in place.
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
    # the sharded parameters (parallel/mesh.py::shard_state), or None
    fsdp: object | None = None

    def params(self) -> list[torch.Tensor]:
        """The student's parameters as the solver updates them (a sharded
        one's part in its place)."""
        if self.fsdp is not None:
            return self.fsdp.student.leaves()
        return list(self.model.parameters())

    def teacher_params(self) -> list[torch.Tensor]:
        if self.fsdp is not None:
            return self.fsdp.teacher.leaves()
        return list(self.teacher.parameters())

    @torch.no_grad()
    def update_ema(self, decay_fn: Callable[[int], float]) -> None:
        """teacher = teacher * d + (1 - d) * student, d = decay_fn(step)
        (called after the step count is incremented)."""
        if self.teacher is None:
            return
        d = _f32(decay_fn(self.step))
        ema = self.teacher_params()
        torch._foreach_mul_(ema, float(d))
        torch._foreach_add_(ema, torch._foreach_mul(
            self.params(), float(_f32(1) - d)))


def ema_decay_schedule(base_decay: float, ramp_iters: int = 2000):
    """d(step) = base_decay * (1 - exp(-step / ramp_iters)), in float32.
    The exponential is rounded once from float64 (numpy's float32 exp can be
    an ulp off, and 1 - exp cancels: at step 1 an ulp is 1e-4 of d)."""
    def fn(step: int) -> np.float32:
        e = _f32(np.exp(np.float64(-_f32(step) / _f32(ramp_iters))))
        return _f32(base_decay) * (_f32(1) - e)
    return fn


def gated_ema_decay(base_decay: float, warmup_iters: int, every: int = 1):
    """ema_decay_schedule that fires every `every` steps: decay 1 (the
    teacher unchanged) on the other steps."""
    raw = ema_decay_schedule(base_decay, warmup_iters)
    if every <= 1:
        return raw
    return lambda step: raw(step) if step % every == 0 else _f32(1)


def share_norm_buffers_(teacher: nn.Module, model: nn.Module) -> None:
    """Point every batch-norm buffer of the teacher (running statistics and
    count) at the student's tensor of the same name."""
    src = dict(model.named_modules())
    for name, m in teacher.named_modules():
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            for key in list(m._buffers):
                m._buffers[key] = src[name]._buffers[key]


def create_train_state(model: nn.Module, opt: torch.optim.Optimizer,
                       with_ema: bool = True) -> TrainState:
    teacher = None
    if with_ema:
        teacher = copy.deepcopy(model).eval()
        teacher.requires_grad_(False)
        share_norm_buffers_(teacher, model)
    return TrainState(step=0, model=model, teacher=teacher, opt=opt)
