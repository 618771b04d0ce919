"""LR schedules (port of self6dpp_tpu/engine/schedule.py: flat_and_anneal,
warmup_multistep). flat_and_anneal:
warm-up, then flat, then annealing from `anneal_point` of total_iters.
Evaluated in float32, as the JAX package evaluates it."""

from __future__ import annotations

import math

import numpy as np

from ..config import SolverConfig

_f32 = np.float32


def flat_and_anneal(cfg: SolverConfig):
    """Returns f(step) -> the float32 learning rate at `step`."""
    total = max(cfg.total_iters, 1)
    anneal_start = _f32(cfg.anneal_point * total)
    span = _f32(max(total - cfg.anneal_point * total, 1.0))
    warmup = _f32(max(cfg.warmup_iters, 1))

    def sched(step: int) -> np.float32:
        s = _f32(step)
        if cfg.warmup_method == "linear":
            alpha = np.clip(s / warmup, _f32(0), _f32(1))
            wf = _f32(cfg.warmup_factor) * (_f32(1) - alpha) + alpha
        elif cfg.warmup_method == "constant":
            wf = _f32(cfg.warmup_factor) if step < cfg.warmup_iters else _f32(1)
        else:
            wf = _f32(1)
        rel = np.clip((s - anneal_start) / span, _f32(0), _f32(1))
        if cfg.anneal_method == "cosine":
            af = _f32(0.5) * (np.cos(rel * _f32(math.pi)) + _f32(1))
        elif cfg.anneal_method == "linear":
            af = _f32(1) - rel
        elif cfg.anneal_method == "poly":
            af = (_f32(1) - rel) ** _f32(cfg.poly_power)
        elif cfg.anneal_method == "step":
            af = _f32(1)
            for st in cfg.steps:
                af = af * (_f32(cfg.step_gamma) if s >= st * total else _f32(1))
        else:
            af = _f32(1)
        if cfg.anneal_method != "step" and s < anneal_start:
            af = _f32(1)
        return _f32(_f32(cfg.base_lr) * wf * af)

    return sched


def warmup_multistep(cfg: SolverConfig):
    """WarmupMultiStepLR: linear warm-up, then a factor step_gamma at each
    milestone (cfg.steps, shares of total_iters). f(step) -> float32 lr."""
    total = max(cfg.total_iters, 1)
    milestones = [_f32(s * total) for s in cfg.steps]
    warmup = _f32(max(cfg.warmup_iters, 1))

    def sched(step: int) -> np.float32:
        s = _f32(step)
        alpha = np.clip(s / warmup, _f32(0), _f32(1))
        wf = _f32(cfg.warmup_factor) * (_f32(1) - alpha) + alpha
        f = _f32(1)
        for m in milestones:
            f = f * (_f32(cfg.step_gamma) if s >= m else _f32(1))
        return _f32(_f32(cfg.base_lr) * wf * f)

    return sched
