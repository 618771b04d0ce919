"""Ranger, the stage-II solver (port of self6dpp_tpu/engine/optim.py for
optimizer="ranger"): nan_to_num -> clip_by_global_norm -> lookahead(RAdam),
in the order and with the arithmetic of the optax chain the JAX package
builds (optax's scale_by_radam: threshold 5, rectified when rho >= 5, eps
outside the square root; a Lookahead that syncs every 6 steps with slow
step 0.5). torch.optim.RAdam's rectification branch differs, so the update
is written here, per leaf with torch._foreach_* ops. The JAX package runs
the chain on one flattened vector; that changes no arithmetic, only the
order of the global-norm sum.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import numpy as np
import torch

from ..config import SolverConfig
from .schedule import flat_and_anneal

_f32 = np.float32


class Ranger(torch.optim.Optimizer):
    """lr_fn(count) gives the learning rate of the count-th update (from
    0). Parameters without a gradient take a zero gradient, as JAX's do."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr_fn: Callable[[int], float], grad_clip_norm: float = 35.0,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 threshold: float = 5.0, sync_period: int = 6,
                 slow_step_size: float = 0.5):
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.lr_fn = lr_fn
        self.grad_clip_norm = grad_clip_norm
        self.threshold = threshold
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        self.count = 0
        for p in self._params():
            st = self.state[p]
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
            st["slow"] = p.detach().clone()

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Ranger.step takes no closure")
        params = self._params()
        grp = self.param_groups[0]
        b1, b2, eps = grp["b1"], grp["b2"], grp["eps"]
        grads = [torch.nan_to_num(p.grad) if p.grad is not None
                 else torch.zeros_like(p) for p in params]
        if self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.grad_clip_norm
            clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                         self.grad_clip_norm)
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]

        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        slow = [self.state[p]["slow"] for p in params]
        # moments: (1 - b) g + b m, (1 - b2) g^2 + b2 v
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))

        self.count += 1
        t = np.int32(self.count)
        bc1 = float(_f32(1) - _f32(b1) ** t)
        b2t = _f32(b2) ** t
        bc2 = float(_f32(1) - b2t)
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = _f32(ro_inf) - _f32(2 * self.count) * b2t / (_f32(1) - b2t)
        mu_hat = torch._foreach_div(mu, bc1)
        lr = float(self.lr_fn(self.count - 1))
        if ro >= self.threshold:
            r = np.sqrt((ro - _f32(4)) * (ro - _f32(2)) * _f32(ro_inf) / (
                _f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_mul(mu_hat, float(r))
            torch._foreach_div_(upd, denom)
        else:
            upd = mu_hat
        torch._foreach_mul_(upd, -lr)

        # lookahead: fast weights p + u; every sync_period steps the params
        # move onto slow + a (fast - slow), which becomes the new slow
        fast = torch._foreach_add(params, upd)
        if self.count % self.sync_period == 0:
            new_slow = torch._foreach_add(slow, torch._foreach_mul(
                torch._foreach_sub(fast, slow), self.slow_step_size))
            delta = torch._foreach_sub(new_slow, params)
            for s, n in zip(slow, new_slow):
                s.copy_(n)
        else:
            delta = torch._foreach_sub(fast, params)
        torch._foreach_add_(params, delta)


def build_optimizer(cfg: SolverConfig, params: Iterable[torch.Tensor]) -> Ranger:
    """The solver of the stage-II configs: Ranger on flat_and_anneal.
    Raises for the other optimizers, schedules, weight decay and gradient
    accumulation, which belong to later slices."""
    if cfg.optimizer.lower() != "ranger":
        raise ValueError(f"optimizer {cfg.optimizer!r}: only ranger is ported")
    if cfg.lr_sched != "flat_and_anneal":
        raise ValueError(f"lr_sched {cfg.lr_sched!r}: only flat_and_anneal "
                         "is ported")
    if cfg.weight_decay > 0:
        raise ValueError("weight decay belongs to a later slice")
    if cfg.reference_bs // max(cfg.ims_per_batch, 1) > 1:
        raise ValueError("gradient accumulation (MultiSteps) belongs to a "
                         "later slice")
    return Ranger(params, flat_and_anneal(cfg), cfg.grad_clip_norm)
