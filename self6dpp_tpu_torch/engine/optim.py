"""The solver (port of self6dpp_tpu/engine/optim.py for optimizer "ranger"
and "adam"): nan_to_num -> clip_by_global_norm -> add_decayed_weights ->
the core, with the arithmetic of the optax chain the JAX package builds.

  ranger  lookahead(RAdam): optax's scale_by_radam (threshold 5, rectified
          when rho >= 5, eps outside the square root) inside a Lookahead
          that syncs every 6 steps with slow step 0.5;
  adam    optax's scale_by_adam (eps outside the square root, eps_root 0).

torch.optim.RAdam's rectification branch differs, so the updates are
written here, per leaf with torch._foreach_* ops. Gradient accumulation to
reference_bs is optax.MultiSteps: the running mean of the micro-batches'
raw gradients, the chain applied to it every k-th step (the learning-rate
count and the Lookahead's count advance only then), the parameters left as
they are on the other steps. The JAX package runs the chain on one
flattened vector; that changes no arithmetic, only the order of the
global-norm sum. The other optimizers (radam, adamw, adabelief, sgd,
sgd_gc, madgrad, adamp, sgdp) raise.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import numpy as np
import torch

from ..config import SolverConfig
from .schedule import flat_and_anneal, warmup_multistep

_f32 = np.float32
CORES = ("ranger", "adam")


class Solver(torch.optim.Optimizer):
    """lr_fn(count) gives the learning rate of the count-th update (from
    0). Parameters without a gradient take a zero gradient, as JAX's do.
    `count` counts the updates, `mini_step` the micro-batches accumulated
    toward the next one (accum > 1)."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr_fn: Callable[[int], float], core: str = "ranger",
                 grad_clip_norm: float = 35.0, weight_decay: float = 0.0,
                 accum: int = 1, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, threshold: float = 5.0,
                 sync_period: int = 6, slow_step_size: float = 0.5):
        if core not in CORES:
            raise ValueError(f"unknown core: {core!r}")
        super().__init__(params, dict(b1=b1, b2=b2, eps=eps))
        self.lr_fn = lr_fn
        self.core = core
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay = weight_decay
        self.accum = max(int(accum), 1)
        self.threshold = threshold
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        self.count = 0
        self.mini_step = 0
        for p in self._params():
            st = self.state[p]
            st["mu"] = torch.zeros_like(p)
            st["nu"] = torch.zeros_like(p)
            if core == "ranger":
                st["slow"] = p.detach().clone()
            if self.accum > 1:
                st["acc"] = torch.zeros_like(p)

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Solver.step takes no closure")
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        if self.accum > 1:
            # MultiSteps: acc += (g - acc) / (n + 1); the chain runs on the
            # mean at the k-th micro-batch, which also empties acc
            acc = [self.state[p]["acc"] for p in params]
            torch._foreach_add_(acc, torch._foreach_div(
                torch._foreach_sub(grads, acc), float(self.mini_step + 1)))
            self.mini_step += 1
            if self.mini_step < self.accum:
                return
            self.mini_step = 0
            grads = [a.clone() for a in acc]
            # emptied as MultiSteps empties it, by a product with 0: an
            # element that took a NaN keeps it (its gradient is 0 from then
            # on, after nan_to_num)
            torch._foreach_mul_(acc, 0.0)
        self._update(params, grads)

    def _update(self, params, grads):
        grp = self.param_groups[0]
        b1, b2, eps = grp["b1"], grp["b2"], grp["eps"]
        grads = [torch.nan_to_num(g) for g in grads]
        if self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.grad_clip_norm
            clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                         self.grad_clip_norm)
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        if self.weight_decay > 0:
            grads = torch._foreach_add(grads, torch._foreach_mul(
                params, self.weight_decay))

        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
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
        mu_hat = torch._foreach_div(mu, bc1)
        lr = float(self.lr_fn(self.count - 1))
        if self.core == "adam":
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu_hat, denom)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
            return
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = _f32(ro_inf) - _f32(2 * self.count) * b2t / (_f32(1) - b2t)
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
        slow = [self.state[p]["slow"] for p in params]
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


def build_optimizer(cfg: SolverConfig, params: Iterable[torch.Tensor]) -> Solver:
    """The JAX package's chain for optimizer ranger or adam on the
    flat_and_anneal or warmup_multistep schedule, with weight decay and
    accumulation to reference_bs. Raises for the other optimizers and
    schedules."""
    name = cfg.optimizer.lower()
    if name not in CORES:
        raise ValueError(f"optimizer {cfg.optimizer!r}: the port has "
                         f"{', '.join(CORES)}")
    scheds = {"flat_and_anneal": flat_and_anneal,
              "warmup_multistep": warmup_multistep}
    if cfg.lr_sched not in scheds:
        raise ValueError(f"lr_sched {cfg.lr_sched!r}: the port has "
                         f"{', '.join(scheds)}")
    accum = max(cfg.reference_bs // max(cfg.ims_per_batch, 1), 1)
    return Solver(params, scheds[cfg.lr_sched](cfg), core=name,
                  grad_clip_norm=cfg.grad_clip_norm,
                  weight_decay=cfg.weight_decay, accum=accum)
