"""The solver (port of self6dpp_tpu/engine/optim.py): nan_to_num ->
clip_by_global_norm -> add_decayed_weights -> the core, with the
arithmetic of the optax chain the JAX package builds for each optimizer:

  ranger     lookahead(RAdam): optax's scale_by_radam (threshold 5,
             rectified when rho >= 5, eps outside the square root) inside
             a Lookahead that syncs every 6 steps with slow step 0.5;
  radam      the same RAdam without the Lookahead;
  adam       optax's scale_by_adam (eps outside the square root,
             eps_root 0);
  adamw      adam, then the decayed weights (weight_decay * p) added to
             the update before the learning rate (and not before the core);
  adabelief  optax's scale_by_belief (eps = eps_root = 1e-16);
  sgd        optax's trace (heavy-ball momentum g + m * trace);
  sgd_gc     sgd on centralised gradients: each weight's gradient minus its
             mean over every axis but the output axis;
  madgrad    the JAX package's MADGRAD: dual averages s += lam g,
             v += lam g^2 with lam = lr sqrt(k + 1), z = x0 - s / (cbrt(v)
             + 1e-6), x <- 0.1 z + 0.9 x (momentum 0.9);
  adamp      adam, then the AdamP projection of each update;
  sgdp       Nesterov sgd, then the same projection.

The projection (delta 0.1, eps 1e-8) removes the radial part of a
weight's update where the update is nearly orthogonal to the weight, in
the channel view (one row per first axis) or else the layer view. Gradient
centralisation and the projection reduce over a weight's axes, and the
JAX package lays weights out otherwise than torch (a conv kernel as (kh,
kw, in, out)): given the kinds of convert.param_kinds, both run on each
weight in the JAX package's layout; without them, on the tensor as it is.

torch.optim.RAdam's rectification branch differs, so the updates are
written here, per leaf with torch._foreach_* ops. Gradient accumulation to
reference_bs is optax.MultiSteps: the running mean of the micro-batches'
raw gradients, the chain applied to it every k-th step (the learning-rate
count and the Lookahead's count advance only then), the parameters left as
they are on the other steps. The JAX package runs the elementwise chains
on one flattened vector (sgd_gc, adamp and sgdp per leaf); that changes no
arithmetic, only the order of the global-norm sum.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence

import numpy as np
import torch
from torch import Tensor

from ..config import SolverConfig
from .schedule import flat_and_anneal, warmup_multistep

_f32 = np.float32
CORES = ("ranger", "radam", "adam", "adamw", "adabelief", "sgd", "sgd_gc",
         "madgrad", "adamp", "sgdp")
_MOMENTS = ("ranger", "radam", "adam", "adamw", "adabelief", "adamp")
_TRACE = ("sgd", "sgd_gc", "sgdp")
_PROJECTED = ("adamp", "sgdp")
# optax's epsilons: adam, radam and their kin 1e-8 outside the square root;
# adabelief 1e-16 inside and outside; the JAX package's MADGRAD 1e-6
_EPS = {"adabelief": 1e-16, "madgrad": 1e-6}
_BELIEF_EPS_ROOT = 1e-16
_PROJ_DELTA, _PROJ_EPS = 0.1, 1e-8


def to_jax_layout(t: Tensor, kind: str | None) -> Tensor:
    """A weight (or its gradient) as the JAX package lays its counterpart
    out, up to a reversal of the kernel axes (which changes neither a mean
    nor the projection): conv (out, in, kh, kw) -> (kh, kw, in, out),
    deconv (in, out, kh, kw) -> (kh, kw, in, out), fc (out, in) -> (in,
    out), dense (a 1x1 conv) -> (in, out); anything else as it is."""
    if kind == "conv" and t.ndim == 4:
        return t.permute(2, 3, 1, 0)
    if kind == "deconv" and t.ndim == 4:
        return t.permute(2, 3, 0, 1)
    if kind in ("fc", "fc_flat") and t.ndim == 2:
        return t.t()
    if kind == "dense" and t.ndim == 4:
        return t.reshape(t.shape[:2]).t()
    return t


def from_jax_layout(x: Tensor, kind: str | None, like: Tensor) -> Tensor:
    """The inverse of to_jax_layout for a tensor shaped like `like`."""
    if kind == "conv" and like.ndim == 4:
        return x.permute(3, 2, 0, 1)
    if kind == "deconv" and like.ndim == 4:
        return x.permute(2, 3, 0, 1)
    if kind in ("fc", "fc_flat") and like.ndim == 2:
        return x.t()
    if kind == "dense" and like.ndim == 4:
        return x.t().reshape(like.shape)
    return x


def centralize(g: Tensor) -> Tensor:
    """Gradient centralisation of a JAX-layout gradient: minus its mean
    over every axis but the last (the output axis)."""
    if g.ndim <= 1:
        return g
    return g - g.mean(dim=tuple(range(g.ndim - 1)), keepdim=True)


def project(p: Tensor, u: Tensor) -> Tensor:
    """The AdamP/SGDP projection of the update u of the JAX-layout weight
    p: where the largest |cos(u, p)| over the channel view's rows (or else
    over the flattened layer) is below delta / sqrt(row length), the
    update loses its component along the normalised weight rows."""
    if p.ndim == 0:
        return u

    def view(x, channel):
        return x.reshape(x.shape[0], -1) if channel else x.reshape(1, -1)

    def cos_below(channel):
        u2, p2 = view(u, channel), view(p, channel)
        num = (u2 * p2).sum(-1).abs()
        den = torch.linalg.vector_norm(u2, dim=-1) \
            * torch.linalg.vector_norm(p2, dim=-1)
        cos = (num / den.clamp_min(_PROJ_EPS)).amax()
        return cos < _f32(_PROJ_DELTA) / np.sqrt(_f32(p2.shape[1]))

    def projected(channel):
        p2, u2 = view(p, channel), view(u, channel)
        n = p2 / (torch.linalg.vector_norm(p2, dim=-1, keepdim=True)
                  + _PROJ_EPS)
        return (u2 - n * (n * u2).sum(-1, keepdim=True)).reshape(u.shape)

    return torch.where(cos_below(True), projected(True),
                       torch.where(cos_below(False), projected(False), u))


class Solver(torch.optim.Optimizer):
    """lr_fn(count) gives the learning rate of the count-th update (from
    0). Parameters without a gradient take a zero gradient, as JAX's do.
    `count` counts the updates, `mini_step` the micro-batches accumulated
    toward the next one (accum > 1). `kinds` (one per parameter, in order;
    convert.param_kinds) lays each weight out as the JAX package does for
    sgd_gc's centralisation and the adamp/sgdp projection."""

    def __init__(self, params: Iterable[torch.Tensor],
                 lr_fn: Callable[[int], float], core: str = "ranger",
                 grad_clip_norm: float = 35.0, weight_decay: float = 0.0,
                 accum: int = 1, momentum: float = 0.9,
                 kinds: Sequence[str | None] | None = None,
                 b1: float = 0.9, b2: float = 0.999, threshold: float = 5.0,
                 sync_period: int = 6, slow_step_size: float = 0.5):
        if core not in CORES:
            raise ValueError(f"unknown core: {core!r}")
        super().__init__(params, dict(b1=b1, b2=b2, eps=_EPS.get(core, 1e-8)))
        self.lr_fn = lr_fn
        self.core = core
        self.grad_clip_norm = grad_clip_norm
        self.weight_decay = weight_decay
        self.accum = max(int(accum), 1)
        self.momentum = momentum
        self.threshold = threshold
        self.sync_period = sync_period
        self.slow_step_size = slow_step_size
        ps = self._params()
        self.kinds = list(kinds) if kinds is not None else [None] * len(ps)
        if len(self.kinds) != len(ps):
            raise ValueError(f"{len(self.kinds)} kinds for {len(ps)} params")
        self.reset()

    @torch.no_grad()
    def reset(self) -> None:
        """A fresh state at the parameters' current values: no update
        counted, zero moments, the Lookahead's slow weights (and MADGRAD's
        x0) copies of the parameters."""
        core = self.core
        self.count = 0
        self.mini_step = 0
        for p in self._params():
            st = self.state[p]
            if core in _MOMENTS:
                st["mu"] = torch.zeros_like(p)
                st["nu"] = torch.zeros_like(p)
            elif core in _TRACE:
                st["trace"] = torch.zeros_like(p)
            else:                                   # madgrad
                st["x0"] = p.detach().clone()
                st["s"] = torch.zeros_like(p)
                st["v"] = torch.zeros_like(p)
            if core == "ranger":
                st["slow"] = p.detach().clone()
            if self.accum > 1:
                st["acc"] = torch.zeros_like(p)

    def _params(self) -> list[torch.Tensor]:
        return [p for g in self.param_groups for p in g["params"]]

    def state_dict(self) -> dict:
        sd = super().state_dict()
        sd["counts"] = {"count": self.count, "mini_step": self.mini_step}
        return sd

    def load_state_dict(self, state_dict: dict) -> None:
        sd = dict(state_dict)
        counts = sd.pop("counts")
        super().load_state_dict(sd)
        self.count, self.mini_step = counts["count"], counts["mini_step"]

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

    def _jax_layout(self, fn, *tensors):
        """fn applied to each parameter's tensors in the JAX layout."""
        out = []
        for kind, ts in zip(self.kinds, zip(*tensors)):
            r = fn(*(to_jax_layout(t, kind) for t in ts))
            out.append(from_jax_layout(r, kind, ts[0]))
        return out

    def _update(self, params, grads):
        grads = [torch.nan_to_num(g) for g in grads]
        if self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
            keep = norm < self.grad_clip_norm
            clipped = torch._foreach_mul(torch._foreach_div(grads, norm),
                                         self.grad_clip_norm)
            grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        if self.weight_decay > 0 and self.core != "adamw":
            grads = torch._foreach_add(grads, torch._foreach_mul(
                params, self.weight_decay))
        if self.core == "sgd_gc":
            grads = self._jax_layout(centralize, grads)

        self.count += 1
        lr = float(self.lr_fn(self.count - 1))
        if self.core in _MOMENTS:
            upd = self._moments(params, grads)
        elif self.core in _TRACE:
            upd = self._trace(params, grads)
        else:
            upd = self._madgrad(params, grads, lr)
        if self.core != "madgrad":
            torch._foreach_mul_(upd, -lr)
        if self.core in _PROJECTED:
            upd = self._jax_layout(project, params, upd)
        if self.core == "ranger":
            upd = self._lookahead(params, upd)
        torch._foreach_add_(params, upd)

    def _moments(self, params, grads) -> list[Tensor]:
        """The adam family's update before the learning rate."""
        grp = self.param_groups[0]
        b1, b2, eps = grp["b1"], grp["b2"], grp["eps"]
        mu = [self.state[p]["mu"] for p in params]
        nu = [self.state[p]["nu"] for p in params]
        # moments: (1 - b) g + b m, (1 - b2) x^2 + b2 v with x = g, or for
        # adabelief the prediction error g - m (with m the new moment)
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1 - b1))
        x = grads if self.core != "adabelief" else torch._foreach_sub(grads, mu)
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(x, x),
                                                   1 - b2))
        if self.core == "adabelief":
            torch._foreach_add_(nu, _BELIEF_EPS_ROOT)

        t = np.int32(self.count)
        bc1 = float(_f32(1) - _f32(b1) ** t)
        b2t = _f32(b2) ** t
        bc2 = float(_f32(1) - b2t)
        mu_hat = torch._foreach_div(mu, bc1)

        def adam_step():
            denom = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
            torch._foreach_add_(denom, eps)
            return torch._foreach_div(mu_hat, denom)

        if self.core in ("adam", "adabelief", "adamp"):
            return adam_step()
        if self.core == "adamw":
            upd = adam_step()
            torch._foreach_add_(upd, torch._foreach_mul(params,
                                                        self.weight_decay))
            return upd
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        ro = _f32(ro_inf) - _f32(2 * self.count) * b2t / (_f32(1) - b2t)
        if ro < self.threshold:
            return mu_hat
        r = np.sqrt((ro - _f32(4)) * (ro - _f32(2)) * _f32(ro_inf) / (
            _f32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        upd = adam_step()
        torch._foreach_mul_(upd, float(r))
        return upd

    def _trace(self, params, grads) -> list[Tensor]:
        """optax.trace: trace = g + m trace; the update is the trace, or
        with Nesterov (sgdp) g + m trace."""
        tr = [self.state[p]["trace"] for p in params]
        torch._foreach_mul_(tr, self.momentum)
        torch._foreach_add_(tr, grads)
        if self.core != "sgdp":
            return [t.clone() for t in tr]
        return torch._foreach_add(grads, torch._foreach_mul(tr, self.momentum))

    def _madgrad(self, params, grads, lr: float) -> list[Tensor]:
        """The JAX package's MADGRAD update (the learning rate inside)."""
        k = self.count - 1
        lam = float(_f32(lr) * np.sqrt(_f32(k) + _f32(1)))
        st = [self.state[p] for p in params]
        s = [x["s"] for x in st]
        v = [x["v"] for x in st]
        lg = torch._foreach_mul(grads, lam)
        torch._foreach_add_(s, lg)
        torch._foreach_add_(v, torch._foreach_mul(lg, grads))
        m = self.momentum
        upd = []
        for p, x, ss, vv in zip(params, st, s, v):
            z = x["x0"] - ss / (vv.clamp_min(0.0).pow(1.0 / 3.0) + _EPS["madgrad"])
            upd.append((1 - m) * z + m * p - p)
        return upd

    def _lookahead(self, params, upd) -> list[Tensor]:
        """Fast weights p + u; every sync_period steps the params move onto
        slow + a (fast - slow), which becomes the new slow."""
        slow = [self.state[p]["slow"] for p in params]
        fast = torch._foreach_add(params, upd)
        if self.count % self.sync_period:
            return torch._foreach_sub(fast, params)
        new_slow = torch._foreach_add(slow, torch._foreach_mul(
            torch._foreach_sub(fast, slow), self.slow_step_size))
        delta = torch._foreach_sub(new_slow, params)
        for s, n in zip(slow, new_slow):
            s.copy_(n)
        return delta


def build_optimizer(cfg: SolverConfig, params: Iterable[torch.Tensor],
                    kinds: Sequence[str | None] | None = None) -> Solver:
    """The JAX package's chain for cfg.optimizer on the flat_and_anneal or
    warmup_multistep schedule (any other lr_sched: base_lr throughout),
    with weight decay and accumulation to reference_bs. kinds: see
    Solver. Raises for an unknown optimizer."""
    name = cfg.optimizer.lower()
    if name not in CORES:
        raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")
    scheds = {"flat_and_anneal": flat_and_anneal,
              "warmup_multistep": warmup_multistep}
    if cfg.lr_sched in scheds:
        lr_fn = scheds[cfg.lr_sched](cfg)
    else:
        lr_fn = lambda step: cfg.base_lr
    accum = max(cfg.reference_bs // max(cfg.ims_per_batch, 1), 1)
    return Solver(params, lr_fn, core=name,
                  grad_clip_norm=cfg.grad_clip_norm,
                  weight_decay=cfg.weight_decay, accum=accum,
                  momentum=cfg.momentum, kinds=kinds)
