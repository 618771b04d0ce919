"""GDRN construction, inputs and the stage-I train and eval steps (port of
self6dpp_tpu/engine/gdrn_engine.py: BATCH_MODEL_KEYS, model_inputs,
build_gdrn, init_state, make_train_step, make_eval_step).

The stage-I step: the student's forward with batch norm in train mode
(Flax's statistics and running update, models/layers.py::FlaxBatchNorm2d),
in the configured compute dtype; the GDRN loss (with the MTL weighting
when use_mtl); backward; the solver; the EMA teacher. The JAX package
jits it into one XLA program; here it runs eagerly and updates the state
in place.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import torch
from torch import Tensor, nn

from .. import resolve_device
from ..config import Config
from ..convert import param_kinds
from ..losses.gdrn_loss import gdrn_loss
from ..models.gdrn import GDRN
from ..parallel.dist import average_gradients
from .optim import build_optimizer
from .train_state import TrainState, create_train_state, ema_decay_schedule

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

BATCH_MODEL_KEYS = (
    "roi_img", "roi_cls", "roi_cam", "roi_center", "roi_wh", "roi_extent",
    "resize_ratio", "roi_coord_2d",
)
# flax's truncated normal draws within 2 std of a unit normal and rescales
# by the truncated distribution's std so the variance is the asked one
_TRUNC_STD = 0.87962566103423978


def model_inputs(batch: dict[str, Tensor]) -> tuple:
    return tuple(batch[k] for k in BATCH_MODEL_KEYS)


def no_mark(name: str) -> None:
    pass


def event_marker(marks: list) -> Callable[[str], None]:
    """mark(name) appends (name, a recorded CUDA event) to `marks`: the
    phases of a step on the card's clock, read after a synchronize."""
    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    return mark


def autocast(cfg: Config, device: torch.device):
    """The compute dtype's autocast context (none for float32)."""
    dtype = DTYPES[cfg.dist.compute_dtype]
    return torch.autocast(device.type, dtype=dtype,
                          enabled=dtype != torch.float32)


@torch.no_grad()
def init_weights_(model: GDRN, generator: torch.Generator) -> GDRN:
    """Draw the weights as the JAX package's initialisers do: LeCun normal
    (truncated) for convs, transposed convs and dense layers, zero biases;
    N(0, 0.01) for the geo head's out layer(s) and the pose outputs,
    N(0, 1e-3) for the PnP convs and hidden dense layers; norms at scale 1,
    bias 0 and BN statistics (0, 1). Drawn in float32 on the CPU, whatever
    the model's device."""
    def draw(shape, std, trunc):
        w = torch.empty(shape)
        if trunc:
            s = std / _TRUNC_STD
            return nn.init.trunc_normal_(w, 0.0, s, -2 * s, 2 * s, generator=generator)
        return nn.init.normal_(w, 0.0, std, generator=generator)

    pnp = {id(m) for m in model.pnp_net.modules()}
    for name, m in model.named_modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = m.weight
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = w.shape[0] * w.shape[2] * w.shape[3]
            else:
                fan_in = math.prod(w.shape[1:])
            if name.startswith("geo_head_net.out_") or name in (
                    "pnp_net.fc_r", "pnp_net.fc_t", "pnp_net.fc_pose"):
                new = draw(w.shape, 0.01, False)
            elif id(m) in pnp:
                new = draw(w.shape, 1e-3, False)
            else:
                new = draw(w.shape, fan_in ** -0.5, True)
            w.copy_(new)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.BatchNorm2d, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
    return model


def build_gdrn(cfg: Config, device=None, seed: int | None = None) -> GDRN:
    """GDRN on `device` (CUDA by default), float32 parameters, in eval mode
    (BN frozen, as the stage-II steps run it). With a seed its weights are
    drawn as the JAX package initialises them (init_weights_)."""
    model = GDRN(cfg.model)
    if seed is not None:
        init_weights_(model, torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval()


def dropout_generator(cfg: Config, step: int, device
                      ) -> torch.Generator | None:
    """The generator of one step's DropBlock draws (where the JAX steps
    pass rngs={'dropout': rng}), on `device`, seeded from cfg.seed and the
    step number; None when the PnP head's drop_prob is 0, so that no
    configuration without DropBlock makes one."""
    if cfg.model.pnp_net.drop_prob <= 0:
        return None
    g = torch.Generator(device=device)
    return g.manual_seed((cfg.seed << 32) + step)


def init_state(cfg: Config, model: nn.Module) -> TrainState:
    """Student, EMA teacher and the solver over the student's parameters
    (a GDRN's or a DeepIM's, laid out for the solver as the JAX package
    lays them out: convert.param_kinds)."""
    opt = build_optimizer(cfg.solver, model.parameters(),
                          kinds=list(param_kinds(model).values()))
    return create_train_state(model, opt, with_ema=cfg.solver.ema_decay > 0)


def descend(state: TrainState, ld: dict[str, Tensor], decay_fn, mark=no_mark,
            extra_grads=None):
    """The tail of every step: the total (summed in sorted key order, as
    jax.tree.leaves orders a dict), backward, extra_grads (one tensor or
    None per model parameter, in order) added to the gradients, the
    gradients averaged over the ranks under data parallel (parallel/
    dist.py; a sharded state's first reduce-scattered within the fsdp
    group, parallel/mesh.py), the solver, the step count, the EMA, the
    gathered parameters dropped. Returns (state, metrics as detached 0-d
    tensors: this rank's terms)."""
    total = sum(ld[k] for k in sorted(ld))
    state.opt.zero_grad(set_to_none=True)
    total.backward()
    if extra_grads is not None:
        add_gradients(state.model.parameters(), extra_grads)
    if state.fsdp is not None:
        state.fsdp.reduce_grads()
    average_gradients(state.params())
    mark("backward")
    state.opt.step()
    state.step += 1
    state.update_ema(decay_fn)
    if state.fsdp is not None:
        state.fsdp.release()
    mark("optimizer_ema")
    metrics = {k: v.detach() for k, v in ld.items()}
    metrics["total_loss"] = total.detach()
    return state, metrics


@torch.no_grad()
def add_gradients(params, grads) -> None:
    """p.grad += g for each parameter (g None: nothing; a parameter
    without a gradient takes g)."""
    for p, g in zip(params, grads):
        if g is None:
            continue
        if p.grad is None:
            p.grad = g.detach().clone()
        else:
            p.grad += g


def make_train_step(cfg: Config, model: GDRN):
    """Returns train_step(state, batch, mark=None) -> (state, metrics): one
    stage-I step on a batch with the ground truth of
    data/synthetic.py::make_gdrn_batch, updating the state in place. BN
    trains (its running statistics move), the teacher follows by EMA at
    ema_decay_schedule(solver.ema_decay, solver.ema_warmup_iters) of the
    step count (which counts micro-batches under accumulation, as the JAX
    state's does). DropBlock (drop_prob > 0) draws from
    dropout_generator(cfg, step count). metrics holds every loss term and
    total_loss as 0-d tensors; mark(name), if given, is called after the
    forward, the loss, the backward and the optimizer + EMA."""
    decay_fn = ema_decay_schedule(cfg.solver.ema_decay,
                                  cfg.solver.ema_warmup_iters)
    gh = cfg.model.geo_head

    def train_step(state: TrainState, batch: dict[str, Tensor], mark=None):
        mark = mark or no_mark
        net = state.model.train()
        dev = next(net.parameters()).device
        with autocast(cfg, dev):
            out = net(*model_inputs(batch),
                      generator=dropout_generator(cfg, state.step, dev))
        out = {k: v.float() for k, v in out.items()}
        mark("forward")
        ld = gdrn_loss(cfg.model.loss, cfg.model.pnp_net, out, batch,
                       num_regions=gh.num_regions, xyz_bin=gh.xyz_bin,
                       mtl_log_vars=net.mtl if cfg.model.use_mtl else None)
        mark("loss")
        return descend(state, ld, decay_fn, mark)

    return train_step


def make_eval_step(cfg: Config, model: GDRN, use_ema: bool = False):
    """Returns eval_step(state, batch) -> {'rot', 'trans'}: the student's
    (or, with use_ema, the teacher's) forward with BN on the running
    statistics, which the teacher shares with the student."""
    def eval_step(state: TrainState, batch: dict[str, Tensor]):
        net = state.teacher if (use_ema and state.teacher is not None) \
            else state.model
        net.eval()
        dev = next(net.parameters()).device
        with torch.no_grad(), autocast(cfg, dev):
            out = net(*model_inputs(batch))
        return {"rot": out["rot"].float(), "trans": out["trans"].float()}

    return eval_step
