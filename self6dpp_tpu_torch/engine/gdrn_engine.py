"""GDRN construction and inputs (port of self6dpp_tpu/engine/gdrn_engine.py:
BATCH_MODEL_KEYS, model_inputs, build_gdrn, init_state)."""

from __future__ import annotations

import math

import torch
from torch import Tensor, nn

from .. import resolve_device
from ..config import Config
from ..models.gdrn import GDRN
from .optim import build_optimizer
from .train_state import TrainState, create_train_state

BATCH_MODEL_KEYS = (
    "roi_img", "roi_cls", "roi_cam", "roi_center", "roi_wh", "roi_extent",
    "resize_ratio", "roi_coord_2d",
)
# flax's truncated normal draws within 2 std of a unit normal and rescales
# by the truncated distribution's std so the variance is the asked one
_TRUNC_STD = 0.87962566103423978


def model_inputs(batch: dict[str, Tensor]) -> tuple:
    return tuple(batch[k] for k in BATCH_MODEL_KEYS)


@torch.no_grad()
def init_weights_(model: GDRN, generator: torch.Generator) -> GDRN:
    """Draw the weights as the JAX package's initialisers do: LeCun normal
    (truncated) for convs, transposed convs and dense layers, zero biases;
    N(0, 0.01) for the geo head's out layer and the pose outputs, N(0, 1e-3)
    for the PnP convs and hidden dense layers; norms at scale 1, bias 0 and
    BN statistics (0, 1). Drawn in float32 on the CPU, whatever the model's
    device."""
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
            if name == "geo_head_net.out_layer" or name in ("pnp_net.fc_r",
                                                            "pnp_net.fc_t"):
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


def init_state(cfg: Config, model: GDRN) -> TrainState:
    """Student, EMA teacher and Ranger over the student's parameters."""
    return create_train_state(model, build_optimizer(cfg.solver,
                                                     model.parameters()),
                              with_ema=cfg.solver.ema_decay > 0)
