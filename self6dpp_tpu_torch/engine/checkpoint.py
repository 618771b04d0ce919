"""Weights as the JAX package's flat .npz (port of the npz bridge of
self6dpp_tpu/engine/checkpoint.py: save_params_npz, load_params_npz).

The file holds the JAX model's variables flattened to dotted keys
('params.backbone.conv1.kernel', 'batch_stats.…'), in the JAX layout;
convert.py maps them to and from the port's GDRN and DeepIM. The orbax
CheckpointManager is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .. import convert
from ..convert import _flatten
from ..models.deepim import DeepIM


def _to_flax(model: nn.Module) -> dict:
    if isinstance(model, DeepIM):
        return convert.state_dict_to_flax(model)
    return convert.gdrn_state_dict_to_flax(model)


def save_params_npz(path: str, model: nn.Module) -> None:
    """The model's (a GDRN's or a DeepIM's) variables in the JAX layout,
    as a flat .npz."""
    np.savez(path, **_flatten(_to_flax(model)))


def load_params_npz(path: str, model: nn.Module, strict: bool = True
                    ) -> nn.Module:
    """Load a flat .npz of JAX-layout variables into the model, in place.
    strict=False keeps the model's own value for every variable the file
    lacks (a partial init, e.g. backbone weights under a whole GDRN).
    Raises for an array of the file the model has no variable for, and
    for a shape that differs."""
    raw = dict(np.load(path))
    flat = _flatten(_to_flax(model))
    missing = sorted(set(flat) - set(raw))
    if strict and missing:
        raise KeyError(f"{path}: missing variables {missing[:8]}")
    unused = sorted(set(raw) - set(flat))
    if unused:
        raise KeyError(f"{path}: arrays the model has no variable for: "
                       f"{unused[:8]}")
    for k, v in raw.items():
        if v.shape != flat[k].shape:
            raise ValueError(f"{k}: file {v.shape} != model {flat[k].shape}")
        flat[k] = v
    tree: dict = {}
    for k, v in flat.items():
        *path_, leaf = k.split(".")
        node = tree
        for p in path_:
            node = node.setdefault(p, {})
        node[leaf] = v
    sd = convert.flax_to_state_dict(tree, model) if isinstance(model, DeepIM) \
        else convert.gdrn_flax_to_state_dict(tree, model)
    with torch.no_grad():
        model.load_state_dict(sd, strict=True)
    return model
