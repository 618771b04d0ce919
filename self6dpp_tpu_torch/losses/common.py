"""Elementary loss helpers (port of self6dpp_tpu/losses/common.py)."""

from __future__ import annotations

import torch
from torch import Tensor


def pointwise_loss(name: str, pred: Tensor, gt: Tensor,
                   beta: float = 1.0) -> Tensor:
    name = name.lower()
    d = pred - gt
    if name == "l1":
        return d.abs()
    if name in ("mse", "l2sq"):
        return d * d
    if name == "smooth_l1":
        a = d.abs()
        return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)
    raise ValueError(f"unknown pointwise loss: {name}")
