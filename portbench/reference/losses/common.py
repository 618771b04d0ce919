"""Elementary loss helpers (port of self6dpp_tpu/losses/common.py)."""

from __future__ import annotations

import torch
from torch import Tensor


def l1(pred: Tensor, gt: Tensor) -> Tensor:
    return (pred - gt).abs()


def l2(pred: Tensor, gt: Tensor, eps: float = 1e-8) -> Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt(((pred - gt) ** 2).sum(-1) + eps)


def mse(pred: Tensor, gt: Tensor) -> Tensor:
    d = pred - gt
    return d * d


def smooth_l1(pred: Tensor, gt: Tensor, beta: float = 1.0) -> Tensor:
    a = (pred - gt).abs()
    return torch.where(a < beta, 0.5 * a * a / beta, a - 0.5 * beta)


def pointwise_loss(name: str, pred: Tensor, gt: Tensor,
                   beta: float = 1.0) -> Tensor:
    name = name.lower()
    if name == "l1":
        return l1(pred, gt)
    if name in ("mse", "l2sq"):
        return mse(pred, gt)
    if name == "smooth_l1":
        return smooth_l1(pred, gt, beta)
    raise ValueError(f"unknown pointwise loss: {name}")


def sigmoid_bce(logits: Tensor, targets: Tensor) -> Tensor:
    """BCE with logits, in the JAX package's stable form."""
    return (logits.clamp_min(0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def softmax_ce(logits: Tensor, labels: Tensor, dim: int = -1) -> Tensor:
    """Cross entropy with integer labels along `dim`."""
    logp = torch.log_softmax(logits, dim=dim)
    return -torch.gather(logp, dim, labels.long().unsqueeze(dim)).squeeze(dim)
