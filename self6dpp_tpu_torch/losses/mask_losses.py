"""Mask losses (port of self6dpp_tpu/losses/mask_losses.py:
weighted_ex_loss_probs, get_mask_prob)."""

from __future__ import annotations

import torch
from torch import Tensor


def weighted_ex_loss_probs(probs: Tensor, target: Tensor,
                           weight: Tensor | None = None) -> Tensor:
    """Integral-object-mining EX loss on probabilities: positive pixels
    (target > 0) -target*log(p), negative ones -log(1-p), each averaged over
    its own pixel count, then summed."""
    probs = probs.clamp(1e-7, 1 - 1e-7)
    pos = (target > 0).to(probs.dtype)
    neg = (target == 0).to(probs.dtype)
    w = 1.0 if weight is None else weight
    pos_loss = -target * torch.log(probs) * w * pos
    neg_loss = -torch.log(1 - probs + 1e-8) * w * neg
    num_pos = pos.sum().clamp_min(1.0)
    num_neg = neg.sum().clamp_min(1.0)
    return pos_loss.sum() / num_pos + neg_loss.sum() / num_neg


def get_mask_prob(mask_logits: Tensor, loss_type: str = "BCE") -> Tensor:
    """Logits (..., C) -> probability map (..., 1), as each loss type trains
    the head."""
    if loss_type in ("BCE", "RW_BCE", "dice"):
        return torch.sigmoid(mask_logits[..., :1])
    if loss_type == "L1":
        return mask_logits[..., :1]
    if loss_type == "CE":
        return torch.softmax(mask_logits, dim=-1)[..., 1:2]
    raise ValueError(f"unknown mask loss: {loss_type}")
