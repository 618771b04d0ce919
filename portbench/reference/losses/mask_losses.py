"""Mask losses (port of self6dpp_tpu/losses/mask_losses.py:
weighted_ex_loss_probs, soft_dice_loss, mask_loss, get_mask_prob)."""

from __future__ import annotations

import torch
from torch import Tensor

from ..parallel.dist import batch_denom

from .common import sigmoid_bce, softmax_ce


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
    num_pos = batch_denom(pos.sum())
    num_neg = batch_denom(neg.sum())
    return pos_loss.sum() / num_pos + neg_loss.sum() / num_neg


def soft_dice_loss(probs: Tensor, labels: Tensor, smooth: float = 0.0,
                   eps: float = 1e-7, reduction: str = "mean") -> Tensor:
    b = probs.shape[0]
    m1, m2 = probs.reshape(b, -1), labels.reshape(b, -1)
    inter = (m1 * m2).sum(1)
    score = 2.0 * (inter + smooth) / (m1.sum(1) + m2.sum(1) + smooth + eps)
    loss = 1.0 - score
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def mask_loss(out_mask: Tensor, gt_mask: Tensor,
              loss_type: str = "BCE") -> Tensor:
    """The stage-I mask loss of each mask_loss_type. out_mask (B,H,W,C)
    logits (C = 1 but for CE); gt_mask (B,H,W)."""
    if loss_type == "L1":
        return (out_mask[..., 0] - gt_mask).abs().mean()
    if loss_type == "BCE":
        return sigmoid_bce(out_mask[..., 0], gt_mask).mean()
    if loss_type == "RW_BCE":
        return weighted_ex_loss_probs(torch.sigmoid(out_mask[..., 0]), gt_mask)
    if loss_type == "dice":
        return soft_dice_loss(torch.sigmoid(out_mask[..., 0]), gt_mask,
                              eps=0.002)
    if loss_type == "CE":
        return softmax_ce(out_mask, gt_mask.long(), dim=-1).mean()
    raise ValueError(f"unknown mask loss: {loss_type}")


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
