"""Flow endpoint-error losses (port of self6dpp_tpu/losses/flow_loss.py:
_downscale, one_scale_epe, multiscale_epe; reference
core/deepim/losses/flow_loss.py)."""

from __future__ import annotations

import torch
from torch import Tensor

from ..parallel.dist import batch_denom


def _downscale(x: Tensor, factor: int) -> Tensor:
    """Average-pool (B, H, W, C) by an integer factor (windows that do not
    fit are dropped, as reduce_window's VALID padding drops them)."""
    if factor == 1:
        return x
    B, H, W, C = x.shape
    h, w = H // factor, W // factor
    x = x[:, :h * factor, :w * factor]
    return x.reshape(B, h, factor, w, factor, C).sum((2, 4)) \
        / float(factor * factor)


def one_scale_epe(pred_flow: Tensor, gt_flow: Tensor, valid: Tensor,
                  div_flow: float = 1.0) -> Tensor:
    """pred_flow (B, h, w, 2); gt_flow (B, H, W, 2) at full resolution;
    valid (B, H, W). The ground truth and its validity are average-pooled
    to the prediction's scale and the flow divided by the factor; the mean
    endpoint error over the pooled validity.

    Where pred_flow * div_flow - gt is exactly 0 the norm's gradient is 0
    here and NaN in the JAX package (jnp.linalg.norm's)."""
    H, h = gt_flow.shape[1], pred_flow.shape[1]
    factor = H // h
    gt = _downscale(gt_flow, factor) / factor
    v = _downscale(valid[..., None], factor)[..., 0]
    epe = torch.linalg.vector_norm(pred_flow * div_flow - gt, dim=-1)
    return (epe * v).sum() / batch_denom(v.sum())


def multiscale_epe(pred_flows: list[Tensor], gt_flow: Tensor, valid: Tensor,
                   weights: tuple[float, ...] = (0.005, 0.01, 0.02, 0.08, 0.32),
                   ) -> Tensor:
    """The weighted EPE of flow2 ... flow6 (FlowNet's training protocol)."""
    total = 0.0
    for w, pf in zip(weights, pred_flows):
        total = total + w * one_scale_epe(pf, gt_flow, valid)
    return total
