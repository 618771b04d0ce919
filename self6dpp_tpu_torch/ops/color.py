"""Differentiable colour-space conversion for the stage-II LAB loss (port of
self6dpp_tpu/ops/color.py: _lab_channels, lab_loss). NHWC, values in [0,1].
lab_loss is the plain value of kernel B3 (ops/lab_cuda.py); autograd of it
is the "direct" LAB mode."""

from __future__ import annotations

import torch
from torch import Tensor

from ..parallel.dist import batch_denom

# sRGB D65
RGB2XYZ = ((0.412453, 0.357580, 0.180423),
           (0.212671, 0.715160, 0.072169),
           (0.019334, 0.119193, 0.950227))
XYZ_REF = (0.950456, 1.0, 1.088754)
SRGB_T = 0.04045        # sRGB gamma threshold
FT = 0.008856           # f(t): cube root above, linear below


def _lab_channels(rgb: Tensor, eps: float = 1e-8) -> tuple[Tensor, Tensor, Tensor]:
    """(..., 3) RGB -> (L, a, b), each (...): sRGB linearisation, XYZ,
    f(t) (cube root above 0.008856, linear below), Lab."""
    r, g, b = rgb.unbind(-1)

    def lin(c):
        return torch.where(c > SRGB_T, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)

    rl, gl, bl = lin(r), lin(g), lin(b)
    M = RGB2XYZ
    x = (M[0][0] * rl + M[0][1] * gl + M[0][2] * bl) / XYZ_REF[0]
    y = (M[1][0] * rl + M[1][1] * gl + M[1][2] * bl) / XYZ_REF[1]
    z = (M[2][0] * rl + M[2][1] * gl + M[2][2] * bl) / XYZ_REF[2]

    def f(c):
        return torch.where(c > FT, c.clamp_min(eps) ** (1.0 / 3.0),
                           7.787 * c + 16.0 / 116.0)

    fx, fy, fz = f(x), f(y), f(z)
    return 116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz)


def lab_loss(pred_rgb: Tensor, gt_rgb: Tensor, mask: Tensor | None = None,
             no_l: bool = True) -> Tensor:
    """L1 on the (a, b) channels [+ L], mask-averaged over the channels."""
    Lp, ap, bp = _lab_channels(pred_rgb)
    Lg, ag, bg = _lab_channels(gt_rgb)
    diff = (ap - ag).abs() + (bp - bg).abs()
    n_ch = 2
    if not no_l:
        diff = diff + (Lp - Lg).abs()
        n_ch = 3
    if mask is not None:
        return (diff * mask).sum() / (batch_denom(mask.sum()) * n_ch)
    return diff.mean() / n_ch
