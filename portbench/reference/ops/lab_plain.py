"""LAB loss value and image gradient in one launch: the CUDA kernel
csrc/lab_value_grad.cu (kernel B3) and its plain PyTorch version.

The kernel replaces the TPU kernel B3, self6dpp_tpu/ops/lab_pallas.py::
_kernel (lab_value_grad_pallas -> pallas_call). Both compute, for pred and
gt (B, S, S, 3) NHWC float32 and a mask (B, S, S):
  the masked L1 on Lab a, b (+ L when no_l is False) and its analytic
  gradient d/d(pred) through the sRGB linearisation, XYZ, f(t) (cube root
  branch) and Lab, both divided by max(sum(mask), 1) * n_ch,
the value of ops/color.py::lab_loss and its gradient. Two entries, each
with its plain twin:
  lab_value_grad(_plain)         -> (value, gradient), normalised, as the
                                    JAX function returns them;
  lab_value_grad_scaled(_plain)  -> (value, g_raw, scale): the gradient
                                    before normalisation and the 0-d scale
                                    weight / (max(sum(mask), 1) * n_ch).
The stage-II step takes the scaled entry and adds g_raw * scale into the
render's cotangent in one pass (losses/self_loss.py::InjectGrad), where the
JAX package injects lab_lw * g.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .color import FT, RGB2XYZ, SRGB_T, XYZ_REF

_EPS = 1e-8
_PIXELS_PER_BLOCK = 1024    # csrc/lab_value_grad.cu: 8 warps x 128 pixels


def _split_lab_grad(p: Tensor, g: Tensor, no_l: bool) -> tuple[Tensor, Tensor]:
    """Per-pixel |Lab difference| (B,S,S) and its gradient with respect to
    p (B,S,S,3), before masking. The analytic chain of lab_pallas._kernel."""
    def lin(c):
        return torch.where(c > SRGB_T, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)

    def dlin(c):
        return torch.where(c > SRGB_T, (2.4 / 1.055) * ((c + 0.055) / 1.055) ** 1.4,
                           torch.full_like(c, 1.0 / 12.92))

    def cbrt(c):
        return c.clamp_min(_EPS) ** (1.0 / 3.0)

    def f(c):
        return torch.where(c > FT, cbrt(c), 7.787 * c + 16.0 / 116.0)

    def df(c):
        cb = cbrt(c)
        dcbrt = torch.where(c > _EPS, 1.0 / (3.0 * cb * cb), torch.zeros_like(c))
        return torch.where(c > FT, dcbrt, torch.full_like(c, 7.787))

    def chans(rgb):
        rl, gl, bl = (lin(c) for c in rgb.unbind(-1))
        M = RGB2XYZ
        xyz = [(M[i][0] * rl + M[i][1] * gl + M[i][2] * bl) / XYZ_REF[i]
               for i in range(3)]
        fx, fy, fz = (f(c) for c in xyz)
        return xyz, (116.0 * fy - 16.0, 500.0 * (fx - fy), 200.0 * (fy - fz))

    (xp, yp, zp), (Lp, ap, bp) = chans(p)
    _, (Lg, ag, bg) = chans(g)
    diff = (ap - ag).abs() + (bp - bg).abs()
    sa, sb = torch.sign(ap - ag), torch.sign(bp - bg)
    dfx = 500.0 * sa
    dfy = -500.0 * sa + 200.0 * sb
    dfz = -200.0 * sb
    if not no_l:
        diff = diff + (Lp - Lg).abs()
        dfy = dfy + 116.0 * torch.sign(Lp - Lg)
    dx = dfx * df(xp) / XYZ_REF[0]
    dy = dfy * df(yp) / XYZ_REF[1]
    dz = dfz * df(zp) / XYZ_REF[2]
    M = RGB2XYZ
    grad = torch.stack([(dx * M[0][j] + dy * M[1][j] + dz * M[2][j])
                        * dlin(p[..., j]) for j in range(3)], dim=-1)
    return diff, grad


def lab_value_grad_scaled_plain(pred: Tensor, gt: Tensor, mask: Tensor,
                                no_l: bool = True, weight: float = 1.0
                                ) -> tuple[Tensor, Tensor, Tensor]:
    """Plain PyTorch version of kernel B3: (value, g_raw, scale), where g_raw
    is the masked gradient before normalisation and scale = weight / (max(
    sum(mask), 1) * n_ch), so that g_raw * scale is weight * d value / d pred."""
    diff, grad = _split_lab_grad(pred, gt, no_l)
    n_ch = 2 if no_l else 3
    norm = 1.0 / (mask.sum().clamp_min(1.0) * n_ch)
    return (diff * mask).sum() * norm, grad * mask[..., None], weight * norm


def lab_value_grad_plain(pred: Tensor, gt: Tensor, mask: Tensor,
                         no_l: bool = True) -> tuple[Tensor, Tensor]:
    """Plain PyTorch version of lab_value_grad: (value, d value / d pred)."""
    value, g_raw, scale = lab_value_grad_scaled_plain(pred, gt, mask, no_l)
    return value, g_raw * scale
