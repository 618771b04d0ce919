"""Differentiable colour-space conversions (port of self6dpp_tpu/ops/
color.py: rgb_to_linear, rgb_to_xyz, rgb_to_lab, rgb_to_gray, rgb_to_hsv,
rgb_to_yuv, rgb_to_luv, _lab_channels, lab_loss, lab_loss_surrogate).
(..., 3) tensors, values in [0,1]. lab_loss is the plain value of kernel
B3 (ops/lab_cuda.py); autograd of it is the "direct" LAB mode, and
lab_loss_surrogate the "surrogate" one."""

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


def rgb_to_linear(rgb: Tensor) -> Tensor:
    """sRGB -> linear RGB."""
    return torch.where(rgb > SRGB_T, ((rgb + 0.055) / 1.055) ** 2.4,
                       rgb / 12.92)


def rgb_to_xyz(rgb: Tensor) -> Tensor:
    """sRGB -> CIE XYZ (D65): the linearised colour times RGB2XYZ."""
    m = torch.tensor(RGB2XYZ, dtype=rgb.dtype, device=rgb.device)
    return torch.einsum("...c,dc->...d", rgb_to_linear(rgb), m)


def rgb_to_lab(rgb: Tensor, eps: float = 1e-8) -> Tensor:
    """sRGB -> CIELAB (L in [0, 100], a and b about [-128, 127])."""
    return torch.stack(_lab_channels(rgb, eps), dim=-1)


def rgb_to_gray(rgb: Tensor) -> Tensor:
    """(..., 3) -> (..., 1) luma, 0.299 R + 0.587 G + 0.114 B."""
    return (0.299 * rgb[..., 0] + 0.587 * rgb[..., 1]
            + 0.114 * rgb[..., 2])[..., None]


def rgb_to_hsv(rgb: Tensor, eps: float = 1e-8) -> Tensor:
    """(..., 3) -> (h, s, v), each in [0, 1]; h and s 0 at grey pixels."""
    r, g, b = rgb.unbind(-1)
    mx = rgb.amax(-1)
    mn = rgb.amin(-1)
    d = mx - mn
    h = torch.where(
        mx == r, torch.remainder((g - b) / (d + eps), 6.0),
        torch.where(mx == g, (b - r) / (d + eps) + 2.0,
                    (r - g) / (d + eps) + 4.0))
    h = torch.where(d < eps, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx > eps, d / (mx + eps), torch.zeros_like(mx))
    return torch.stack([h, s, mx], dim=-1)


YUV = ((0.299, 0.587, 0.114),
       (-0.147, -0.289, 0.436),
       (0.615, -0.515, -0.100))


def rgb_to_yuv(rgb: Tensor) -> Tensor:
    """(..., 3) RGB -> YUV (kornia's weights)."""
    m = torch.tensor(YUV, dtype=rgb.dtype, device=rgb.device)
    return torch.einsum("ij,...j->...i", m, rgb)


def rgb_to_luv(rgb: Tensor, eps: float = 1e-12) -> Tensor:
    """(..., 3) sRGB -> CIE LUV as the JAX package computes it: XYZ of the
    linearised colour (rgb_to_xyz linearises once more, as the JAX
    function does), L* and the u'v'-based u*, v*."""
    x, y, z = rgb_to_xyz(rgb_to_linear(rgb)).unbind(-1)
    L = torch.where(y > FT, 116.0 * y.clamp_min(eps) ** (1.0 / 3.0) - 16.0,
                    903.3 * y)
    d = x + 15.0 * y + 3.0 * z
    u_p = 4.0 * x / d.clamp_min(eps)
    v_p = 9.0 * y / d.clamp_min(eps)
    xr, yr, zr = XYZ_REF
    dr = xr + 15.0 * yr + 3.0 * zr
    u = 13.0 * L * (u_p - 4.0 * xr / dr)
    v = 13.0 * L * (v_p - 9.0 * yr / dr)
    return torch.stack([L, u, v], dim=-1)


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


def lab_loss_surrogate(pred_rgb: Tensor, gt_rgb: Tensor,
                       mask: Tensor | None = None, no_l: bool = True
                       ) -> Tensor:
    """lab_loss's value with its gradient: g = d(lab_loss)/d(pred) at the
    detached prediction, and the term re-enters the graph as
    value + sum(g * pred) - sum(g * pred).detach(). The gradient is exact,
    since g is taken at the current prediction."""
    p = pred_rgb.detach().requires_grad_(True)
    with torch.enable_grad():
        val = lab_loss(p, gt_rgb.detach(), mask=mask, no_l=no_l)
        g, = torch.autograd.grad(val, p)
    lin = (g * pred_rgb).sum()
    return val.detach() + (lin - lin.detach())
