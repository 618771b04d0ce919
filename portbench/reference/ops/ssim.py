"""SSIM and MS-SSIM, differentiable, on NHWC images (port of
self6dpp_tpu/ops/ssim.py): gaussian window 11 with sigma 1.5, K = (0.01,
0.03), a data range of 1, the standard five MS-SSIM weights, valid
padding.

The separable blur is a convolution along H, then along W, of each channel
on its own. The stage-II loss reads ms_ssim(img_m, ren_m).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fnn
from torch import Tensor

from ..parallel.dist import global_mean

_WIN_SIZE = 11
_SIGMA = 1.5
_C1 = 0.01 ** 2                   # (K1 * data range)², the range being 1
_C2 = 0.03 ** 2
_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _gaussian_kernel() -> np.ndarray:
    x = np.arange(_WIN_SIZE, dtype=np.float64) - (_WIN_SIZE - 1) / 2.0
    g = np.exp(-(x ** 2) / (2 * _SIGMA ** 2))
    return (g / g.sum()).astype(np.float32)


_WIN = _gaussian_kernel()


def _blur(x: Tensor) -> Tensor:
    """Separable gaussian filter, valid padding. x (B, C, H, W)."""
    b, c, h, w = x.shape
    k = torch.as_tensor(_WIN, dtype=x.dtype, device=x.device)
    y = Fnn.conv2d(x.reshape(b * c, 1, h, w), k.view(1, 1, -1, 1))
    y = Fnn.conv2d(y, k.view(1, 1, 1, -1))
    return y.reshape(b, c, y.shape[-2], y.shape[-1])


def _ssim_cs(img1: Tensor, img2: Tensor) -> tuple[Tensor, Tensor]:
    """The mean SSIM and the mean contrast-structure term of (B, C, H, W)
    images."""
    mu1 = _blur(img1)
    mu2 = _blur(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1) - mu1_sq
    s2 = _blur(img2 * img2) - mu2_sq
    s12 = _blur(img1 * img2) - mu12

    cs = (2 * s12 + _C2) / (s1 + s2 + _C2)
    ss = ((2 * mu12 + _C1) / (mu1_sq + mu2_sq + _C1)) * cs
    return global_mean(ss.mean()), global_mean(cs.mean())


def ssim(img1: Tensor, img2: Tensor, return_cs: bool = False):
    """SSIM over (B, H, W, C): the mean SSIM (and the mean contrast-structure
    term when return_cs)."""
    ss, cs = _ssim_cs(img1.permute(0, 3, 1, 2), img2.permute(0, 3, 1, 2))
    if return_cs:
        return ss, cs
    return ss


def _pool2(x: Tensor) -> Tensor:
    """2x2 average with valid padding: a trailing odd row or column drops."""
    h, w = x.shape[-2] // 2 * 2, x.shape[-1] // 2 * 2
    x = x[..., :h, :w]
    x = x[..., :, 0::2] + x[..., :, 1::2]
    return (x[..., 0::2, :] + x[..., 1::2, :]) * 0.25


def ms_ssim(img1: Tensor, img2: Tensor) -> Tensor:
    """Multi-scale SSIM of (B, H, W, C) images, 2x average pooling between
    levels. Levels whose image would be smaller than the window are dropped
    and the remaining weights renormalised (5 levels at 256², 3 at 64²)."""
    min_hw = min(img1.shape[1], img1.shape[2])
    levels = 1
    while levels < len(_MS_WEIGHTS) and (min_hw >> levels) >= _WIN_SIZE:
        levels += 1
    weights = _MS_WEIGHTS[:levels]
    if levels < len(_MS_WEIGHTS):
        weights = tuple(x / sum(weights) for x in weights)
    img1 = img1.permute(0, 3, 1, 2)
    img2 = img2.permute(0, 3, 1, 2)

    zero = torch.zeros((), dtype=img1.dtype, device=img1.device)
    vals = []           # maximum splits the gradient at 0 as JAX's does
    for i in range(levels):
        ss, cs = _ssim_cs(img1, img2)
        if i == levels - 1:
            vals.append(torch.maximum(ss, zero))
        else:
            vals.append(torch.maximum(cs, zero))
            img1 = _pool2(img1)
            img2 = _pool2(img2)
    w = torch.tensor(weights, dtype=vals[0].dtype, device=vals[0].device)
    return torch.prod(torch.stack(vals) ** w)


def ssim_loss(img1: Tensor, img2: Tensor) -> Tensor:
    return 1.0 - ssim(img1, img2)


def ms_ssim_loss(img1: Tensor, img2: Tensor) -> Tensor:
    return 1.0 - ms_ssim(img1, img2)
