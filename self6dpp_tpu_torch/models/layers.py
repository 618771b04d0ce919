"""Shared layers (port of self6dpp_tpu/models/layers.py). Modules take and
return NCHW tensors; module names follow the reference torch checkpoints."""

from __future__ import annotations

import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn

from ..parallel.dist import global_sum, world_size


def get_act(name: str) -> nn.Module:
    name = name.lower()
    if name == "relu":
        return nn.ReLU()
    if name in ("lrelu", "leakyrelu", "leaky_relu"):
        return nn.LeakyReLU(0.1)
    if name == "gelu":
        return nn.GELU(approximate="none")      # exact erf form
    if name in ("silu", "swish"):
        return nn.SiLU()
    if name == "mish":
        return nn.Mish()
    if name == "sigmoid":
        return nn.Sigmoid()
    if name in ("none", "identity"):
        return nn.Identity()
    raise ValueError(f"unknown act: {name}")


def gn_groups(num_gn_groups: int, channels: int) -> int:
    """The JAX package's group count: at most num_gn_groups, lowered until
    it divides the channels."""
    groups = min(num_gn_groups, channels)
    while channels % groups:
        groups -= 1
    return groups


class FlaxBatchNorm2d(nn.BatchNorm2d):
    """BatchNorm2d whose training mode is Flax's nn.BatchNorm(momentum=m),
    as the JAX package trains: batch statistics in float32 (float64 for a
    float64 input) with the variance as E[x²] - E[x]² clipped at 0, x
    normalised with them, and the running statistics updated in place as
    m r + (1 - m) s with the biased variance (torch's BatchNorm2d takes the
    unbiased one, n/(n-1) away: 1 + 6.5e-4 at batch 24 and stride 32).
    flax_momentum is Flax's m: 0.9 for GDRN and FlowNetS, 0.97 (eps 1e-3)
    for YOLOv4. Eval mode is torch's. Same state_dict as nn.BatchNorm2d.
    Under data parallel (parallel/dist.py) the statistics are the global
    batch's: x and x² summed over the ranks, differentiably."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 flax_momentum: float = 0.9):
        super().__init__(num_features, eps=eps)
        self.flax_momentum = flax_momentum

    def forward(self, x: Tensor) -> Tensor:
        if not self.training:
            return super().forward(x)
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if world_size() > 1:
            # the global batch's statistics, as Flax computes them under
            # jit on a data mesh: sums of x and x² over every rank
            n = xf.numel() // xf.shape[1] * world_size()
            sums = global_sum(torch.stack([xf.sum((0, 2, 3)),
                                           (xf * xf).sum((0, 2, 3))]))
            mean, ex2 = sums[0] / n, sums[1] / n
        else:
            mean = xf.mean((0, 2, 3))
            ex2 = (xf * xf).mean((0, 2, 3))
        var = (ex2 - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.flax_momentum
            self.running_mean.mul_(m).add_(mean.detach(), alpha=1.0 - m)
            self.running_var.mul_(m).add_(var.detach(), alpha=1.0 - m)
            self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] \
            + self.bias[:, None, None]
        return y.to(x.dtype)


def Norm(kind: str, channels: int, num_gn_groups: int = 32) -> nn.Module:
    """GroupNorm (eps 1e-5, as torch and the JAX package set it) or
    BatchNorm (eps 1e-5, trained as Flax trains it: FlaxBatchNorm2d)."""
    if kind == "GN":
        return nn.GroupNorm(gn_groups(num_gn_groups, channels), channels,
                            eps=1e-5)
    if kind == "BN":
        return FlaxBatchNorm2d(channels, eps=1e-5)
    if kind in ("none", ""):
        return nn.Identity()
    raise ValueError(f"unknown norm: {kind}")


class ConvNormAct(nn.Module):
    """conv (no bias, 'same' padding at stride 1) -> norm -> act; the
    reference ConvModule with children `conv` and `gn`."""

    def __init__(self, cin: int, cout: int, kernel_size: int = 3,
                 norm: str = "GN", num_gn_groups: int = 32, act: str = "gelu"):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel_size, 1, kernel_size // 2,
                              bias=False)
        self.gn = Norm(norm, cout, num_gn_groups)
        self.act = get_act(act)

    def forward(self, x: Tensor) -> Tensor:
        return self.act(self.gn(self.conv(x)))


class Upsample2x(nn.Module):
    """2x spatial upsample: bilinear with align_corners=True (torch
    UpsamplingBilinear2d, as the reference geo head) or nearest."""

    def __init__(self, method: str = "bilinear"):
        super().__init__()
        if method not in ("bilinear", "nearest"):
            raise ValueError(f"unknown upsample: {method}")
        self.method = method

    def forward(self, x: Tensor) -> Tensor:
        if self.method == "nearest":
            return Fnn.interpolate(x, scale_factor=2, mode="nearest")
        return upsample2x_align_corners(x)


def upsample2x_align_corners(x: Tensor) -> Tensor:
    """Bilinear 2x with align_corners=True, written as the JAX package's
    _resize_align_corners (two gathers and lerps), so that both round
    alike."""
    n, c, h, w = x.shape
    ys = torch.linspace(0.0, h - 1.0, 2 * h, device=x.device)
    xs = torch.linspace(0.0, w - 1.0, 2 * w, device=x.device)
    y0 = ys.floor().long().clamp(0, h - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    x0 = xs.floor().long().clamp(0, w - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    wy = (ys - y0).to(x.dtype)[None, None, :, None]
    wx = (xs - x0).to(x.dtype)[None, None, None, :]
    top = x[:, :, y0][:, :, :, x0] * (1 - wx) + x[:, :, y0][:, :, :, x1] * wx
    bot = x[:, :, y1][:, :, :, x0] * (1 - wx) + x[:, :, y1][:, :, :, x1] * wx
    return top * (1 - wy) + bot * wy


def ConvTranspose2x(cin: int, cout: int, kernel_size: int = 3) -> nn.Module:
    """Exactly-2x transposed conv of the 'deconv' up-blocks: torch
    ConvTranspose2d(k=3, stride 2, padding 1, output_padding 1)."""
    if kernel_size != 3:
        raise ValueError(f"deconv kernel {kernel_size}: only 3 is ported")
    return nn.ConvTranspose2d(cin, cout, 3, 2, padding=1, output_padding=1,
                              bias=False)
