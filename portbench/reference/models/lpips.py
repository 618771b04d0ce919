"""LPIPS perceptual distance, AlexNet variant (port of
self6dpp_tpu/models/lpips.py).

Five AlexNet conv stages -> each feature map unit-normalised over channels
-> squared difference -> a non-negative linear head per stage -> spatial
mean -> sum over stages. Images are (B, H, W, 3) in [0, 1], as in the JAX
package; the trunk runs in NCHW. The stage-II loss runs it in float32
whatever the step's compute dtype.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn

from .. import resolve_device

# ImageNet normalisation of PerceptualSimilarity's scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)
# (out channels, kernel, stride, padding) of conv1..conv5; max pools
# (3, stride 2, no padding) after conv1 and conv2
_CONVS = ((64, 11, 4, 2), (192, 5, 1, 2), (384, 3, 1, 1), (256, 3, 1, 1),
          (256, 3, 1, 1))
# flax's truncated normal: within 2 std, rescaled to the asked variance
_TRUNC_STD = 0.87962566103423978


def unit_channels(a: Tensor) -> Tensor:
    """a / max(|a|, 1e-10) over the channels (dim 1). At an all-zero
    vector its gradient is finite (1e10 scale), where JAX's is NaN."""
    return a / torch.linalg.vector_norm(a, dim=1, keepdim=True).clamp_min(1e-10)


class AlexNetFeatures(nn.Module):
    """AlexNet conv trunk; returns relu1..relu5 (NCHW)."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, (cout, k, s, p) in enumerate(_CONVS, start=1):
            setattr(self, f"conv{i}", nn.Conv2d(cin, cout, k, s, p))
            cin = cout

    def forward(self, x: Tensor) -> list[Tensor]:
        feats = []
        for i in range(1, 6):
            x = torch.relu(getattr(self, f"conv{i}")(x))
            feats.append(x)
            if i <= 2:
                x = Fnn.max_pool2d(x, 3, 2)
        return feats


class LPIPS(nn.Module):
    """forward(img1, img2) -> (B,) LPIPS distances of two (B, H, W, 3)
    images in [0, 1] (rescaled to [-1, 1], then ImageNet-normalised)."""

    def __init__(self):
        super().__init__()
        self.alex = AlexNetFeatures()
        for i, (cout, *_) in enumerate(_CONVS):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.zeros(cout)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1),
                             persistent=False)
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1),
                             persistent=False)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Flax's initialisers, drawn in float32 on the CPU: LeCun normal
        (truncated) conv kernels, zero biases, linear heads uniform in
        [0, 0.1)."""
        for i in range(1, 6):
            conv = getattr(self.alex, f"conv{i}")
            s = math.prod(conv.weight.shape[1:]) ** -0.5 / _TRUNC_STD
            conv.weight.copy_(nn.init.trunc_normal_(
                torch.empty(conv.weight.shape), 0.0, s, -2 * s, 2 * s,
                generator=generator))
            conv.bias.zero_()
        for i in range(5):
            w = getattr(self, f"lin{i}")
            w.copy_(torch.rand(w.shape, generator=generator) * 0.1)

    def _prep(self, x: Tensor) -> Tensor:
        return (2.0 * x.permute(0, 3, 1, 2) - 1.0 - self.shift) / self.scale

    def forward(self, img1: Tensor, img2: Tensor) -> Tensor:
        f1 = self.alex(self._prep(img1))
        f2 = self.alex(self._prep(img2))
        total = 0.0
        for i, (a, b) in enumerate(zip(f1, f2)):
            a, b = unit_channels(a), unit_channels(b)
            w = getattr(self, f"lin{i}").abs()
            d = ((a - b) ** 2 * w[:, None, None]).sum(1)
            total = total + d.mean((1, 2))
        return total


def build_lpips(device=None, seed: int = 1) -> LPIPS:
    """A frozen LPIPS (eval mode, no parameter gradients) with weights drawn
    from `seed`, on `device` (CUDA by default)."""
    model = LPIPS()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(resolve_device(device)).eval().requires_grad_(False)


def load_lpips_params(path: str) -> dict[str, Tensor] | None:
    """A state_dict for LPIPS from an .npz of flat 'name: array' pairs in
    the reference's layout (conv{i}.weight OIHW, conv{i}.bias, lin{i}.weight
    of any shape holding C values), the file the JAX package's
    load_lpips_params reads; None when the file is missing."""
    if not os.path.exists(path):
        return None
    raw = dict(np.load(path))
    sd = {}
    for i in range(1, 6):
        sd[f"alex.conv{i}.weight"] = torch.from_numpy(raw[f"conv{i}.weight"])
        sd[f"alex.conv{i}.bias"] = torch.from_numpy(raw[f"conv{i}.bias"])
    for i in range(5):
        sd[f"lin{i}"] = torch.from_numpy(raw[f"lin{i}.weight"].reshape(-1))
    return sd
