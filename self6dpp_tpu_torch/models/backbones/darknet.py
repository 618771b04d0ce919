"""Darknet-53 backbone (port of self6dpp_tpu/models/backbones/darknet.py),
NCHW: a conv-BN-LeakyReLU(0.1) stem at base_width, then five stages, each
a stride-2 conv unit doubling the width and `depths[s]` residual blocks (a
1x1 half-width squeeze and a 3x3 expand, added to the input). BN trains
as Flax trains it (FlaxBatchNorm2d).

Module names: `stem`, `layer{s}.0` (the stage's downsample unit),
`layer{s}.{j}` (its residual blocks, `cv1` and `cv2`); every unit holds
`conv` and `bn`.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch.nn.functional as Fnn
from torch import Tensor, nn

from ..layers import FlaxBatchNorm2d


class ConvUnit(nn.Module):
    """conv (no bias, padding k//2) -> BN -> LeakyReLU(0.1)."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, kernel // 2,
                              bias=False)
        self.bn = FlaxBatchNorm2d(cout, eps=1e-5)

    def forward(self, x: Tensor) -> Tensor:
        return Fnn.leaky_relu(self.bn(self.conv(x)), 0.1)


class ResBlock(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.cv1 = ConvUnit(channels, channels // 2, 1)
        self.cv2 = ConvUnit(channels // 2, channels, 3)

    def forward(self, x: Tensor) -> Tensor:
        return x + self.cv2(self.cv1(x))


class DarknetBackbone(nn.Module):
    """Returns the feature of each stage in out_indices (1..5 -> strides 2,
    4, 8, 16, 32; GDRN shifts the config's 1..4 by one, as the JAX package
    does), one tensor when one is asked for."""

    def __init__(self, in_channels: int = 3,
                 depths: Sequence[int] = (1, 2, 8, 8, 4),
                 base_width: int = 32, out_indices: Sequence[int] = (5,)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.depths = tuple(depths)
        self.stem = ConvUnit(in_channels, base_width, 3)
        c = base_width
        self.feature_channels = []
        for s, d in enumerate(self.depths, start=1):
            c *= 2
            setattr(self, f"layer{s}", nn.Sequential(
                ConvUnit(c // 2, c, 3, 2), *(ResBlock(c) for _ in range(d))))
            if s in self.out_indices:
                self.feature_channels.append(c)

    def forward(self, x: Tensor):
        x = self.stem(x)
        outs = []
        for s in range(1, len(self.depths) + 1):
            x = getattr(self, f"layer{s}")(x)
            if s in self.out_indices:
                outs.append(x)
        return outs if len(outs) > 1 else outs[0]
