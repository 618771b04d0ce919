"""ResNet / ResNet-D / ResNeSt backbones (port of
self6dpp_tpu/models/backbones/resnet.py), NCHW, with the timm module names of
the reference checkpoints (conv1/bn1, layer{s}.{b}.conv{i}/bn{i},
downsample, and SplitAttn {conv, bn0, fc1, bn1, fc2} for ResNeSt).

Padding is torch's symmetric k//2 everywhere, as the JAX package pads
explicitly. '-d' variants use the deep 3-conv stem and average-pool
downsampling (a 2x2, stride-2 pool without padding, as the JAX package's
nn.avg_pool); ResNeSt-d moves the stride into a 3x3 average pool after the
split-attention conv (avd_last).
"""

from __future__ import annotations

from collections.abc import Sequence

import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn

from ..layers import FlaxBatchNorm2d

_STAGE_SPECS = {
    # 'micro': 1 basic block per stage at 1/8 width (the test architecture)
    "micro": ("basic", (1, 1, 1, 1)),
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet50d": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnest26d": ("splat", (2, 2, 2, 2)),
    "resnest50d": ("splat", (3, 4, 6, 3)),
}


def _bn(c: int) -> nn.BatchNorm2d:
    return FlaxBatchNorm2d(c, eps=1e-5)


def _downsample(cin: int, cout: int, stride: int, avg_down: bool) -> nn.Module:
    if avg_down:     # Sequential(pool | identity, conv, bn): timm avg-down
        pool = nn.AvgPool2d(2, 2) if stride != 1 else nn.Identity()
        return nn.Sequential(pool, nn.Conv2d(cin, cout, 1, bias=False),
                             _bn(cout))
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False), _bn(cout))


class BasicBlock(nn.Module):
    """Two 3x3 convs; dilation > 1 (the dilated-8s PVNet stages) pads and
    dilates both by it."""

    def __init__(self, cin: int, c: int, stride: int = 1, avg_down: bool = False,
                 dilation: int = 1):
        super().__init__()
        d = dilation
        self.conv1 = nn.Conv2d(cin, c, 3, stride, d, dilation=d, bias=False)
        self.bn1 = _bn(c)
        self.conv2 = nn.Conv2d(c, c, 3, 1, d, dilation=d, bias=False)
        self.bn2 = _bn(c)
        self.downsample = (_downsample(cin, c, stride, avg_down)
                           if cin != c or stride != 1 else None)

    def forward(self, x: Tensor) -> Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        y = Fnn.relu(self.bn1(self.conv1(x)))
        return Fnn.relu(self.bn2(self.conv2(y)) + idn)


class SplitAttn(nn.Module):
    """ResNeSt split-attention conv (radix 2, cardinality 1): the 3x3 conv
    gives radix*C channels (radix-major), their sum is pooled, squeezed
    through fc1/bn1/relu/fc2 (1x1 convs) and an r-softmax re-weights each
    radix branch."""

    def __init__(self, c: int, radix: int = 2, reduction: int = 4):
        super().__init__()
        inter = max(c * radix // reduction, 32)
        self.radix = radix
        self.conv = nn.Conv2d(c, c * radix, 3, 1, 1, groups=radix, bias=False)
        self.bn0 = _bn(c * radix)
        self.fc1 = nn.Conv2d(c, inter, 1)
        self.bn1 = _bn(inter)
        self.fc2 = nn.Conv2d(inter, c * radix, 1)

    def forward(self, x: Tensor) -> Tensor:
        x = Fnn.relu(self.bn0(self.conv(x)))
        b, rc, h, w = x.shape
        r, c = self.radix, rc // self.radix
        xs = x.reshape(b, r, c, h, w)
        gap = xs.sum(1).mean((2, 3), keepdim=True)
        a = Fnn.relu(self.bn1(self.fc1(gap)))
        a = self.fc2(a).reshape(b, r, c)
        a = torch.softmax(a, 1) if r > 1 else torch.sigmoid(a)
        return (xs * a.reshape(b, r, c, 1, 1)).sum(1)


class Bottleneck(nn.Module):
    """Bottleneck of width w (output 4w); with `splat` the ResNeSt block;
    dilation > 1 pads and dilates the 3x3 conv by it."""

    def __init__(self, cin: int, w: int, stride: int = 1, avg_down: bool = False,
                 splat: bool = False, dilation: int = 1):
        super().__init__()
        cout = w * 4
        self.conv1 = nn.Conv2d(cin, w, 1, bias=False)
        self.bn1 = _bn(w)
        if splat:
            self.conv2 = SplitAttn(w)
            self.avd_last = nn.AvgPool2d(3, stride, 1) if stride != 1 else None
        else:
            self.conv2 = nn.Conv2d(w, w, 3, stride, dilation,
                                   dilation=dilation, bias=False)
            self.bn2 = _bn(w)
        self.splat = splat
        self.conv3 = nn.Conv2d(w, cout, 1, bias=False)
        self.bn3 = _bn(cout)
        self.downsample = (_downsample(cin, cout, stride, avg_down)
                           if cin != cout or stride != 1 else None)

    def forward(self, x: Tensor) -> Tensor:
        idn = x if self.downsample is None else self.downsample(x)
        y = Fnn.relu(self.bn1(self.conv1(x)))
        if self.splat:
            y = self.conv2(y)
            if self.avd_last is not None:
                y = self.avd_last(y)
        else:
            y = Fnn.relu(self.bn2(self.conv2(y)))
        return Fnn.relu(self.bn3(self.conv3(y)) + idn)


class ResNetBackbone(nn.Module):
    """Four-stage ResNet; returns the feature at each requested stage
    (out_indices 1..4 -> strides 4, 8, 16, 32), one tensor when one is
    asked for."""

    def __init__(self, arch: str = "resnest50d", in_channels: int = 3,
                 out_indices: Sequence[int] = (4,)):
        super().__init__()
        if arch not in _STAGE_SPECS:
            raise ValueError(f"unknown backbone: {arch!r}")
        kind, depths = _STAGE_SPECS[arch]
        deep = arch.endswith("d")
        self.arch = arch
        self.out_indices = tuple(out_indices)
        if deep:
            self.conv1 = nn.Sequential(
                nn.Conv2d(in_channels, 32, 3, 2, 1, bias=False), _bn(32),
                nn.ReLU(), nn.Conv2d(32, 32, 3, 1, 1, bias=False), _bn(32),
                nn.ReLU(), nn.Conv2d(32, 64, 3, 1, 1, bias=False))
        else:
            self.conv1 = nn.Conv2d(in_channels, 64, 7, 2, 3, bias=False)
        self.bn1 = _bn(64)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        widths = (8, 16, 32, 64) if arch == "micro" else (64, 128, 256, 512)
        cin = 64
        self.feature_channels = []      # of each returned feature
        for stage, (w, d) in enumerate(zip(widths, depths), start=1):
            blocks = []
            for b in range(d):
                stride = 2 if (b == 0 and stage > 1) else 1
                if kind == "basic":
                    blocks.append(BasicBlock(cin, w, stride, avg_down=deep))
                    cin = w
                else:
                    blocks.append(Bottleneck(cin, w, stride, avg_down=deep,
                                             splat=kind == "splat"))
                    cin = w * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
            if stage in self.out_indices:
                self.feature_channels.append(cin)
        self.out_channels = cin

    def forward(self, x: Tensor):
        x = self.maxpool(Fnn.relu(self.bn1(self.conv1(x))))
        outs = []
        for s in range(1, 5):
            x = getattr(self, f"layer{s}")(x)
            if s in self.out_indices:
                outs.append(x)
        return outs if len(outs) > 1 else outs[0]
