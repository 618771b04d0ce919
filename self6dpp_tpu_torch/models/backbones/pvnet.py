"""PVNet's dilated resnet-8s encoder-decoder (port of
self6dpp_tpu/models/backbones/pvnet.py), NCHW: a ResNet (resnet18,
resnet34, resnet50, or the test-only micro) whose stages 3 and 4 dilate by
2 and 4 instead of striding, a 3x3 conv-BN-ReLU `fc` at stride 8, then a
decoder that fuses the skips at strides 8, 4 and 2 (concatenate, 3x3
conv-BN-LeakyReLU(0.1), bilinear 2x) and ends at full resolution with
`raw_dim` channels (the input concatenated first with concat_input).
out_stride 8 or 4 stops the decoder at that fusion; GDRN sets it to
input_res // output_res, so that the features land at output_res.

Module names: conv1/bn1, layer{s}.{b} as the ResNet's, fc, conv8s,
conv4s, conv2s, convraw (each a conv, a BN and an activation).
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn

from ..layers import FlaxBatchNorm2d
from .resnet import _STAGE_SPECS, BasicBlock, Bottleneck


def conv_bn_act(cin: int, cout: int, leaky: bool) -> nn.Sequential:
    return nn.Sequential(nn.Conv2d(cin, cout, 3, 1, 1, bias=False),
                         FlaxBatchNorm2d(cout, eps=1e-5),
                         nn.LeakyReLU(0.1) if leaky else nn.ReLU())


def up2(x: Tensor) -> Tensor:
    """Bilinear 2x with half-pixel centres (jax.image.resize's)."""
    return Fnn.interpolate(x, scale_factor=2, mode="bilinear",
                           align_corners=False)


class PVNetResNet8s(nn.Module):
    def __init__(self, arch: str = "resnet18", in_channels: int = 3,
                 fcdim: int = 256, s8dim: int = 128, s4dim: int = 64,
                 s2dim: int = 32, raw_dim: int = 32,
                 concat_input: bool = False, out_stride: int = 1):
        super().__init__()
        if arch not in _STAGE_SPECS or _STAGE_SPECS[arch][0] == "splat":
            raise ValueError(f"unknown PVNet arch: {arch!r}")
        kind, depths = _STAGE_SPECS[arch]
        widths = (8, 16, 32, 64) if arch == "micro" else (64, 128, 256, 512)
        self.out_stride = out_stride
        self.concat_input = concat_input
        self.conv1 = nn.Conv2d(in_channels, widths[0], 7, 2, 3, bias=False)
        self.bn1 = FlaxBatchNorm2d(widths[0], eps=1e-5)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        cin, skips = widths[0], []
        for stage, (w, d, stride, dil) in enumerate(
                zip(widths, depths, (1, 2, 1, 1), (1, 1, 2, 4)), start=1):
            blocks = []
            for b in range(d):
                s = stride if b == 0 else 1
                if kind == "basic":
                    blocks.append(BasicBlock(cin, w, s, dilation=dil))
                    cin = w
                else:
                    blocks.append(Bottleneck(cin, w, s, dilation=dil))
                    cin = w * 4
            setattr(self, f"layer{stage}", nn.Sequential(*blocks))
            skips.append(cin)
        self.fc = conv_bn_act(cin, fcdim, leaky=False)
        self.conv8s = conv_bn_act(fcdim + skips[1], s8dim, leaky=True)
        out = s8dim
        if out_stride != 8:
            self.conv4s = conv_bn_act(s8dim + skips[0], s4dim, leaky=True)
            out = s4dim
        if out_stride not in (8, 4):
            self.conv2s = conv_bn_act(s4dim + widths[0], s2dim, leaky=True)
            self.convraw = conv_bn_act(
                s2dim + (in_channels if concat_input else 0), raw_dim,
                leaky=True)
            out = raw_dim
        self.feature_channels = [out]

    def forward(self, x: Tensor) -> Tensor:
        inp = x
        x2s = Fnn.relu(self.bn1(self.conv1(x)))
        x4s = self.layer1(self.maxpool(x2s))
        x8s = self.layer2(x4s)
        y = self.layer4(self.layer3(x8s))
        fm = self.conv8s(torch.cat([self.fc(y), x8s], 1))
        if self.out_stride == 8:
            return fm
        fm = self.conv4s(torch.cat([up2(fm), x4s], 1))
        if self.out_stride == 4:
            return fm
        fm = up2(self.conv2s(torch.cat([up2(fm), x2s], 1)))
        if self.concat_input:
            fm = torch.cat([fm, inp], 1)
        return self.convraw(fm)
