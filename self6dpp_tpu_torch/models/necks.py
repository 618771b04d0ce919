"""FPN neck (port of self6dpp_tpu/models/necks.py), NCHW: 1x1 laterals
with bias, a top-down sum (each coarser level resized to the finer one's
size by nearest with half-pixel centres, as jax.image.resize does), and
3x3 smoothing convs with bias. Takes and returns the levels finest first.
Module names: lateral{i}, smooth{i}."""

from __future__ import annotations

import torch.nn.functional as Fnn
from torch import Tensor, nn


class FPN(nn.Module):
    def __init__(self, in_channels: list[int], out_channels: int = 256):
        super().__init__()
        self.levels = len(in_channels)
        for i, cin in enumerate(in_channels):
            setattr(self, f"lateral{i}", nn.Conv2d(cin, out_channels, 1))
            setattr(self, f"smooth{i}",
                    nn.Conv2d(out_channels, out_channels, 3, 1, 1))
        self.feature_channels = [out_channels] * self.levels

    def forward(self, feats: list[Tensor]) -> list[Tensor]:
        if len(feats) != self.levels:
            raise ValueError(f"FPN of {self.levels} levels given {len(feats)}")
        lat = [getattr(self, f"lateral{i}")(f) for i, f in enumerate(feats)]
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + Fnn.interpolate(
                lat[i + 1], size=lat[i].shape[-2:], mode="nearest-exact")
        return [getattr(self, f"smooth{i}")(x) for i, x in enumerate(lat)]
