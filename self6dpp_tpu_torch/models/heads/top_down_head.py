"""Geometry heads: backbone feature(s) -> dense maps at output_res (port
of self6dpp_tpu/models/heads/top_down_head.py: TopDownGeoHead,
ConvGeoHead, FPNGeoHead, geo_map_channels, emit_geo_maps,
gather_class_aware).

Module names follow the reference TopDownMaskXyzRegionHead (`features` as
one ModuleList: deconv, norm, act, then ConvModules and parameter-free
upsamples; the shared `out_layer`, or one `out_{k}` a map when the out
layers are split). forward takes NCHW (the FPN head a list of NCHW levels,
finest first) and returns a dict of NHWC maps, the JAX package's layout.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor, nn

from ...config import GeoHeadConfig
from ..layers import (ConvNormAct, ConvTranspose2x, Norm, Upsample2x, get_act,
                      upsample2x_align_corners)


def geo_map_channels(c: GeoHeadConfig, num_classes: int) -> dict[str, int]:
    """Output channel plan, in the shared out layer's order: mask
    (num_masks: visib [+ full]), xyz (3, or 3*(xyz_bin+1) binned), region
    (num_regions + 1), with_vf: vf (4*num_vf_points: {u,v} of each point,
    visib then full), with_norm: norm (3); each times num_classes when
    class-aware (vf and norm follow xyz)."""
    xyz_dim = 3 if c.xyz_bin <= 1 else 3 * (c.xyz_bin + 1)
    xyz_mult = num_classes if c.xyz_class_aware else 1
    chans = {
        "mask": c.num_masks * (num_classes if c.mask_class_aware else 1),
        "xyz": xyz_dim * xyz_mult,
        "region": (c.num_regions + 1) * (num_classes if c.region_class_aware
                                         else 1),
    }
    if c.with_vf:
        chans["vf"] = 4 * c.num_vf_points * xyz_mult
    if c.with_norm:
        chans["norm"] = 3 * xyz_mult
    return chans


def add_out_layers(head: nn.Module, c: GeoHeadConfig, cin: int,
                   num_classes: int) -> None:
    """The common tail of every geo head: one shared conv `out_layer`
    emitting mask|xyz|region[|vf|norm], or (out_layer_shared False) one conv
    `out_{k}` for each map."""
    head.chans = geo_map_channels(c, num_classes)
    k = c.out_kernel_size
    if c.out_layer_shared:
        head.out_layer = nn.Conv2d(cin, sum(head.chans.values()), k, 1, k // 2)
    else:
        for name, n in head.chans.items():
            setattr(head, f"out_{name}", nn.Conv2d(cin, n, k, 1, k // 2))


def emit_geo_maps(head: nn.Module, x: Tensor) -> dict[str, Tensor]:
    """The map dict (NHWC) from the out layer(s) add_out_layers put on
    `head`."""
    if hasattr(head, "out_layer"):
        out = head.out_layer(x).permute(0, 2, 3, 1)
        maps, ofs = {}, 0
        for k, n in head.chans.items():
            maps[k] = out[..., ofs:ofs + n]
            ofs += n
        return maps
    return {k: getattr(head, f"out_{k}")(x).permute(0, 2, 3, 1)
            for k in head.chans}


class TopDownGeoHead(nn.Module):
    """Up-blocks (deconv + norm + act, or a parameter-free 2x upsample,
    then num_conv_per_block ConvModules each) from the coarsest feature to
    output_res."""

    def __init__(self, cfg: GeoHeadConfig, in_channels: int,
                 num_classes: int = 1):
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.num_classes = num_classes
        layers: list[nn.Module] = []
        cin = in_channels
        for up in c.up_types:
            if up == "deconv":
                layers += [ConvTranspose2x(cin, c.feat_dim, c.deconv_kernel_size),
                           Norm(c.norm, c.feat_dim, c.num_gn_groups),
                           get_act(c.act)]
            else:
                layers.append(Upsample2x(up))
            cin_blk = c.feat_dim if up == "deconv" else cin
            for _ in range(c.num_conv_per_block):
                layers.append(ConvNormAct(cin_blk, c.feat_dim, c.feat_kernel_size,
                                          c.norm, c.num_gn_groups, c.act))
                cin_blk = c.feat_dim
            cin = c.feat_dim
        self.features = nn.ModuleList(layers)
        add_out_layers(self, c, c.feat_dim, num_classes)

    def forward(self, x: Tensor) -> dict[str, Tensor]:
        for layer in self.features:
            x = layer(x)
        return emit_geo_maps(self, x)


class ConvGeoHead(nn.Module):
    """The plain conv head (ConvMaskXyzRegionHead): num_feat_layers
    ConvModules at the feature's own resolution, then the out layer(s)."""

    def __init__(self, cfg: GeoHeadConfig, in_channels: int,
                 num_classes: int = 1):
        super().__init__()
        c = cfg
        self.cfg = cfg
        layers, cin = [], in_channels
        for _ in range(c.num_feat_layers):
            layers.append(ConvNormAct(cin, c.feat_dim, c.feat_kernel_size,
                                      c.norm, c.num_gn_groups, c.act))
            cin = c.feat_dim
        self.features = nn.ModuleList(layers)
        add_out_layers(self, c, cin, num_classes)

    def forward(self, x: Tensor) -> dict[str, Tensor]:
        for layer in self.features:
            x = layer(x)
        return emit_geo_maps(self, x)


class FPNGeoHead(nn.Module):
    """The Semantic-FPN head (FPNMaskXyzRegionHead): level i (stride s_i)
    goes through max(1, log2(s_i / s_0)) 3x3 ConvModules, each followed by
    a bilinear (align-corners) 2x upsample when s_i is not the finest
    stride s_0; the levels are summed at s_0, then the out layer(s).
    `scale_heads.<level>.<j>` is level's j-th ConvModule."""

    def __init__(self, cfg: GeoHeadConfig, in_channels: list[int],
                 feature_strides: tuple[int, ...], num_classes: int = 1):
        super().__init__()
        c = cfg
        if len(in_channels) != len(feature_strides):
            raise ValueError(f"{len(in_channels)} levels for strides "
                             f"{feature_strides}")
        self.cfg = cfg
        self.feature_strides = tuple(feature_strides)
        base = self.feature_strides[0]
        heads = []
        for cin, stride in zip(in_channels, self.feature_strides):
            n = max(1, int(math.log2(stride) - math.log2(base)))
            heads.append(nn.ModuleList(
                ConvNormAct(cin if j == 0 else c.feat_dim, c.feat_dim, 3,
                            c.norm, c.num_gn_groups, c.act) for j in range(n)))
        self.scale_heads = nn.ModuleList(heads)
        add_out_layers(self, c, c.feat_dim, num_classes)

    def forward(self, feats: list[Tensor]) -> dict[str, Tensor]:
        if len(feats) != len(self.feature_strides):
            raise ValueError(f"{len(feats)} levels for strides "
                             f"{self.feature_strides}")
        base = self.feature_strides[0]
        out = None
        for x, stride, head in zip(feats, self.feature_strides,
                                   self.scale_heads):
            for layer in head:
                x = layer(x)
                if stride != base:
                    x = upsample2x_align_corners(x)
            out = x if out is None else out + x
        return emit_geo_maps(self, out)


def gather_class_aware(maps: dict[str, Tensor], cfg: GeoHeadConfig,
                       num_classes: int, roi_cls: Tensor) -> dict[str, Tensor]:
    """Select each ROI's class slice of the class-aware (NHWC) maps."""
    out = dict(maps)
    flags = {"mask": cfg.mask_class_aware, "xyz": cfg.xyz_class_aware,
             "region": cfg.region_class_aware, "vf": cfg.xyz_class_aware,
             "norm": cfg.xyz_class_aware}
    for k, v in maps.items():
        if not flags.get(k, False):
            continue
        n, h, w, c = v.shape
        per = c // num_classes
        v = v.reshape(n, h, w, num_classes, per)
        idx = roi_cls.long()[:, None, None, None, None].expand(n, h, w, 1, per)
        out[k] = torch.gather(v, 3, idx)[..., 0, :]
    return out
