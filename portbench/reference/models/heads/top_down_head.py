"""The geometry head: a backbone feature -> dense maps at output_res (port
of self6dpp_tpu/models/heads/top_down_head.py: TopDownGeoHead,
geo_map_channels, emit_geo_maps, gather_class_aware; the conv and FPN
heads are left out, since no cell builds them).

Module names follow the reference TopDownMaskXyzRegionHead (`features` as
one ModuleList: deconv, norm, act, then ConvModules and parameter-free
upsamples; the shared `out_layer`, or one `out_{k}` a map when the out
layers are split). forward takes NCHW and returns a dict of NHWC maps,
the JAX package's layout.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ...config import GeoHeadConfig
from ..layers import ConvNormAct, ConvTranspose2x, Norm, Upsample2x, get_act


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
