"""Patch-PnP heads: dense geometry maps -> (rot_rep, translation terms)
(port of self6dpp_tpu/models/heads/conv_pnp_net.py): ConvPnPNet, which is
also the trunk of ConvPnPNetMaskNormVF (the predicted vf and norm maps
join its input after the mask attention, as extra_feat). The point-net
style SimplePointPnPNet is left out, since no cell builds it.

ConvPnPNet's module names follow the reference ConvPnPNet: `features`
(conv, norm, act per stride-2 layer), fc1, fc2, fc_r, fc_t, and the extent
embedding fc_extent1, fc_extent2. Inputs are NHWC, as in the JAX package;
the 'flatten' op flattens NCHW (C-major), as the reference does, and
convert.py permutes the JAX package's NHWC-order fc1 to match.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ...config import PnPNetConfig
from ..layers import DropBlock, Norm, get_act


def pnp_input(cfg: PnPNetConfig, coor_feat: Tensor, extents: Tensor | None
              ) -> Tensor:
    """coor_feat with its xyz denormalised by the extents when the
    configuration asks (and the feature is xyz, with or without the 2D
    coordinates)."""
    if (cfg.denormalize_by_extent and extents is not None
            and coor_feat.shape[-1] in (3, 5)):
        xyz = (coor_feat[..., :3] - 0.5) * extents[:, None, None, :]
        coor_feat = torch.cat([xyz, coor_feat[..., 3:]], dim=-1)
    return coor_feat


def attend(cfg: PnPNetConfig, x: Tensor, mask_attention: Tensor | None
           ) -> Tensor:
    """The mask attention: x times the mask probability ('mul') or the
    probability as more channels ('concat')."""
    if cfg.mask_attention == "mul":
        return x * mask_attention
    if cfg.mask_attention == "concat":
        return torch.cat([x, mask_attention.to(x.dtype)], -1)
    if cfg.mask_attention != "none":
        raise ValueError(f"unknown mask_attention: {cfg.mask_attention!r}")
    return x


class ConvPnPNet(nn.Module):
    def __init__(self, cfg: PnPNetConfig, in_channels: int, in_res: int,
                 rot_dim: int = 6):
        """in_channels: the assembled input's channels (xyz, 2D
        coordinates, region attention, the mask when concatenated, the
        extra maps)."""
        super().__init__()
        c = cfg
        self.cfg = cfg
        self.dropblock = DropBlock(c.drop_prob)
        layers: list[nn.Module] = []
        cin, res = in_channels, in_res
        for _ in range(c.num_stride2_layers):
            layers += [nn.Conv2d(cin, c.featdim, 3, 2, 1, bias=False),
                       Norm(c.norm, c.featdim, c.num_gn_groups), get_act(c.act)]
            cin, res = c.featdim, -(-res // 2)
        for _ in range(c.num_extra_layers):
            layers += [nn.Conv2d(cin, c.featdim, 3, 1, 1, bias=False),
                       Norm(c.norm, c.featdim, c.num_gn_groups), get_act(c.act)]
        self.features = nn.ModuleList(layers)
        nflat = {"flatten": c.featdim * res * res, "avg": c.featdim,
                 "avg-max": 2 * c.featdim, "avg-max-min": 3 * c.featdim}
        if c.flat_op not in nflat:
            raise ValueError(f"unknown flat_op: {c.flat_op}")
        # the (h, w, c) order of the JAX package's flattened feature, which
        # convert.py permutes into fc1's input (the extent rows follow it)
        self.flat_hwc = ((res, res, c.featdim) if c.flat_op == "flatten"
                         else (1, 1, nflat[c.flat_op]))
        nfc = nflat[c.flat_op]
        if c.with_extent_feat:
            self.fc_extent1 = nn.Linear(3, 64)
            self.fc_extent2 = nn.Linear(64, 128)
            nfc += 128
        self.fc1 = nn.Linear(nfc, 1024)
        self.fc2 = nn.Linear(1024, 256)
        self.fc_r = nn.Linear(256, rot_dim)
        self.fc_t = nn.Linear(256, 3)
        self.act = get_act(c.act)

    def forward(self, coor_feat: Tensor, region: Tensor | None = None,
                extents: Tensor | None = None,
                mask_attention: Tensor | None = None,
                extra_feat: Tensor | None = None,
                generator: torch.Generator | None = None
                ) -> tuple[Tensor, Tensor]:
        """coor_feat (B,H,W,3[+2]) xyz (+2d coords); region (B,H,W,R)
        softmaxed; extents (B,3); mask_attention (B,H,W,M) the mask
        probability; extra_feat (B,H,W,E) the vf/norm maps; generator:
        DropBlock's draws (training mode, drop_prob > 0). Returns (rot_rep
        (B,rot_dim), t (B,3))."""
        c = self.cfg
        x = pnp_input(c, coor_feat, extents)
        if region is not None:
            x = torch.cat([x, region], -1)
        x = attend(c, x, mask_attention)
        if extra_feat is not None:
            x = torch.cat([x, extra_feat.to(x.dtype)], -1)
        x = self.dropblock(x, generator)
        x = x.permute(0, 3, 1, 2)
        for layer in self.features:
            x = layer(x)
        flat = x.flatten(2)                                  # (B, C, HW)
        if c.flat_op == "flatten":
            feat = flat.flatten(1)
        elif c.flat_op == "avg":
            feat = flat.mean(2)
        elif c.flat_op == "avg-max":
            feat = torch.cat([flat.mean(2), flat.amax(2)], -1)
        else:
            feat = torch.cat([flat.mean(2), flat.amax(2), flat.amin(2)], -1)
        if c.with_extent_feat and extents is not None:
            ext = self.act(self.fc_extent2(self.act(self.fc_extent1(extents))))
            feat = torch.cat([feat, ext.to(feat.dtype)], -1)
        feat = self.act(self.fc1(feat))
        feat = self.act(self.fc2(feat))
        return self.fc_r(feat), self.fc_t(feat)
