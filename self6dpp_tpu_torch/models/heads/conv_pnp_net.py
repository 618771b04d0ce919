"""Patch-PnP head: dense geometry maps -> (rot_rep, centroid + z) (port of
self6dpp_tpu/models/heads/conv_pnp_net.py::ConvPnPNet, which is also the
trunk of ConvPnPNetMaskNormVF: the predicted vf and norm maps join its
input after the mask attention, as extra_feat).

Module names follow the reference ConvPnPNet: `features` (conv, norm, act
per stride-2 layer), fc1, fc2, fc_r, fc_t. Inputs are NHWC, as in the JAX
package; the 'flatten' op flattens NCHW (C-major), as the reference does,
and convert.py permutes the JAX package's NHWC-order fc1 to match.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ...config import PnPNetConfig
from ..layers import Norm, get_act


class ConvPnPNet(nn.Module):
    def __init__(self, cfg: PnPNetConfig, in_channels: int, in_res: int,
                 rot_dim: int = 6):
        super().__init__()
        c = cfg
        if c.drop_prob > 0 or c.with_extent_feat or c.mask_attention != "none":
            raise ValueError("DropBlock, extent features and mask attention "
                             "of the PnP head belong to a later slice")
        self.cfg = cfg
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
        self.flat_res = res
        self.fc1 = nn.Linear(nflat[c.flat_op], 1024)
        self.fc2 = nn.Linear(1024, 256)
        self.fc_r = nn.Linear(256, rot_dim)
        self.fc_t = nn.Linear(256, 3)
        self.act = get_act(c.act)

    def forward(self, coor_feat: Tensor, region: Tensor | None = None,
                extents: Tensor | None = None,
                extra_feat: Tensor | None = None) -> tuple[Tensor, Tensor]:
        """coor_feat (B,H,W,3[+2]) xyz (+2d coords); region (B,H,W,R)
        softmaxed; extents (B,3); extra_feat (B,H,W,E) the vf/norm maps.
        Returns (rot_rep (B,rot_dim), t (B,3))."""
        c = self.cfg
        if (c.denormalize_by_extent and extents is not None
                and coor_feat.shape[-1] in (3, 5)):
            xyz = (coor_feat[..., :3] - 0.5) * extents[:, None, None, :]
            coor_feat = torch.cat([xyz, coor_feat[..., 3:]], dim=-1)
        x = coor_feat if region is None else torch.cat([coor_feat, region], -1)
        if extra_feat is not None:
            x = torch.cat([x, extra_feat.to(x.dtype)], -1)
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
        feat = self.act(self.fc1(feat))
        feat = self.act(self.fc2(feat))
        return self.fc_r(feat), self.fc_t(feat)
