"""GDR-Net: backbone -> geo head -> Patch-PnP -> differentiable pose
(port of self6dpp_tpu/models/gdrn.py) for the architectures the
benchmark's cells and tests build: the ResNet/ResNeSt backbones (and the
test-size `micro`), the TopDown geo head (with its double-mask, vf and
norm outputs), the ConvPnPNet and ConvPnPNetMaskNormVF PnP heads, and the
translation decodings centroid_z, centroid_z_abs and trans. The port's
other backbones (darknet53, pvnet), the FPN neck, the conv and FPN geo
heads and SimplePointPnPNet are left out; a configuration naming one is
refused.

Batch norm trains as Flax's does (models/layers.py::FlaxBatchNorm2d) in
train mode; DropBlock in the PnP head draws from the generator forward is
given, in train mode only. With use_mtl the model holds the multi-task log
variances (`mtl`, one per loss term of losses/gdrn_loss.py::MTL_TERMS),
which the JAX package keeps under params['mtl'].

Inputs and outputs keep the JAX package's NHWC layout (roi_img (B,S,S,3),
roi_coord_2d (B,o,o,2), dense outputs (B,o,o,C)); inside, the network runs
NCHW. Submodule names (backbone, geo_head_net, pnp_net) are the reference
checkpoint's.
"""

from __future__ import annotations

import torch
from torch import Tensor, nn

from ..config import PoseNetConfig
from ..losses.gdrn_loss import MTL_TERMS
from ..losses.mask_losses import get_mask_prob
from ..ops import pose_decode
from .backbones.resnet import ResNetBackbone
from .heads.conv_pnp_net import ConvPnPNet
from .heads.top_down_head import TopDownGeoHead, gather_class_aware


class GDRN(nn.Module):
    def __init__(self, cfg: PoseNetConfig):
        super().__init__()
        c = cfg
        gh, pn = c.geo_head, c.pnp_net
        if c.neck != "none" or gh.name in ("FPNMaskXyzRegionHead",
                                           "ConvMaskXyzRegionHead"):
            raise ValueError("the reference builds no neck and only the "
                             "TopDown geo head")
        if pn.trans_type not in ("centroid_z", "centroid_z_abs", "trans"):
            raise ValueError(f"unknown trans_type: {pn.trans_type}")
        self.cfg = cfg
        b = c.backbone
        self.backbone = ResNetBackbone(b.name, b.input_channels,
                                       b.out_indices)
        chans = list(self.backbone.feature_channels)
        self.geo_head_net = TopDownGeoHead(gh, chans[-1], c.num_classes)
        region = gh.num_regions if pn.region_attention else 0
        nin = 3 + (2 if pn.with_2d_coord else 0) + region
        nin += 1 if pn.mask_attention == "concat" else 0
        if pn.name == "ConvPnPNetMaskNormVF":
            # the vf and norm maps join the PnP input (class slices)
            if not (gh.with_vf or gh.with_norm):
                raise ValueError("ConvPnPNetMaskNormVF needs with_vf/with_norm")
            nin += 4 * gh.num_vf_points * gh.with_vf + 3 * gh.with_norm
        rot_dim = 6 if pn.rot_type.endswith("rot6d") else 4
        if pn.name in ("ConvPnPNet", "ConvPnPNetMaskNormVF"):
            self.pnp_net = ConvPnPNet(pn, nin, c.output_res, rot_dim)
        else:
            raise KeyError(pn.name)
        if c.use_mtl:
            self.mtl = nn.ParameterDict(
                {k: nn.Parameter(torch.zeros(1)) for k in MTL_TERMS})

    def forward(self, roi_img: Tensor, roi_cls: Tensor, roi_cam: Tensor,
                roi_center: Tensor, roi_wh: Tensor, roi_extent: Tensor,
                resize_ratio: Tensor, roi_coord_2d: Tensor | None = None,
                forward_mode: str = "all",
                generator: torch.Generator | None = None
                ) -> dict[str, Tensor]:
        """generator: the PnP head's DropBlock draws (train mode with
        drop_prob > 0; otherwise nothing is drawn)."""
        c = self.cfg
        gh, pn = c.geo_head, c.pnp_net
        feat = self.backbone(roi_img.permute(0, 3, 1, 2))
        if isinstance(feat, list):
            # the top-down head takes the coarsest level (its up-blocks
            # bring it to output_res)
            feat = feat[-1]
        maps = self.geo_head_net(feat)
        maps = gather_class_aware(maps, gh, c.num_classes, roi_cls)

        out: dict[str, Tensor] = {}
        xyz = maps["xyz"]
        if gh.xyz_bin > 1:
            # binned coordinates (.., 3, bin+1); softmax over the bins (the
            # last is background), expectation over the bin centres
            b, h, w, _ = xyz.shape
            bins = xyz.reshape(b, h, w, 3, gh.xyz_bin + 1)
            out["coor_logits"] = bins
            soft = torch.softmax(bins[..., :gh.xyz_bin], dim=-1)
            centers = (torch.arange(gh.xyz_bin, device=xyz.device,
                                    dtype=soft.dtype) + 0.5) / gh.xyz_bin
            coor = (soft * centers).sum(-1)
        else:
            coor = xyz
        out["coor"] = coor
        out["mask_logits"] = maps["mask"]
        out["region_logits"] = maps["region"]
        for k in ("vf", "norm"):
            if k in maps:
                out[k] = maps[k]
        if forward_mode == "geo":
            return out

        coor_feat = coor
        if pn.with_2d_coord:
            if roi_coord_2d is None:
                raise ValueError("with_2d_coord needs roi_coord_2d")
            coor_feat = torch.cat([coor_feat, roi_coord_2d.to(coor.dtype)], -1)
        region_atten = (torch.softmax(maps["region"][..., 1:], dim=-1)
                        if pn.region_attention else None)
        mask_atten = (get_mask_prob(maps["mask"], c.loss.mask_loss_type)
                      if pn.mask_attention != "none" else None)
        extra = None
        if pn.name == "ConvPnPNetMaskNormVF":
            extra = torch.cat([maps[k] for k in ("vf", "norm") if k in maps], -1)
        rot_rep, pred_t = self.pnp_net(coor_feat, region=region_atten,
                                       extents=roi_extent,
                                       mask_attention=mask_atten,
                                       extra_feat=extra, generator=generator)
        # the pose is decoded in float32 whatever the compute dtype: the
        # render and the pose losses take it in float32
        with torch.autocast(rot_rep.device.type, enabled=False):
            rot_rep, pred_t = rot_rep.float(), pred_t.float()
            rot_m = pose_decode.rot_rep_to_mat(rot_rep, pn.rot_type)
            is_allo = "allo" in pn.rot_type
            if pn.trans_type == "centroid_z":
                rot, trans = pose_decode.pose_from_centroid_z(
                    rot_m, pred_t[:, :2], pred_t[:, 2:3], roi_cam, roi_center,
                    resize_ratio, roi_wh, is_allo=is_allo, z_type=pn.z_type)
            elif pn.trans_type == "centroid_z_abs":
                rot, trans = pose_decode.pose_from_centroid_z_abs(
                    rot_m, pred_t[:, :2], pred_t[:, 2:3], roi_cam,
                    is_allo=is_allo)
            else:
                rot, trans = pose_decode.pose_from_trans(rot_m, pred_t,
                                                         is_allo=is_allo)
        out.update({"rot": rot, "trans": trans, "rot_allo": rot_m,
                    "pred_t_net": pred_t})
        return out
