"""DeepIM render-and-compare refiner and its loss (port of
self6dpp_tpu/models/deepim.py: DeepIM, deepim_loss; reference
core/deepim/models/DeepIM_{FlowNet,Shared,Unshared}.py).

A trunk on concat(ren, obs), a fully connected delta-pose head and a 1x1
conv mask head. Inputs and outputs are NHWC like the JAX module's. The
network runs in `dtype` (bf16 on the card by default; or in float32 under
an autocast, as the train step runs it); the pose decode runs in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fnn
from torch import Tensor, nn

from ..config import DeepIMConfig
from ..losses.common import sigmoid_bce
from ..losses.flow_loss import multiscale_epe, one_scale_epe
from ..losses.pm_loss import pm_loss
from ..ops import pose_decode
from .backbones.flownet import FLOWNETS_WIDTHS, FlowNetS
from .backbones.resnet import ResNetBackbone
from .layers import get_act


class FCRotTransHead(nn.Module):
    """core/deepim/models/heads/fc_rot_trans_head.py: `linears` holds
    (Linear, norm = Identity, act) per layer, then fc_r and fc_t."""

    def __init__(self, in_dim: int, feat_dim: int = 256, num_layers: int = 2,
                 rot_dim: int = 6, num_classes: int = 1,
                 act: str = "leakyrelu"):
        super().__init__()
        layers = []
        for i in range(num_layers):
            layers += [nn.Linear(in_dim if i == 0 else feat_dim, feat_dim),
                       nn.Identity(), get_act(act)]
        self.linears = nn.Sequential(*layers)
        self.fc_r = nn.Linear(feat_dim, rot_dim * num_classes)
        self.fc_t = nn.Linear(feat_dim, 3 * num_classes)

    def forward(self, x: Tensor) -> tuple[Tensor, Tensor]:
        x = self.linears(x)
        return self.fc_r(x), self.fc_t(x)


class ConvMaskHead(nn.Module):
    """heads/conv_out_head.py with the reference default: the out layer
    only (no feature layers)."""

    def __init__(self, in_dim: int, out_dim: int = 1, kernel_size: int = 1):
        super().__init__()
        self.out_layer = nn.Conv2d(in_dim, out_dim, kernel_size,
                                   padding=(kernel_size - 1) // 2)

    def forward(self, x: Tensor) -> Tensor:
        return self.out_layer(x)


class DeepIM(nn.Module):
    """The three reference refiners behind one module, chosen by cfg.name:

      DeepIM_FlowNet   FlowNetS on concat(ren, obs); the mask head on its
                       concat4 feature, the flow4 output when with_flow;
      DeepIM_Shared    one ResNetBackbone (cfg.backbone; resnet18 for
                       'flownets') on the whole stack, stage 4 only;
      DeepIM_Unshared  two ResNetBackbones of half the input channels,
                       `backbone` on the observation and `backbone_ren` on
                       the render; the pose head reads concat(obs, ren)
                       features, the mask head the observation's.

    Shared and Unshared have no flow head (with_flow raises). `widths`
    sets FlowNetS's level widths."""

    def __init__(self, cfg: DeepIMConfig, dtype: torch.dtype = torch.float32,
                 widths: tuple[int, ...] = FLOWNETS_WIDTHS):
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        if cfg.name == "DeepIM_FlowNet":
            self.backbone = FlowNetS(
                in_channels=cfg.in_channels, use_bn=cfg.use_bn,
                out_flow_level="flow4" if cfg.with_flow else "none",
                out_concat4=cfg.with_mask_head, widths=widths)
            c6, mask_in, stride = widths[5], widths[3] + widths[2] + 2, 64
        elif cfg.name in ("DeepIM_Shared", "DeepIM_Unshared"):
            if cfg.with_flow:
                raise ValueError(f"{cfg.name}: with_flow is FlowNet-only")
            arch = cfg.backbone if cfg.backbone != "flownets" else "resnet18"
            if cfg.name == "DeepIM_Shared":
                self.backbone = ResNetBackbone(arch, cfg.in_channels, (4,))
                c6 = mask_in = self.backbone.out_channels
            else:
                if cfg.in_channels % 2:
                    raise ValueError("DeepIM_Unshared splits ren | obs "
                                     "channels in half")
                half = cfg.in_channels // 2
                self.backbone = ResNetBackbone(arch, half, (4,))
                self.backbone_ren = ResNetBackbone(arch, half, (4,))
                mask_in = self.backbone.out_channels
                c6 = 2 * mask_in
            stride = 32
        else:
            raise ValueError(f"unknown DeepIM variant: {cfg.name!r}")
        # the pose feature's spatial size and channels (for flatten)
        self.feat_hwc = (math.ceil(cfg.input_h / stride),
                         math.ceil(cfg.input_w / stride), c6)
        hw = self.feat_hwc[0] * self.feat_hwc[1]
        in_dim = {"avg": c6, "avg-max": 2 * c6, "avg-max-min": 3 * c6,
                  "flatten": c6 * hw}[cfg.flat_op]
        self.rot_dim = 6 if cfg.rot_type.endswith("rot6d") else 4
        self.pose_head = FCRotTransHead(in_dim, cfg.pose_feat_dim,
                                        cfg.pose_num_layers, self.rot_dim)
        if cfg.with_mask_head:
            self.mask_head = ConvMaskHead(
                mask_in, cfg.num_classes if cfg.mask_class_aware else 1)
        self.to(dtype)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init with the JAX module's initialisers: lecun-normal convs,
        normal(0.001) hidden dense layers, normal(0.01) pose outputs and mask
        conv, zero biases, batch norms at scale 1, bias 0. Draws in float32
        whatever the module's dtype, so float32 and bfloat16 builds from one
        seed share their weights."""
        for name, m in self.named_modules():
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                continue
            if name.startswith(("pose_head.fc_", "mask_head")):
                std = 0.01
            elif name.startswith("pose_head"):
                std = 0.001
            else:
                cin = m.in_channels
                std = (1.0 / (cin * math.prod(m.kernel_size))) ** 0.5
            m.weight.copy_(torch.empty(m.weight.shape).normal_(
                0.0, std, generator=generator))
            if m.bias is not None:
                m.bias.zero_()

    @torch.no_grad()
    def init_identity_heads_(self) -> None:
        """Bias the pose outputs to the identity delta (rot6d/quat identity,
        cosypose vz = 1) for runs without a trained checkpoint, so a refine
        keeps the object in view instead of collapsing z to eps."""
        ident = [1.0, 0, 0, 0, 1.0, 0] if self.rot_dim == 6 else [1.0, 0, 0, 0]
        self.pose_head.fc_r.bias.copy_(torch.tensor(ident))
        self.pose_head.fc_t.bias.copy_(torch.tensor([0.0, 0.0, 1.0]))

    def _trunk(self, x: Tensor):
        """(pose feature map, mask feature map, flow) of x (B, C, H, W)."""
        c = self.cfg
        if c.name == "DeepIM_FlowNet":
            return self.backbone(x)
        if c.name == "DeepIM_Shared":
            conv6 = self.backbone(x)
            return conv6, conv6, None
        # the engine's stack [ren_rgb | obs_rgb | ren_mask | obs_mask] with 8
        # channels (deepim_engine._render_inputs), else [ren | obs] halves
        if c.in_channels == 8:
            x_ren = torch.cat([x[:, 0:3], x[:, 6:7]], dim=1)
            x_obs = torch.cat([x[:, 3:6], x[:, 7:8]], dim=1)
        else:
            half = c.in_channels // 2
            x_ren, x_obs = x[:, :half], x[:, half:]
        feat_ren = self.backbone_ren(x_ren)
        feat_obs = self.backbone(x_obs)
        return torch.cat([feat_obs, feat_ren], dim=1), feat_obs, None

    def forward(self, x: Tensor, init_rot: Tensor, init_trans: Tensor,
                K_zoom: Tensor, obj_class: Tensor | None = None
                ) -> dict[str, Tensor]:
        """x (B, H, W, C) concat(ren, obs); init_rot (B,3,3); init_trans
        (B,3); K_zoom (B,3,3). Returns rot, trans, rot_delta, trans_delta,
        flow (B,H/16,W/16,2; FlowNet with with_flow) and mask_logits
        (B,H,W,1|num_classes)."""
        c = self.cfg
        conv6, mask_feat, flow = self._trunk(
            x.permute(0, 3, 1, 2).to(self.dtype))
        b = conv6.shape[0]
        flat = conv6.flatten(2)                              # (B, C, h*w)
        if c.flat_op == "flatten":
            feat = conv6.reshape(b, -1)       # NCHW order, as the reference
        elif c.flat_op == "avg":
            feat = flat.mean(2)
        elif c.flat_op == "avg-max":
            feat = torch.cat([flat.mean(2), flat.amax(2)], dim=-1)
        else:
            feat = torch.cat([flat.mean(2), flat.amax(2), flat.amin(2)], -1)

        rot_rep, trans_delta = self.pose_head(feat)
        with torch.autocast(x.device.type, enabled=False):
            rot_delta = pose_decode.rot_rep_to_mat(rot_rep.float(), c.rot_type)
            trans_delta = trans_delta.float()
            rot_new, trans_new = pose_decode.pose_from_delta_init(
                rot_delta, trans_delta, init_rot, init_trans, Ks=K_zoom,
                K_aware=True, delta_T_space=c.t_space,
                delta_T_weight=c.t_weight, delta_z_style=c.z_style,
                is_allo="allo" in c.rot_type)

        out = {"rot": rot_new, "trans": trans_new, "rot_delta": rot_delta,
               "trans_delta": trans_delta}
        if flow is not None:
            out["flow"] = flow.permute(0, 2, 3, 1)
        if c.with_mask_head:
            mask = self.mask_head(mask_feat)
            if c.mask_class_aware:
                if obj_class is None:
                    raise ValueError("a class-aware mask head needs obj_class")
                idx = obj_class.long()[:, None, None, None].expand(
                    -1, 1, *mask.shape[2:])
                mask = mask.gather(1, idx)
            # upsample to the input resolution (half-pixel centres, edge
            # clamped: jax.image.resize "bilinear" when upsampling)
            mask = Fnn.interpolate(mask, size=x.shape[1:3], mode="bilinear",
                                   align_corners=False)
            out["mask_logits"] = mask.permute(0, 2, 3, 1)
        return out


def deepim_loss(cfg: DeepIMConfig, out: dict[str, Tensor],
                batch: dict[str, Tensor]) -> dict[str, Tensor]:
    """One refine iteration's weighted loss terms, in float32
    (DeepIM_FlowNet.py:214-310): the symmetric PM loss normalised by the
    extent (pm_lw), the flow EPE on gt_flow / gt_flow_valid (flow_lw; one
    scale, or all five for a list of flows), the mask's sigmoid BCE on
    gt_mask_visib (mask_lw), the trans L1 in xy and z (trans_lw) and the
    rotation trace term (rot_lw).

    batch keys: gt_rot, gt_trans, gt_points, roi_extent, sym_rots,
    sym_valid, gt_flow (B,H,W,2), gt_flow_valid (B,H,W), gt_mask_visib
    (B,H,W)."""
    loss: dict[str, Tensor] = {}
    if cfg.pm_lw > 0:
        loss.update(pm_loss(
            out["rot"], batch["gt_rot"], batch["gt_points"],
            pred_transes=out["trans"], gt_transes=batch["gt_trans"],
            extents=batch.get("roi_extent"),
            sym_rots=batch.get("sym_rots"), sym_valid=batch.get("sym_valid"),
            loss_weight=cfg.pm_lw, symmetric=cfg.pm_loss_sym,
            r_only=cfg.pm_r_only, disentangle_z=cfg.pm_disentangle_z,
            norm_by_extent=True))
    if cfg.flow_lw > 0 and "flow" in out and "gt_flow" in batch:
        f = out["flow"]
        if isinstance(f, list):
            loss["loss_flow"] = cfg.flow_lw * multiscale_epe(
                [x.float() for x in f], batch["gt_flow"],
                batch["gt_flow_valid"])
        else:
            loss["loss_flow"] = cfg.flow_lw * one_scale_epe(
                f.float(), batch["gt_flow"], batch["gt_flow_valid"])
    if cfg.mask_lw > 0 and "mask_logits" in out and "gt_mask_visib" in batch:
        loss["loss_mask"] = cfg.mask_lw * sigmoid_bce(
            out["mask_logits"][..., 0].float(), batch["gt_mask_visib"]).mean()
    if cfg.trans_lw > 0:
        loss["loss_trans_xy"] = cfg.trans_lw * (
            out["trans"][:, :2] - batch["gt_trans"][:, :2]).abs().mean()
        loss["loss_trans_z"] = cfg.trans_lw * (
            out["trans"][:, 2] - batch["gt_trans"][:, 2]).abs().mean()
    if cfg.rot_lw > 0:
        m = out["rot"] @ batch["gt_rot"].transpose(-1, -2)
        tr = m.diagonal(dim1=-2, dim2=-1).sum(-1)
        loss["loss_rot"] = cfg.rot_lw * ((1 - (tr - 1) / 2) / 2).mean()
    return loss
