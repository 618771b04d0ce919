"""The stage-I GDR-Net loss (port of self6dpp_tpu/losses/gdrn_loss.py):
xyz (masked L1 or binned CE), mask and the second (full) mask, region CE,
the supervised vf/norm terms, PM, rot, centroid, z, trans and bind, with the
optional multi-task (MTL) uncertainty weighting. The JAX function's
geo_frozen flag, which no ported caller sets, is left out."""

from __future__ import annotations

import torch
from torch import Tensor

from ..config import LossConfig, PnPNetConfig
from ..parallel.dist import batch_denom
from .common import pointwise_loss, softmax_ce
from .mask_losses import mask_loss
from .pm_loss import pm_loss
from .self_loss import norm_loss, vf_loss

# every term gdrn_loss can give, without its "loss_" prefix: the names of
# the MTL log variances
MTL_TERMS = ("coor_x", "coor_y", "coor_z", "mask", "mask_full", "region",
             "vf_vis", "vf_full", "norm", "PM_R", "PM_xy", "PM_z",
             "PM_xy_noP", "PM_z_noP", "PM_T", "PM_T_noP", "PM_RT", "rot",
             "centroid", "z", "trans_xy", "trans_z", "trans_LPnP", "bind")


def gdrn_loss(cfg: LossConfig, pnp_cfg: PnPNetConfig, out: dict[str, Tensor],
              batch: dict[str, Tensor], num_regions: int = 64,
              xyz_bin: int = 1, mtl_log_vars: dict[str, Tensor] | None = None
              ) -> dict[str, Tensor]:
    """out: the GDRN's outputs; batch: the ground truth (gt_mask_{trunc,
    visib,obj[,full]}, gt_xyz or gt_xyz_bin, gt_region, gt_rot, gt_trans,
    gt_trans_ratio, gt_points, sym_rots, sym_valid, roi_extent, and
    gt_vf_vis/gt_vf_full/gt_norm for the vf/norm heads). mtl_log_vars
    {term: (1,) log variance}: each term present becomes
    loss * exp(-lv) + log(1 + exp(lv))."""
    loss: dict[str, Tensor] = {}
    gt_masks = {"trunc": batch["gt_mask_trunc"], "visib": batch["gt_mask_visib"],
                "obj": batch["gt_mask_obj"]}

    gm = gt_masks[cfg.xyz_loss_mask_gt]
    denom = batch_denom(gm.sum())
    if cfg.xyz_loss_type == "L1":
        diff = (out["coor"] - batch["gt_xyz"]).abs() * gm[..., None]
        for i, ax in enumerate("xyz"):
            loss[f"loss_coor_{ax}"] = diff[..., i].sum() / denom * cfg.xyz_lw
    elif cfg.xyz_loss_type == "CE_coor":
        logits = out["coor_logits"]                      # (B,H,W,3,bin+1)
        gt_bin = batch["gt_xyz_bin"].long()
        for i, ax in enumerate("xyz"):
            ce = softmax_ce(logits[..., i, :], gt_bin[..., i], dim=-1)
            loss[f"loss_coor_{ax}"] = (ce * gm).sum() / denom * cfg.xyz_lw
    else:
        raise ValueError(cfg.xyz_loss_type)

    loss["loss_mask"] = mask_loss(out["mask_logits"][..., :1],
                                  gt_masks[cfg.mask_loss_gt],
                                  cfg.mask_loss_type) * cfg.mask_lw
    if out["mask_logits"].shape[-1] >= 2 and "gt_mask_full" in batch:
        loss["loss_mask_full"] = mask_loss(
            out["mask_logits"][..., 1:2], batch["gt_mask_full"],
            cfg.mask_loss_type) * cfg.full_mask_lw

    gm = gt_masks[cfg.region_loss_mask_gt]
    ce = softmax_ce(out["region_logits"], batch["gt_region"], dim=-1)
    loss["loss_region"] = (ce * gm).sum() / batch_denom(gm.sum()) \
        * cfg.region_lw

    if cfg.vf_lw > 0 and "vf" in out and "gt_vf_vis" in batch:
        half = out["vf"].shape[-1] // 2              # [vis 2f | full 2f]
        loss["loss_vf_vis"] = cfg.vf_lw * vf_loss(
            out["vf"][..., :half], batch["gt_vf_vis"], batch["gt_mask_visib"])
        loss["loss_vf_full"] = cfg.vf_lw * vf_loss(
            out["vf"][..., half:], batch["gt_vf_full"], batch["gt_mask_obj"])
    if cfg.norm_lw > 0 and "norm" in out and "gt_norm" in batch:
        loss["loss_norm"] = cfg.norm_lw * norm_loss(
            out["norm"], batch["gt_norm"], batch["gt_mask_visib"])

    if cfg.pm_lw > 0:
        loss.update(pm_loss(
            out["rot"], batch["gt_rot"], batch["gt_points"],
            pred_transes=out["trans"], gt_transes=batch["gt_trans"],
            extents=batch["roi_extent"], sym_rots=batch.get("sym_rots"),
            sym_valid=batch.get("sym_valid"),
            loss_type=cfg.pm_loss_type.lower(), beta=cfg.pm_smooth_l1_beta,
            loss_weight=cfg.pm_lw, norm_by_extent=cfg.pm_norm_by_extent,
            symmetric=cfg.pm_loss_sym, disentangle_t=cfg.pm_disentangle_t,
            disentangle_z=cfg.pm_disentangle_z,
            t_loss_use_points=cfg.pm_t_use_points, r_only=cfg.pm_r_only))

    if cfg.rot_lw > 0:
        if cfg.rot_loss_type == "angular":
            m = out["rot"] @ batch["gt_rot"].transpose(-1, -2)
            tr = m.diagonal(dim1=-2, dim2=-1).sum(-1)
            loss["loss_rot"] = ((1.0 - (tr - 1.0) / 2.0) / 2.0).mean() \
                * cfg.rot_lw
        else:
            loss["loss_rot"] = ((out["rot"] - batch["gt_rot"]) ** 2).mean() \
                * cfg.rot_lw

    pred_t = out["pred_t_net"]
    if cfg.centroid_lw > 0 and pnp_cfg.trans_type == "centroid_z":
        loss["loss_centroid"] = pointwise_loss(
            cfg.centroid_loss_type, pred_t[:, :2],
            batch["gt_trans_ratio"][:, :2]).mean() * cfg.centroid_lw
    if cfg.z_lw > 0:
        gt_z = (batch["gt_trans_ratio"][:, 2] if pnp_cfg.z_type == "REL"
                else batch["gt_trans"][:, 2])
        loss["loss_z"] = pointwise_loss(cfg.z_loss_type, pred_t[:, 2],
                                        gt_z).mean() * cfg.z_lw

    if cfg.trans_lw > 0:
        t, gt = out["trans"], batch["gt_trans"]
        if cfg.trans_loss_disentangle:
            loss["loss_trans_xy"] = pointwise_loss(
                cfg.trans_loss_type, t[:, :2], gt[:, :2]).mean() * cfg.trans_lw
            loss["loss_trans_z"] = pointwise_loss(
                cfg.trans_loss_type, t[:, 2], gt[:, 2]).mean() * cfg.trans_lw
        else:
            loss["loss_trans_LPnP"] = pointwise_loss(
                cfg.trans_loss_type, t, gt).mean() * cfg.trans_lw

    if cfg.bind_lw > 0:
        pred_bind = torch.einsum("bji,bj->bi", out["rot"], out["trans"])
        gt_bind = torch.einsum("bji,bj->bi", batch["gt_rot"], batch["gt_trans"])
        loss["loss_bind"] = pointwise_loss(cfg.bind_loss_type, pred_bind,
                                           gt_bind).mean() * cfg.bind_lw

    if mtl_log_vars is not None:
        for k in list(loss):
            name = k.replace("loss_", "")
            if name in mtl_log_vars:
                lv = mtl_log_vars[name][0]
                loss[k] = loss[k] * torch.exp(-lv) + torch.log1p(torch.exp(lv))
    return loss
