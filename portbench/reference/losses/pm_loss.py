"""Point-matching loss with symmetry handling (port of
self6dpp_tpu/losses/pm_loss.py: closest_sym_rot, pm_loss)."""

from __future__ import annotations

import torch
from torch import Tensor

from ..ops.geometry import transform_pts
from .common import pointwise_loss


def closest_sym_rot(pred_R: Tensor, gt_R: Tensor, sym_rots: Tensor,
                    sym_valid: Tensor) -> Tensor:
    """Per instance, the gt_R @ S_k (valid k) of largest trace(pred_R
    (gt_R S_k)^T), i.e. least geodesic distance; ties to the first k.
    pred_R, gt_R (B,3,3); sym_rots (B,S,3,3); sym_valid (B,S) bool."""
    cand = torch.einsum("bij,bsjk->bsik", gt_R, sym_rots)
    m = torch.einsum("bij,bskj->bsik", pred_R, cand)
    tr = m.diagonal(dim1=-2, dim2=-1).sum(-1)
    score = torch.where(sym_valid, tr, -torch.inf)
    idx = score.argmax(dim=1)
    return cand[torch.arange(cand.shape[0], device=cand.device), idx]


def pm_loss(pred_rots: Tensor, gt_rots: Tensor, points: Tensor,
            pred_transes: Tensor | None = None,
            gt_transes: Tensor | None = None,
            extents: Tensor | None = None,
            sym_rots: Tensor | None = None, sym_valid: Tensor | None = None,
            loss_type: str = "l1", beta: float = 1.0,
            loss_weight: float = 1.0, norm_by_extent: bool = False,
            symmetric: bool = False, disentangle_t: bool = False,
            disentangle_z: bool = False, t_loss_use_points: bool = True,
            r_only: bool = False) -> dict[str, Tensor]:
    """Weighted PM loss terms, keyed as the reference names them."""
    if symmetric:
        if sym_rots is None or sym_valid is None:
            raise ValueError("symmetric PM loss needs sym_rots and sym_valid")
        gt_rots = closest_sym_rot(pred_rots, gt_rots, sym_rots, sym_valid)
    points_est = transform_pts(points, pred_rots)
    points_tgt = transform_pts(points, gt_rots)
    if norm_by_extent:
        if extents is None:
            raise ValueError("norm_by_extent needs extents")
        weights = 1.0 / extents.amax(dim=1).clamp_min(1e-6)[:, None, None]
    else:
        weights = 1.0

    def pl(a, b):
        return pointwise_loss(loss_type, a, b, beta)

    out: dict[str, Tensor] = {}
    if r_only or pred_transes is None:
        out["loss_PM_R"] = pl(weights * points_est, weights * points_tgt).mean() * 3.0
    elif disentangle_z:
        out["loss_PM_R"] = pl(weights * points_est, weights * points_tgt).mean() * 3.0
        if t_loss_use_points:
            pts_xy = points_tgt + torch.cat(
                [pred_transes[:, :2], gt_transes[:, 2:3]], dim=1)[:, None, :]
            pts_z = points_tgt + torch.cat(
                [gt_transes[:, :2], pred_transes[:, 2:3]], dim=1)[:, None, :]
            tgt = points_tgt + gt_transes[:, None, :]
            out["loss_PM_xy"] = pl(weights * pts_xy, weights * tgt).mean() * 3.0
            out["loss_PM_z"] = pl(weights * pts_z, weights * tgt).mean() * 3.0
        else:
            out["loss_PM_xy_noP"] = pl(pred_transes[:, :2], gt_transes[:, :2]).mean()
            out["loss_PM_z_noP"] = pl(pred_transes[:, 2], gt_transes[:, 2]).mean()
    elif disentangle_t:
        out["loss_PM_R"] = pl(weights * points_est, weights * points_tgt).mean() * 3.0
        if t_loss_use_points:
            pts_t = points_tgt + pred_transes[:, None, :]
            tgt = points_tgt + gt_transes[:, None, :]
            out["loss_PM_T"] = pl(weights * pts_t, weights * tgt).mean() * 3.0
        else:
            out["loss_PM_T_noP"] = pl(pred_transes, gt_transes).mean()
    else:
        est = points_est + pred_transes[:, None, :]
        tgt = points_tgt + gt_transes[:, None, :]
        out["loss_PM_RT"] = pl(weights * est, weights * tgt).mean() * 3.0
    return {k: v * loss_weight for k, v in out.items()}
