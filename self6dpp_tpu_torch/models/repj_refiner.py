"""Reprojection refiner (port of self6dpp_tpu/models/repj_refiner.py:
_box_iou_from_pose, refine_pose_reprojection, _giou_loss, _compose_rt,
repj_weak_loss; reference
core/self6dpp/models/weakly_sup/reprojection_refiner.py).

refine_pose_reprojection optimises a pose, as (rot6d, t), by Adam against
2D evidence: the projected box's IoU with a detected box, the soft
silhouette's BCE against a detected mask, MS-SSIM against an image and a
PM tie to the initial pose. repj_weak_loss is the stage-II multi-view weak
supervision: the best view's detached pose, carried into every view by the
relative camera extrinsics, against each view's own prediction, by soft
mask IoU and MS-SSIM of renders at three scales, PM and the projected
boxes' GIoU. Every render is 64² in tiles of 16 px with K = 64 candidates
and the soft silhouette at sigma 1.5 px (kernel B1; B2 in the backward of
the renders the gradient reaches). The JAX package renders these on its
XLA path.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..losses.pm_loss import pm_loss
from ..ops.geometry import rot6d_to_mat, transform_pts
from ..ops.rasterizer import rasterize_batch
from ..ops.ssim import ms_ssim
from ..ops.zoom import bboxes_from_pose

_f32 = np.float32
RASTER_KW = dict(tile_px=16, faces_per_tile=64, sigma_px=1.5)


def _box_iou_from_pose(points: Tensor, K: Tensor, rot: Tensor, trans: Tensor,
                       box: Tensor) -> Tensor:
    """IoU of the model points' projected box at the pose with `box` (B,4)
    x1y1x2y2, the union floored at 1 px²."""
    pb = bboxes_from_pose(points, K, rot, trans)
    ix1 = torch.maximum(pb[:, 0], box[:, 0])
    iy1 = torch.maximum(pb[:, 1], box[:, 1])
    ix2 = torch.minimum(pb[:, 2], box[:, 2])
    iy2 = torch.minimum(pb[:, 3], box[:, 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    a1 = (pb[:, 2] - pb[:, 0]) * (pb[:, 3] - pb[:, 1])
    a2 = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    return inter / (a1 + a2 - inter).clamp_min(1.0)


def _abs_jax(x: Tensor) -> Tensor:
    """|x| with jnp.abs's derivative at 0, +1 (torch's is 0): the PM tie
    starts at exactly 0, so its first gradient depends on it."""
    return torch.where(x >= 0, x, -x)


def mat_to_rot6d(m: Tensor) -> Tensor:
    """(..., 3, 3) -> (..., 6): the first two columns."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def refine_pose_reprojection(
    rot_init: Tensor, trans_init: Tensor, verts: Tensor, faces: Tensor,
    colors: Tensor, K: Tensor, target_box: Tensor,
    target_mask: Tensor | None = None, target_img: Tensor | None = None,
    height: int = 64, width: int = 64, n_steps: int = 50, lr: float = 1e-2,
    w_iou: float = 1.0, w_mask: float = 1.0, w_pm: float = 10.0,
    w_ssim: float = 0.0, raster_kw: dict | None = None,
) -> tuple[Tensor, Tensor]:
    """n_steps Adam steps (0.9, 0.999, eps 1e-8 outside the square root) on
    (rot6d, t) from the initial pose; returns the refined (rot, trans).
    rot_init (B,3,3), trans_init (B,3), verts (B,V,3)|(V,3), K (B,3,3)
    intrinsics of the frame the targets are in, target_box (B,4),
    target_mask (B,H,W), target_img (B,H,W,3). raster_kw overrides
    RASTER_KW (e.g. impl='plain')."""
    rkw = dict(RASTER_KW, **(raster_kw or {}))
    points = verts.expand(rot_init.shape[0], *verts.shape[-2:])

    def energy(r6, t):
        rot = rot6d_to_mat(r6)
        out = rasterize_batch(verts, faces, colors, K, rot, t, height=height,
                              width=width, device=t.device, **rkw)
        e = 0.0
        if w_iou > 0:
            e = e - w_iou * _box_iou_from_pose(points, K, rot, t,
                                               target_box).mean()
        if w_mask > 0 and target_mask is not None:
            # BCE of the soft silhouette against the detected mask: unlike
            # a soft IoU it penalises the halo on both sides, so the depth's
            # gradient points the right way
            p = out.prob.clamp(1e-6, 1 - 1e-6)
            bce = -(target_mask * torch.log(p)
                    + (1 - target_mask) * torch.log(1 - p))
            e = e + w_mask * bce.mean()
        if w_ssim > 0 and target_img is not None:
            m = (target_mask if target_mask is not None else out.mask)[..., None]
            e = e + w_ssim * (1.0 - ms_ssim(out.attr * m, target_img * m))
        if w_pm > 0:
            p_ref = transform_pts(points, rot, t)
            p_ini = transform_pts(points, rot_init, trans_init)
            e = e + w_pm * _abs_jax(p_ref - p_ini).mean()
        return e

    params = [mat_to_rot6d(rot_init).detach().clone(),
              trans_init.detach().clone()]
    m = [torch.zeros_like(x) for x in params]
    v = [torch.zeros_like(x) for x in params]
    for i in range(n_steps):
        with torch.enable_grad():
            ps = [x.requires_grad_(True) for x in params]
            grads = torch.autograd.grad(energy(*ps), ps)
        ii = _f32(i) + _f32(1)
        bc1 = float(_f32(1) - _f32(0.9) ** ii)
        bc2 = float(_f32(1) - _f32(0.999) ** ii)
        with torch.no_grad():
            for k, g in enumerate(grads):
                m[k] = 0.9 * m[k] + 0.1 * g
                v[k] = 0.999 * v[k] + 0.001 * g * g
                params[k] = params[k].detach() - lr * (m[k] / bc1) / (
                    torch.sqrt(v[k] / bc2) + 1e-8)
    return rot6d_to_mat(params[0]), params[1]


def _giou_loss(box1: Tensor, box2: Tensor) -> Tensor:
    """Per-sample GIoU loss of x1y1x2y2 boxes (bbox_iou_loss.py giou)."""
    ix1 = torch.maximum(box1[:, 0], box2[:, 0])
    iy1 = torch.maximum(box1[:, 1], box2[:, 1])
    ix2 = torch.minimum(box1[:, 2], box2[:, 2])
    iy2 = torch.minimum(box1[:, 3], box2[:, 3])
    inter = (ix2 - ix1).clamp_min(0) * (iy2 - iy1).clamp_min(0)
    a1 = (box1[:, 2] - box1[:, 0]) * (box1[:, 3] - box1[:, 1])
    a2 = (box2[:, 2] - box2[:, 0]) * (box2[:, 3] - box2[:, 1])
    union = (a1 + a2 - inter).clamp_min(1e-6)
    iou = inter / union
    cx1 = torch.minimum(box1[:, 0], box2[:, 0])
    cy1 = torch.minimum(box1[:, 1], box2[:, 1])
    cx2 = torch.maximum(box1[:, 2], box2[:, 2])
    cy2 = torch.maximum(box1[:, 3], box2[:, 3])
    c = ((cx2 - cx1) * (cy2 - cy1)).clamp_min(1e-6)
    return 1.0 - (iou - (c - union) / c)


def _compose_rt(Ra: Tensor, ta: Tensor, Rb: Tensor, tb: Tensor
                ) -> tuple[Tensor, Tensor]:
    """[Ra ta] @ [Rb tb] for batched rigid 3x4 transforms."""
    return (torch.einsum("bij,bjk->bik", Ra, Rb),
            torch.einsum("bij,bj->bi", Ra, tb) + ta)


def view_cosines(vis_prob: Tensor, full_prob: Tensor) -> Tensor:
    """(B,) cosine between each view's vis and full mask probabilities
    (B,h,w) over its hard full mask (reprojection_refiner.py:134-146)."""
    B = vis_prob.shape[0]
    f = full_prob.reshape(B, -1)
    v = vis_prob.reshape(B, -1)
    h = (f > 0.5).to(f.dtype)
    dot = (f * v * h).sum(-1)
    nrm = torch.sqrt((f * f * h).sum(-1).clamp_min(1e-12)) * \
        torch.sqrt((v * v * h).sum(-1).clamp_min(1e-12))
    return dot / nrm.clamp_min(1e-12)


def repj_inputs(rot: Tensor, trans: Tensor, vis_prob: Tensor,
                full_prob: Tensor, gt_rot: Tensor, gt_trans: Tensor,
                verts: Tensor, faces: Tensor, colors: Tensor, K: Tensor,
                render_res: int = 64, full_hw: tuple[int, int] = (480, 640),
                best: Tensor | None = None):
    """The best view and the poses repj_weak_loss compares: (best (1,),
    anchor (infR, inft, inf_verts, inf_faces, inf_colors, Ks_inf),
    reprojected (repR, rept, Ks_rep)). The best view has the largest
    cosine between the vis and full mask probabilities over the hard full
    mask (the first, at a tie), unless `best` (1,) names it. With one mask
    channel the full mask is the visible one, every cosine is 1 up to
    float32 rounding, and the summation order decides the view
    (view_cosines); `best` pins that choice, e.g. to another
    implementation's. The anchor is its detached pose and mesh in every
    slot; T_best inv(T_i) from the GT poses (used only as relative camera
    extrinsics) carries each view's pose into the best view's camera; both
    use K scaled from full_hw to render_res."""
    if best is None:
        best = torch.argmax(view_cosines(vis_prob, full_prob)).reshape(1)
    best = best.to(rot.device, torch.long)

    def take(x):            # on the device: no wait for the index
        return x.detach().index_select(0, best).expand(x.shape)
    Rinv = gt_rot.transpose(-1, -2)
    tinv = -torch.einsum("bij,bj->bi", Rinv, gt_trans)
    camR, camt = _compose_rt(take(gt_rot), take(gt_trans), Rinv, tinv)
    repR, rept = _compose_rt(camR, camt, rot, trans)
    S = torch.tensor([[render_res / full_hw[1], 0, 0],
                      [0, render_res / full_hw[0], 0], [0, 0, 1.0]],
                     dtype=K.dtype, device=K.device)
    anchor = (take(rot), take(trans), take(verts), take(faces), take(colors),
              torch.einsum("ij,bjk->bik", S, take(K)))
    return best, anchor, (repR, rept, torch.einsum("ij,bjk->bik", S, K))


def repj_weak_loss(
    rot: Tensor, trans: Tensor, vis_prob: Tensor, full_prob: Tensor,
    gt_rot: Tensor, gt_trans: Tensor, verts: Tensor, faces: Tensor,
    colors: Tensor, K: Tensor, points: Tensor, extents: Tensor,
    sym_rots: Tensor | None = None, sym_valid: Tensor | None = None,
    render_res: int = 64, full_hw: tuple[int, int] = (480, 640),
    scales: tuple[int, ...] = (1, 2, 4), w_iou2d3d: float = 0.1,
    w_pm: float = 10.0, w_miou: float = 1.0, w_msssim: float = 1.0,
    raster_kw: dict | None = None, best: Tensor | None = None,
) -> dict[str, Tensor]:
    """Multi-view reprojection consistency (RepjRefiner.forward,
    reprojection_refiner.py:85-310): the student's poses rot (B,3,3), trans
    (B,3) of B views of static scenes, carried into the best view's camera
    (repj_inputs; the gradient flows through them), against the best view's
    detached pose: per scale s the soft mask IoU (loss_repj_miou_s) and the
    MS-SSIM of the colour renders (loss_repj_msssim_s) at trans / s; the
    smooth-L1 PM loss (loss_PM_R_repj, loss_PM_T_repj) and the projected
    boxes' GIoU (loss_repj_3d2d_iou). As in the JAX package every view
    stays in the batch; the best view's own terms are about 0.

    vis_prob, full_prob (B,h,w); gt_rot, gt_trans the scene poses; verts
    (B,V,3), faces (B,F,3), colors (B,V,3); K (B,3,3) full-frame
    intrinsics; points (B,N,3) PM points; extents (B,3). raster_kw
    overrides RASTER_KW (e.g. impl='plain'); best (1,) pins the best view
    (repj_inputs)."""
    rkw = dict(RASTER_KW, **(raster_kw or {}))
    B = rot.shape[0]
    _, (infR, inft, inf_verts, inf_faces, inf_colors, Ks_inf), \
        (repR, rept, Ks_rep) = repj_inputs(
            rot, trans, vis_prob, full_prob, gt_rot, gt_trans, verts, faces,
            colors, K, render_res, full_hw, best)

    loss: dict[str, Tensor] = {}
    for s in scales:
        ren_inf = rasterize_batch(inf_verts, inf_faces, inf_colors, Ks_inf,
                                  infR, inft / s, height=render_res,
                                  width=render_res, device=rot.device, **rkw)
        ren_rep = rasterize_batch(verts, faces, colors, Ks_rep, repR, rept / s,
                                  height=render_res, width=render_res,
                                  device=rot.device, **rkw)
        # soft mask IoU (mask_iou_loss.py:8-34)
        pi, pr = ren_inf.prob, ren_rep.prob
        inter = (pi * pr).reshape(B, -1).sum(-1)
        union = (pi.reshape(B, -1).sum(-1) + pr.reshape(B, -1).sum(-1)
                 - inter).clamp_min(1e-6)
        loss[f"loss_repj_miou_{s}"] = w_miou * (1.0 - inter / union).mean()
        if w_msssim > 0:
            loss[f"loss_repj_msssim_{s}"] = w_msssim * (
                1.0 - ms_ssim(ren_inf.attr, ren_rep.attr))

    if w_pm > 0:
        pm = pm_loss(infR, repR, points, pred_transes=inft, gt_transes=rept,
                     extents=extents, sym_rots=sym_rots, sym_valid=sym_valid,
                     loss_type="smooth_l1", loss_weight=w_pm,
                     symmetric=sym_rots is not None, disentangle_t=True,
                     t_loss_use_points=True, r_only=False)
        loss.update({f"{k}_repj": v for k, v in pm.items()})

    if w_iou2d3d > 0:
        box_rep = bboxes_from_pose(verts, Ks_rep, repR, rept)
        box_inf = bboxes_from_pose(inf_verts, Ks_inf, infR, inft)
        loss["loss_repj_3d2d_iou"] = w_iou2d3d * 0.1 * \
            _giou_loss(box_inf, box_rep).mean()
    return loss
