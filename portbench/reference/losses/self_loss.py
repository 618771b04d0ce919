"""Stage-II self-supervised loss suites (port of
self6dpp_tpu/losses/self_loss.py: inject_grad, mask_dilate/mask_erode,
compute_mask_edge_weights, vf_loss, norm_loss, compute_self_loss_geo,
compute_self_loss_pose).

Pose-mode terms: the rendered-mask loss against the teacher's pseudo mask
(RW_BCE with edge weights, dice or L1); LAB, as a given (value, gradient)
pair (lab_linear), through kernel B3, by autograd of lab_loss or through
lab_loss_surrogate (lab_impl), the gradient of the first two entering
through InjectGrad; LPIPS; MS-SSIM;
the chamfer between the backprojected rendered and observed depths; xyz
and region init-pred (student vs teacher); pseudo-pose PM and trans; the
vf and norm maps against the pseudo pose's vector field and rendered
normals. Geo-mode terms: the student's masks, xyz, region, vf and norm
against the teacher's (warped) maps.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as Fnn
from torch import Tensor

from ..config import SelfSupConfig
from ..ops.chamfer import chamfer_loss
from ..ops.color import lab_loss, lab_loss_surrogate
from ..ops.geometry import backproject_depth
from ..ops.lab_plain import lab_value_grad_scaled_plain
from ..ops.ssim import ms_ssim
from ..parallel.dist import batch_denom, global_max, rank_share
from .mask_losses import weighted_ex_loss_probs
from .pm_loss import pm_loss

# the chamfer's sampling stride is int((S²/_MAX_DEPTH_POINTS)^0.5): 5 at
# S = 256, 52² = 2704 points per image (the JAX package's max_depth_points)
_MAX_DEPTH_POINTS = 2048


class InjectGrad(torch.autograd.Function):
    """Identity on x whose backward adds g, or g * scale with a 0-d scale,
    to x's cotangent in one elementwise pass. As in the JAX package, g
    reaches the graph only if something downstream consumes the output: an
    unused output has no cotangent to add to."""

    @staticmethod
    def forward(ctx, x, g, scale=None):
        ctx.save_for_backward(g, scale)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        g, scale = ctx.saved_tensors
        if scale is None:
            return ct + g, None, None
        return torch.addcmul(ct, g, scale), None, None


def mask_dilate(mask: Tensor, k: int) -> Tensor:
    """(B, H, W) binary dilation: a k x k max filter ('same' size)."""
    return Fnn.max_pool2d(mask[:, None], k, 1, k // 2)[:, 0]


def mask_erode(mask: Tensor, k: int) -> Tensor:
    return 1.0 - mask_dilate(1.0 - mask, k)


def compute_mask_edge_weights(mask: Tensor, dilate_ks: int = 11,
                              erode_ks: int = 11, w_edge: float = 5.0,
                              edge_lower: bool = True) -> Tensor:
    """Contour-loss edge weights (edge_utils.py:263-286); mask (B,H,W)."""
    edge = mask_dilate(mask, dilate_ks) - mask_erode(mask, erode_ks)
    g = torch.exp(-0.5 * (edge * w_edge) ** 2) / math.sqrt(2 * math.pi)
    if edge_lower:
        return g + 1.0
    return global_max(g.max()) - g + 1.0


def vf_loss(pred_vf: Tensor, gt_vf: Tensor, mask: Tensor) -> Tensor:
    """Masked L1 plus cosine misalignment of 2-D vector fields. pred, gt
    (B,H,W,2k) as [u0,v0,u1,v1,...]; mask (B,H,W)."""
    m = mask[..., None]
    denom = batch_denom(m.sum() * pred_vf.shape[-1])
    l1 = ((pred_vf - gt_vf).abs() * m).sum() / denom
    b, h, w, c = pred_vf.shape
    p = pred_vf.reshape(b, h, w, c // 2, 2)
    g = gt_vf.reshape(b, h, w, c // 2, 2)
    nn_ = torch.linalg.vector_norm(p, dim=-1) * torch.linalg.vector_norm(g, dim=-1)
    cos = (p * g).sum(-1) / nn_.clamp_min(1e-6)
    cos_term = ((1.0 - cos) * m).sum() / batch_denom(mask.sum() * (c // 2))
    return l1 + cos_term


def norm_loss(pred_n: Tensor, gt_n: Tensor, mask: Tensor) -> Tensor:
    """Masked L1 plus cosine misalignment of surface normals (B,H,W,3)."""
    m = mask[..., None]
    l1 = ((pred_n - gt_n).abs() * m).sum() / batch_denom(m.sum() * 3)
    nn_ = (torch.linalg.vector_norm(pred_n, dim=-1)
           * torch.linalg.vector_norm(gt_n, dim=-1))
    cos = (pred_n * gt_n).sum(-1) / nn_.clamp_min(1e-6)
    cos_term = ((1.0 - cos) * mask).sum() / batch_denom(mask.sum())
    return l1 + cos_term


def _init_pred_terms(loss: dict, pred: dict, pseudo: dict) -> None:
    """xyz and region of the student against the teacher's, in its pseudo
    mask at output resolution."""
    m = pseudo["vis_mask_lr"][..., None]
    if "coor" in pred and "coor" in pseudo:
        diff = (pred["coor"] - pseudo["coor"]).abs() * m
        loss["loss_init_pred_xyz"] = diff.sum() / (batch_denom(m.sum()) * 3)
    if "region_logits" in pred and "region" in pseudo:
        pr = torch.softmax(pred["region_logits"], dim=-1)
        loss["loss_region_init_pred"] = ((pr - pseudo["region"]).abs() * m).mean()


def _vf_norm_terms(cfg: SelfSupConfig, loss: dict, pred: dict,
                   pseudo: dict) -> None:
    vis = pseudo["vis_mask_lr"]
    if cfg.vf_lw > 0 and "vf" in pred and "vf" in pseudo:
        loss["loss_vf"] = cfg.vf_lw * vf_loss(pred["vf"], pseudo["vf"], vis)
    if cfg.norm_lw > 0 and "norm" in pred and "norm" in pseudo:
        loss["loss_norm"] = cfg.norm_lw * norm_loss(pred["norm"],
                                                    pseudo["norm"], vis)


def compute_self_loss_geo(cfg: SelfSupConfig, pred: dict[str, Tensor],
                          pseudo: dict[str, Tensor],
                          mask_prob_fn=None) -> dict[str, Tensor]:
    """Geo-mode losses: the student's geo-mode outputs (mask_logits, coor,
    region_logits, vf, norm) against the teacher's pseudo maps in the same
    frame (vis_mask_lr, [full_mask_lr,] coor, region, vf, norm): the visib
    (and full) mask RW_BCE, xyz and region init-pred, vf and norm.
    mask_prob_fn turns mask logits into probabilities."""
    loss: dict[str, Tensor] = {}
    vis_lr = pseudo["vis_mask_lr"]
    if cfg.mask_lw > 0 and mask_prob_fn is not None:
        p = mask_prob_fn(pred["mask_logits"][..., :1])[..., 0]
        loss["loss_vis_mask_init_pred"] = cfg.mask_lw * weighted_ex_loss_probs(
            p.clamp(1e-7, 1 - 1e-7), vis_lr)
        if pred["mask_logits"].shape[-1] >= 2 and "full_mask_lr" in pseudo:
            pf = mask_prob_fn(pred["mask_logits"][..., 1:2])[..., 0]
            loss["loss_full_mask_init_pred"] = cfg.mask_lw * \
                weighted_ex_loss_probs(pf.clamp(1e-7, 1 - 1e-7),
                                       pseudo["full_mask_lr"])
    _init_pred_terms(loss, pred, pseudo)
    _vf_norm_terms(cfg, loss, pred, pseudo)
    return loss


LAB_IMPLS = ("pixel_split", "split_grad", "surrogate", "direct", "pallas")


def check_supported(cfg: SelfSupConfig) -> None:
    """Raise for a lab_impl the JAX package does not have either."""
    if cfg.lab_lw > 0 and cfg.lab_impl not in LAB_IMPLS:
        raise ValueError(f"unknown lab_impl: {cfg.lab_impl!r}")


def compute_self_loss_pose(cfg: SelfSupConfig, ren: dict[str, Tensor],
                           pred: dict[str, Tensor], pseudo: dict[str, Tensor],
                           batch: dict[str, Tensor], lpips_fn=None,
                           lab_linear: tuple | None = None,
                           impl: str = "kernel") -> dict[str, Tensor]:
    """ren: render at the student pose in the ROI frame (color (B,S,S,3),
    prob, mask, depth); pred: student outputs (rot, trans, coor (B,o,o,3),
    region_logits); pseudo: teacher labels (vis_mask (B,S,S), vis_mask_lr
    (B,o,o), rot, trans, coor, region probabilities); batch: roi_img,
    roi_depth, roi_zoom_K, gt_points, roi_extent, sym_rots, sym_valid.
    lpips_fn(a, b) -> (B,) distances, or None to leave LPIPS out (as the
    JAX package does). lab_linear = (value, g): the LAB term is `value` and
    g (B,S,S,3) is added to the masked render's cotangent, instead of B3.
    The chamfer takes every stride-th pixel (_MAX_DEPTH_POINTS). impl
    'plain' runs LAB's plain version on any device."""
    check_supported(cfg)
    loss: dict[str, Tensor] = {}
    pseudo_vis = pseudo["vis_mask"]

    if cfg.mask_lw > 0:
        w = compute_mask_edge_weights(pseudo_vis) if cfg.mask_edge_reweight else None
        if cfg.mask_loss_type == "RW_BCE":
            lm = weighted_ex_loss_probs(ren["prob"].clamp(1e-7, 1 - 1e-7),
                                        pseudo_vis, weight=w)
        elif cfg.mask_loss_type == "dice":
            p, t = ren["prob"].flatten(1), pseudo_vis.flatten(1)
            score = 2.0 * (p * t).sum(1) / (p.sum(1) + t.sum(1) + 0.002)
            lm = (1.0 - score).mean()
        else:
            lm = (ren["prob"] - pseudo_vis).abs().mean()
        loss["loss_mask_self"] = cfg.mask_lw * lm

    # one masked pair for every image loss; LAB's gradient is injected into
    # ren_m before LPIPS and MS-SSIM read it, so the render's cotangent
    # carries it
    vis_m = pseudo_vis[..., None]
    ren_m = ren["color"] * vis_m
    img_m = batch["roi_img"] * vis_m
    if lab_linear is not None:
        lab_val, lab_g = lab_linear
        ren_m = InjectGrad.apply(ren_m, lab_g)
        loss["loss_color_ab_obj"] = torch.as_tensor(
            lab_val, dtype=ren_m.dtype, device=ren_m.device)
    elif cfg.lab_lw > 0 and cfg.lab_impl == "pallas":
        # B3 returns the gradient unnormalised and the 0-d scale lab_lw /
        # (max(sum(mask), 1) * n_ch): InjectGrad adds g_raw * scale to the
        # cotangent in one pass (the JAX package injects lab_lw * g)
        fn = lab_value_grad_scaled_plain
        lab_val, g_raw, scale = fn(ren_m.detach(), img_m.detach(),
                                   pseudo_vis.detach(), cfg.lab_no_l,
                                   cfg.lab_lw)
        share = rank_share(pseudo_vis.sum())
        if share is not None:
            # B3 normalises by this rank's mask; the step's term is the
            # rank's share of the global batch's (parallel/dist.py)
            lab_val, scale = lab_val * share, scale * share
        ren_m = InjectGrad.apply(ren_m, g_raw, scale)
        loss["loss_color_ab_obj"] = cfg.lab_lw * lab_val

    if cfg.perceptual_lw > 0 and lpips_fn is not None:
        loss["loss_percep_obj"] = cfg.perceptual_lw * lpips_fn(ren_m, img_m).mean()
    if cfg.ms_ssim_lw > 0:
        loss["loss_ms_ssim"] = cfg.ms_ssim_lw * (1.0 - ms_ssim(img_m, ren_m))
    if cfg.lab_lw > 0 and cfg.lab_impl != "pallas":
        # surrogate: the same value and gradient through sum(g * ren_m);
        # split_grad and pixel_split reach here only unsplit (direct)
        fn = lab_loss_surrogate if cfg.lab_impl == "surrogate" else lab_loss
        loss["loss_color_ab_obj"] = cfg.lab_lw * fn(
            ren_m, img_m, mask=pseudo_vis, no_l=cfg.lab_no_l)

    if cfg.depth_chamfer_lw > 0 and "roi_depth" in batch:
        Kz = batch["roi_zoom_K"]
        ren_xyz = backproject_depth(ren["depth"], Kz)          # (B,S,S,3)
        obs_xyz = backproject_depth(batch["roi_depth"] * pseudo_vis, Kz)
        B, S = ren_xyz.shape[:2]
        stride = max(1, int((S * S / _MAX_DEPTH_POINTS) ** 0.5))
        rp = ren_xyz[:, ::stride, ::stride].reshape(B, -1, 3)
        op = obs_xyz[:, ::stride, ::stride].reshape(B, -1, 3)
        rw = (rp[..., 2] > 1e-3).to(rp.dtype)
        ow = (op[..., 2] > 1e-3).to(op.dtype)
        loss["loss_chamfer"] = cfg.depth_chamfer_lw * chamfer_loss(
            rp, op, rw, ow, dist_thr=cfg.chamfer_dist_thr,
            center_lw=cfg.chamfer_center_lw)

    _init_pred_terms(loss, pred, pseudo)

    if cfg.pseudo_pm_lw > 0:
        loss.update(pm_loss(
            pred["rot"], pseudo["rot"], batch["gt_points"],
            pred_transes=pred["trans"], gt_transes=pseudo["trans"],
            extents=batch["roi_extent"], sym_rots=batch.get("sym_rots"),
            sym_valid=batch.get("sym_valid"), loss_weight=cfg.pseudo_pm_lw,
            symmetric=True, norm_by_extent=True, r_only=False,
            disentangle_z=True))
    if cfg.pseudo_trans_lw > 0:
        loss["loss_trans_xy"] = cfg.pseudo_trans_lw * (
            pred["trans"][:, :2] - pseudo["trans"][:, :2]).abs().mean()
        loss["loss_trans_z"] = cfg.pseudo_trans_lw * (
            pred["trans"][:, 2] - pseudo["trans"][:, 2]).abs().mean()
    _vf_norm_terms(cfg, loss, pred, pseudo)
    return loss
