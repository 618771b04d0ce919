"""6D pose errors (ADD, ADD-S, re, te, proj, MSSD, MSPD, VSD) as torch
functions on the caller's device, and the host-side recall tables (port of
self6dpp_tpu/ops/pose_errors.py).

Semantics of lib/pysixd/pose_error.py and the reference evaluator's recall
tables. Point sets are padded batches; adi_error takes the pairwise
|a|^2 + |b|^2 - 2 a.b form clamped at 0, as the JAX package does: near 0
its float32 rounding differs from a direct difference's, and the ADD-S
tables read those distances.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .geometry import project_pts, rot_angle_deg, transform_pts


def add_error(R_est, t_est, R_gt, t_gt, pts) -> Tensor:
    """Mean distance between correspondingly transformed model points.
    pts (..., N, 3). Returns (...,)."""
    pe = transform_pts(pts, R_est, t_est)
    pg = transform_pts(pts, R_gt, t_gt)
    return torch.linalg.vector_norm(pe - pg, dim=-1).mean(dim=-1)


def adi_error(R_est, t_est, R_gt, t_gt, pts) -> Tensor:
    """Mean nearest-neighbour distance (symmetric objects). pts (..., N, 3)."""
    pe = transform_pts(pts, R_est, t_est)
    pg = transform_pts(pts, R_gt, t_gt)
    sq_e = (pe * pe).sum(-1)
    sq_g = (pg * pg).sum(-1)
    cross = torch.einsum("...nd,...md->...nm", pg, pe)     # (..., Ngt, Nest)
    d2 = sq_g[..., :, None] + sq_e[..., None, :] - 2.0 * cross
    d2 = d2.clamp_min(0.0)
    return torch.sqrt(d2.amin(dim=-1)).mean(dim=-1)


def re_error(R_est, R_gt) -> Tensor:
    """Rotation geodesic error in degrees."""
    return rot_angle_deg(R_est, R_gt)


def te_error(t_est, t_gt) -> Tensor:
    """Translation error (the inputs' unit, metres for BOP)."""
    return torch.linalg.vector_norm(t_est - t_gt, dim=-1)


def proj_error(R_est, t_est, R_gt, t_gt, K, pts) -> Tensor:
    """Mean 2D reprojection distance in pixels."""
    p_est = project_pts(pts, K, R_est, t_est)
    p_gt = project_pts(pts, K, R_gt, t_gt)
    return torch.linalg.vector_norm(p_est - p_gt, dim=-1).mean(dim=-1)


def add_or_adi_error(R_est, t_est, R_gt, t_gt, pts, is_sym) -> Tensor:
    """ADD(-S): per element adi where is_sym (bool ...), else add."""
    a = add_error(R_est, t_est, R_gt, t_gt, pts)
    s = adi_error(R_est, t_est, R_gt, t_gt, pts)
    return torch.where(torch.as_tensor(is_sym, device=a.device), s, a)


def mssd_error(R_est, t_est, R_gt, t_gt, pts, sym_rots, sym_valid) -> Tensor:
    """Maximum symmetry-aware surface distance (BOP19): min over the valid
    symmetric GT poses of the max point distance. pts (...,N,3); sym_rots
    (...,S,3,3); sym_valid (...,S)."""
    pe = transform_pts(pts, R_est, t_est)                          # (...,N,3)
    R_sym = torch.einsum("...ij,...sjk->...sik", R_gt, sym_rots)   # (...,S,3,3)
    pg = torch.einsum("...sij,...nj->...sni", R_sym, pts) \
        + t_gt[..., None, None, :]
    d = torch.linalg.vector_norm(pe[..., None, :, :] - pg, dim=-1)  # (...,S,N)
    dmax = d.amax(dim=-1)
    return torch.where(sym_valid, dmax, torch.inf).amin(dim=-1)


def mspd_error(R_est, t_est, R_gt, t_gt, K, pts, sym_rots, sym_valid) -> Tensor:
    """Maximum symmetry-aware projection distance (BOP19)."""
    pe = project_pts(pts, K, R_est, t_est)                         # (...,N,2)
    R_sym = torch.einsum("...ij,...sjk->...sik", R_gt, sym_rots)
    lead = R_sym.shape[:-2]
    Kb = K[..., None, :, :].expand(*lead, 3, 3)
    tb = t_gt[..., None, :].expand(*lead, 3)
    pts_b = pts[..., None, :, :].expand(*lead, *pts.shape[-2:])
    pg = project_pts(pts_b, Kb, R_sym, tb)                         # (...,S,N,2)
    d = torch.linalg.vector_norm(pe[..., None, :, :] - pg, dim=-1)
    dmax = d.amax(dim=-1)
    return torch.where(sym_valid, dmax, torch.inf).amin(dim=-1)


def depth_to_dist(depth: Tensor, K: Tensor) -> Tensor:
    """Depth image -> distance image: each pixel's Z times the norm of its
    viewing ray. depth (..., H, W); K (..., 3, 3)."""
    H, W = depth.shape[-2], depth.shape[-1]
    fx = K[..., 0, 0][..., None, None]
    fy = K[..., 1, 1][..., None, None]
    cx = K[..., 0, 2][..., None, None]
    cy = K[..., 1, 2][..., None, None]
    xs = torch.arange(W, dtype=depth.dtype, device=depth.device)
    ys = torch.arange(H, dtype=depth.dtype, device=depth.device)
    xn = (xs[None, :] - cx) / fx
    yn = (ys[:, None] - cy) / fy
    ray = torch.sqrt(xn * xn + yn * yn + 1.0)
    return depth * ray


def vsd_error(depth_est: Tensor, depth_gt: Tensor, depth_obs: Tensor,
              taus=(0.05,), delta: float = 0.015, K: Tensor | None = None,
              diameter=None) -> Tensor:
    """BOP19 Visible Surface Discrepancy ('step' cost, visib_mode bop19).

    depth_* (..., H, W): rendered est/gt depths and the observed scene
    depth (zeros without a depth sensor: every rendered pixel then counts
    visible). K converts depths to distance images first; diameter
    normalises the distances (taus are then fractions of it). Returns
    (..., len(taus))."""
    if K is not None:
        depth_est = depth_to_dist(depth_est, K)
        depth_gt = depth_to_dist(depth_gt, K)
        depth_obs = depth_to_dist(depth_obs, K)
    visib_gt = (depth_gt > 0) & (
        ((depth_gt - depth_obs) <= delta) | (depth_obs == 0))
    ve = (depth_est > 0) & (
        ((depth_est - depth_obs) <= delta) | (depth_obs == 0))
    visib_est = ve | (visib_gt & (depth_est > 0))
    inter = visib_gt & visib_est
    union = visib_gt | visib_est
    union_n = union.sum(dim=(-2, -1))
    comp_n = union_n - inter.sum(dim=(-2, -1))
    dists = (depth_gt - depth_est).abs()
    if diameter is not None:
        dists = dists / torch.as_tensor(diameter, dtype=dists.dtype,
                                        device=dists.device)[..., None, None]
    errs = []
    for tau in taus:
        costs = ((dists >= tau) & inter).sum(dim=(-2, -1))
        e = (costs + comp_n) / union_n.clamp_min(1)
        errs.append(torch.where(union_n == 0, 1.0, e))
    return torch.stack(errs, dim=-1)


# ---------------------------------------------------------------------------
# BOP19 average-recall aggregation (host-side, numpy)
# ---------------------------------------------------------------------------

# correctness thresholds (eval_pose_results_more.py:58-70): VSD/MSSD
# theta in 0.05..0.50 step 0.05 (fractions of error / of diameter);
# MSPD theta in 5..50 px step 5 after the 640/im_width scaling
BOP19_TH = tuple(np.arange(0.05, 0.51, 0.05).tolist())
BOP19_MSPD_TH = tuple(range(5, 51, 5))


def bop19_average_recalls(vsd_errs: np.ndarray, mssd_errs: np.ndarray,
                          mspd_errs: np.ndarray, diameter: float,
                          im_width: int) -> dict[str, float]:
    """BOP19 AR scores for one object (SISO matching: one estimate per GT).

    vsd_errs (N, 10): per-tau VSD errors (taus = BOP19_TH fractions of the
    diameter, vsd_error with diameter normalization); mssd_errs (N,) metres
    — normalized by the diameter before thresholding
    (eval_calc_scores.py:70,249-253); mspd_errs (N,) px — scaled by
    640/im_width (:258). AR_x = mean recall over the threshold grid
    (× taus for VSD); bop19_ar = their mean (eval_pose_results_more.py:
    365-371). Returns percentages.
    """
    if len(mssd_errs) == 0:
        return {"ar_vsd": 0.0, "ar_mssd": 0.0, "ar_mspd": 0.0,
                "bop19_ar": 0.0}
    v = np.asarray(vsd_errs)
    ar_vsd = float(np.mean([
        (v[:, i] < th).mean() for i in range(v.shape[1])
        for th in BOP19_TH]))
    mssd_n = np.asarray(mssd_errs) / diameter
    ar_mssd = float(np.mean([(mssd_n < th).mean() for th in BOP19_TH]))
    mspd_n = np.asarray(mspd_errs) * 640.0 / im_width
    ar_mspd = float(np.mean([(mspd_n < th).mean() for th in BOP19_MSPD_TH]))
    return {
        "ar_vsd": 100.0 * ar_vsd,
        "ar_mssd": 100.0 * ar_mssd,
        "ar_mspd": 100.0 * ar_mspd,
        "bop19_ar": 100.0 * (ar_vsd + ar_mssd + ar_mspd) / 3.0,
    }


# ---------------------------------------------------------------------------
# recall tables (host-side, numpy) — evaluator protocol parity
# ---------------------------------------------------------------------------

def recall_table(
    add_errs: np.ndarray,
    re_errs: np.ndarray,
    te_errs: np.ndarray,
    proj_errs: np.ndarray,
    diameter: float,
    ad_threshs=(0.02, 0.05, 0.10),
    rete_threshs=(2.0, 5.0, 10.0),
    proj_threshs=(2.0, 5.0, 10.0),
) -> dict[str, float]:
    """Compute the reference evaluator's recall table.

    ad_k:   ADD(-S) < k% of diameter     (gdrn_custom_evaluator.py:605-736)
    rete_k: re < k deg AND te < k cm;  re_k / te_k: individual
    proj_k: mean reprojection < k px
    Returns percentages (0-100) plus mean errors.
    """
    out: dict[str, float] = {}
    n = max(len(add_errs), 1)
    for th in ad_threshs:
        out[f"ad_{int(th * 100)}"] = 100.0 * float(np.sum(add_errs < th * diameter)) / n
    for th in rete_threshs:
        k = int(th)
        out[f"rete_{k}"] = 100.0 * float(
            np.sum((re_errs < th) & (te_errs < th / 100.0))) / n
        out[f"re_{k}"] = 100.0 * float(np.sum(re_errs < th)) / n
        out[f"te_{k}"] = 100.0 * float(np.sum(te_errs < th / 100.0)) / n
    for th in proj_threshs:
        out[f"proj_{int(th)}"] = 100.0 * float(np.sum(proj_errs < th)) / n
    out["re"] = float(np.mean(re_errs)) if len(re_errs) else 0.0
    out["te"] = float(np.mean(te_errs)) if len(te_errs) else 0.0
    return out


def auc_add(errs: np.ndarray, max_thresh: float = 0.10, step: float = 0.001) -> float:
    """Area-under-curve of ADD(-S) recall vs threshold, YCB-V protocol.

    Reference: lib/pysixd scripts use VOCap-style AUC up to 10cm.
    Returns percentage (0-100).
    """
    if len(errs) == 0:
        return 0.0
    threshs = np.arange(0.0, max_thresh + 1e-9, step)
    recalls = np.array([np.mean(errs < t) for t in threshs])
    trapezoid = getattr(np, "trapezoid", None) or np.trapz
    return 100.0 * float(trapezoid(recalls, threshs) / max_thresh)
