"""Differentiable pose decoding from network outputs (port of
self6dpp_tpu/ops/pose_decode.py): the GDRN decoders (centroid_z,
centroid_z_abs, trans) and the DeepIM delta-pose update."""

from __future__ import annotations

import torch
from torch import Tensor

from .geometry import allo_to_ego_mat, quat_to_mat, rot6d_to_mat


def rot_rep_to_mat(pred_rot: Tensor, rot_type: str) -> Tensor:
    """Network rotation output -> rotation matrix. rot_type in
    {allo_rot6d, ego_rot6d, allo_quat, ego_quat}; allo/ego is resolved by
    the pose decoder."""
    if rot_type.endswith("rot6d"):
        return rot6d_to_mat(pred_rot)
    if rot_type.endswith("quat"):
        return quat_to_mat(pred_rot)
    raise ValueError(f"unknown rot_type: {rot_type}")


def pose_from_centroid_z(
    pred_rot_m: Tensor,        # (B, 3, 3) allocentric (or ego) rotation
    pred_centroid: Tensor,     # (B, 2) centroid offset rel. to roi center / wh
    pred_z: Tensor,            # (B, 1) z (REL: ratio-normalized, ABS: metres)
    roi_cam: Tensor,           # (B, 3, 3) intrinsics
    roi_center: Tensor,        # (B, 2) roi center in px
    resize_ratio: Tensor,      # (B,) output_res / scale
    roi_wh: Tensor,            # (B, 2) roi width/height in px
    eps: float = 1e-4,
    is_allo: bool = True,
    z_type: str = "REL",
) -> tuple[Tensor, Tensor]:
    """Egocentric (R, t) from SITE predictions
    (core/gdrn_modeling/models/pose_from_pred_centroid_z.py):
      c = centroid * wh + roi_center;  z = z_rel * resize_ratio (REL)
      t = ((cx - px) z / fx, (cy - py) z / fy, z);  R_ego = R(allo->ego|t) R
    """
    c = pred_centroid * roi_wh + roi_center
    if z_type == "ABS":
        z = pred_z[:, 0]
    elif z_type == "REL":
        z = pred_z[:, 0] * resize_ratio
    else:
        raise ValueError(f"unknown z_type: {z_type}")
    fx, fy = roi_cam[:, 0, 0], roi_cam[:, 1, 1]
    px, py = roi_cam[:, 0, 2], roi_cam[:, 1, 2]
    trans = torch.stack([z * (c[:, 0] - px) / fx, z * (c[:, 1] - py) / fy, z],
                        dim=-1)
    rot = allo_to_ego_mat(trans, pred_rot_m, eps=eps) if is_allo else pred_rot_m
    return rot, trans


def pose_from_centroid_z_abs(
    pred_rot_m: Tensor,        # (B, 3, 3)
    pred_centroid: Tensor,     # (B, 2) absolute pixel centroid
    pred_z: Tensor,            # (B, 1) absolute z
    roi_cam: Tensor,           # (B, 3, 3)
    eps: float = 1e-4,
    is_allo: bool = True,
) -> tuple[Tensor, Tensor]:
    """The absolute-centroid decoder (pose_from_pred_centroid_z_abs.py):
    t = ((cx - px) z / fx, (cy - py) z / fy, z) from the predicted pixel
    centroid and depth."""
    z = pred_z[:, 0]
    fx, fy = roi_cam[:, 0, 0], roi_cam[:, 1, 1]
    px, py = roi_cam[:, 0, 2], roi_cam[:, 1, 2]
    trans = torch.stack([z * (pred_centroid[:, 0] - px) / fx,
                         z * (pred_centroid[:, 1] - py) / fy, z], dim=-1)
    rot = allo_to_ego_mat(trans, pred_rot_m, eps=eps) if is_allo else pred_rot_m
    return rot, trans


def pose_from_trans(pred_rot_m: Tensor, pred_trans: Tensor, eps: float = 1e-4,
                    is_allo: bool = True) -> tuple[Tensor, Tensor]:
    """The direct-translation decoder (pose_from_pred.py): the head's
    output is the translation."""
    rot = allo_to_ego_mat(pred_trans, pred_rot_m, eps=eps) if is_allo \
        else pred_rot_m
    return rot, pred_trans


def pose_from_delta_init(
    rot_deltas: Tensor,        # (B, 3, 3)
    trans_deltas: Tensor,      # (B, 3) vx vy vz in image space
    rot_inits: Tensor,         # (B, 3, 3)
    trans_inits: Tensor,       # (B, 3)
    Ks: Tensor | None = None,  # (B, 3, 3) zoomed intrinsics
    K_aware: bool = True,
    delta_T_space: str = "image",
    delta_T_weight: float = 1.0,
    delta_z_style: str = "cosypose",
    eps: float = 1e-4,
    is_allo: bool = False,
) -> tuple[Tensor, Tensor]:
    """DeepIM/CosyPose delta-pose update
    (core/deepim/models/pose_from_delta_init.py:15-88).
      image space: ztgt = vz * zsrc (cosypose) or zsrc / exp(vz) (deepim);
                   xy_tgt = ztgt * (vxvy / fxfy + xy_src / zsrc)
      rotation:    R_tgt = R_delta @ R_init (camera frame)
    """
    trans_deltas = trans_deltas * delta_T_weight
    if delta_T_space == "image":
        # keep the object in front of the camera: an untrained cosypose vz
        # can be <= 0, and the next iteration would divide by ~0
        zsrc = trans_inits[:, 2:3].clamp_min(eps)
        vz = trans_deltas[:, 2:3]
        if delta_z_style == "cosypose":
            ztgt = (vz * zsrc).clamp_min(eps)
        else:  # deepim: vz = log(zsrc/ztgt)
            ztgt = zsrc / torch.exp(vz)
        vxvy = trans_deltas[:, :2]
        if K_aware:
            if Ks is None:
                raise ValueError("K_aware decoding needs Ks")
            fxfy = torch.stack([Ks[:, 0, 0], Ks[:, 1, 1]], dim=1)
        else:
            fxfy = torch.ones_like(vxvy)
        xy_tgt = ztgt * (vxvy / fxfy + trans_inits[:, :2] / zsrc)
        trans_tgts = torch.cat([xy_tgt, ztgt], dim=-1)
    elif delta_T_space == "3D":
        trans_tgts = trans_inits + trans_deltas
        trans_tgts = torch.cat(
            [trans_tgts[:, :2], trans_tgts[:, 2:3].clamp_min(eps)], dim=-1)
    else:
        raise ValueError(f"unknown delta_T_space: {delta_T_space}")

    ego_rot_deltas = (allo_to_ego_mat(trans_tgts, rot_deltas, eps=eps)
                      if is_allo else rot_deltas)
    return ego_rot_deltas @ rot_inits, trans_tgts
