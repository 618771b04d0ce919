"""Batched rotation ops and depth backprojection (port of
self6dpp_tpu/ops/geometry.py).

Quaternions are (w, x, y, z); every function is batched over leading axes.
"""

from __future__ import annotations

import torch
from torch import Tensor


def quat_normalize(q: Tensor, eps: float = 1e-8) -> Tensor:
    return q / (torch.linalg.norm(q, dim=-1, keepdim=True) + eps)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product of two (..., 4) quaternions."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_to_mat(q: Tensor, eps: float = 1e-8) -> Tensor:
    """(..., 4) unnormalized quaternion -> (..., 3, 3) rotation matrix."""
    q = quat_normalize(q, eps)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: Tensor, eps: float = 1e-9) -> Tensor:
    """(..., 3, 3) rotation -> (..., 4) unit quaternion with w >= 0: the
    four Shepperd candidates, the one of the largest diagonal combination
    taken, normalised."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    qx = torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], dim=-1)
    qy = torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22,
                      m12 + m21], dim=-1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1.0 - m00 - m11 + m22], dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)          # (..., 4, 4)
    mags = torch.stack([1.0 + tr, 1.0 + m00 - m11 - m22,
                        1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22], dim=-1)
    idx = mags.argmax(-1)[..., None, None].expand(*mags.shape[:-1], 1, 4)
    q = quat_normalize(torch.gather(cands, -2, idx)[..., 0, :], eps)
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def axangle_to_quat(axis: Tensor, angle: Tensor, eps: float = 1e-8
                    ) -> Tensor:
    """axis (..., 3) (any length), angle (...,) -> quaternion (..., 4)."""
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + eps)
    half = angle[..., None] / 2.0
    return torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)


def axangle_to_mat(axis: Tensor, angle: Tensor, eps: float = 1e-8
                   ) -> Tensor:
    return quat_to_mat(axangle_to_quat(axis, angle, eps))


def rot6d_to_mat(d6: Tensor) -> Tensor:
    """(..., 6) -> (..., 3, 3); columns = Gram-Schmidt of the two 3-vectors
    (reference core/utils/rot_reps.py:34-56).

    Clamped-norm division keeps tiny inputs exact unit vectors; exact zeros
    fall back to the canonical basis so the output is always a rotation.
    """
    x_raw, y_raw = d6[..., 0:3], d6[..., 3:6]
    e1 = torch.zeros_like(x_raw)
    e1[..., 0] = 1.0
    e2 = torch.zeros_like(y_raw)
    e2[..., 1] = 1.0
    xn = torch.linalg.norm(x_raw, dim=-1, keepdim=True)
    x_raw = torch.where(xn < 1e-20, e1, x_raw)
    x = x_raw / torch.linalg.norm(x_raw, dim=-1, keepdim=True).clamp_min(1e-12)
    z = torch.linalg.cross(x, y_raw)
    zn = torch.linalg.norm(z, dim=-1, keepdim=True)
    z = torch.where(zn < 1e-20,
                    torch.linalg.cross(x, e2) + torch.linalg.cross(x, e1), z)
    z = z / torch.linalg.norm(z, dim=-1, keepdim=True).clamp_min(1e-12)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=-1)  # columns


def mat_to_rot6d(m: Tensor) -> Tensor:
    """(..., 3, 3) -> (..., 6): the first two columns."""
    return torch.cat([m[..., :, 0], m[..., :, 1]], dim=-1)


def allo_to_ego_mat(translation: Tensor, rot_allo: Tensor,
                    eps: float = 1e-4) -> Tensor:
    """Rotate an allocentric rotation by the rotation carrying the optical
    axis (0,0,1) onto the object-centroid ray (core/utils/utils.py:200-231).
    translation (..., 3); rot_allo (..., 3, 3)."""
    obj_ray = translation / (
        torch.linalg.norm(translation, dim=-1, keepdim=True) + eps)
    angle = torch.arccos(obj_ray[..., 2].clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    # axis = cam_ray x obj_ray with cam_ray = (0,0,1): (-oy, ox, 0)
    axis = torch.stack([-obj_ray[..., 1], obj_ray[..., 0],
                        torch.zeros_like(obj_ray[..., 0])], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + eps)
    q = torch.cat([torch.cos(angle / 2.0)[..., None],
                   axis * torch.sin(angle / 2.0)[..., None]], dim=-1)
    return quat_to_mat(q) @ rot_allo


def ego_to_allo_mat(translation: Tensor, rot_ego: Tensor,
                    eps: float = 1e-4) -> Tensor:
    """The inverse of allo_to_ego_mat (core/utils/utils.py:89-132)."""
    obj_ray = translation / (
        torch.linalg.norm(translation, dim=-1, keepdim=True) + eps)
    angle = torch.arccos(obj_ray[..., 2].clamp(-1.0 + 1e-7, 1.0 - 1e-7))
    axis = torch.stack([-obj_ray[..., 1], obj_ray[..., 0],
                        torch.zeros_like(obj_ray[..., 0])], dim=-1)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + eps)
    q = torch.cat([torch.cos(-angle / 2.0)[..., None],
                   axis * torch.sin(-angle / 2.0)[..., None]], dim=-1)
    return quat_to_mat(q) @ rot_ego


def transform_pts(pts: Tensor, R: Tensor, t: Tensor | None = None) -> Tensor:
    """pts (..., N, 3), R (..., 3, 3), t (..., 3) -> (..., N, 3)."""
    out = torch.einsum("...ij,...nj->...ni", R, pts)
    if t is not None:
        out = out + t[..., None, :]
    return out


def project_pts(pts: Tensor, K: Tensor, R: Tensor, t: Tensor,
                eps: float = 1e-8) -> Tensor:
    """Model points (..., N, 3) to pixels (..., N, 2) under K, R (..., 3, 3)
    and t (..., 3)."""
    cam = transform_pts(pts, R, t)
    z = cam[..., 2:3]
    fx = K[..., 0, 0][..., None, None]
    fy = K[..., 1, 1][..., None, None]
    px = K[..., 0, 2][..., None, None]
    py = K[..., 1, 2][..., None, None]
    u = fx * cam[..., 0:1] / (z + eps) + px
    v = fy * cam[..., 1:2] / (z + eps) + py
    return torch.cat([u, v], dim=-1)


def compute_vf(fps_points: Tensor, K: Tensor, R: Tensor, t: Tensor,
               roi_center: Tensor, roi_scale: Tensor, out_res: int,
               mask: Tensor | None = None) -> Tensor:
    """Keypoint vector field in the ROI crop frame: per pixel of the
    out_res² crop (centred at roi_center, side roi_scale, in image pixels)
    the unit 2-D direction to each of the f projected keypoints.
    fps_points (B,f,3), K, R (B,3,3), t (B,3), roi_center (B,2), roi_scale
    (B,), mask (B,o,o) or None -> (B,o,o,2f) as [u0,v0,u1,v1,...]."""
    kp = project_pts(fps_points, K, R, t)                   # (B,f,2)
    x0 = roi_center[:, 0] - roi_scale / 2
    y0 = roi_center[:, 1] - roi_scale / 2
    lin = (torch.arange(out_res, dtype=kp.dtype, device=kp.device) + 0.5) \
        / out_res
    px = x0[:, None] + roi_scale[:, None] * lin              # (B,o)
    py = y0[:, None] + roi_scale[:, None] * lin
    b, o = kp.shape[0], out_res
    grid = torch.stack([px[:, None, :].expand(b, o, o),
                        py[:, :, None].expand(b, o, o)], dim=-1)
    vf = kp[:, None, None] - grid[:, :, :, None, :]          # (B,o,o,f,2)
    vf = vf / torch.linalg.vector_norm(vf, dim=-1, keepdim=True).clamp_min(1e-8)
    vf = vf.reshape(b, o, o, -1)
    return vf if mask is None else vf * mask[..., None]


def backproject_depth(depth: Tensor, K: Tensor) -> Tensor:
    """depth (..., H, W), K (..., 3, 3) -> camera-space xyz (..., H, W, 3),
    on a pixel grid of u (column) and v (row) in the depth's dtype."""
    H, W = depth.shape[-2], depth.shape[-1]
    vs, us = torch.meshgrid(
        torch.arange(H, dtype=depth.dtype, device=depth.device),
        torch.arange(W, dtype=depth.dtype, device=depth.device), indexing="ij")
    fx = K[..., 0, 0][..., None, None]
    fy = K[..., 1, 1][..., None, None]
    px = K[..., 0, 2][..., None, None]
    py = K[..., 1, 2][..., None, None]
    x = (us - px) * depth / fx
    y = (vs - py) * depth / fy
    return torch.stack([x, y, depth], dim=-1)


def rot_angle_deg(R1: Tensor, R2: Tensor) -> Tensor:
    """Geodesic angle in degrees between (..., 3, 3) rotations."""
    m = R1 @ R2.transpose(-1, -2)
    tr = torch.diagonal(m, dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    return torch.rad2deg(torch.arccos(cos))


def quat_from_two_mats_angle(R1: Tensor, R2: Tensor) -> Tensor:
    """rot_angle_deg under the JAX package's other name."""
    return rot_angle_deg(R1, R2)
