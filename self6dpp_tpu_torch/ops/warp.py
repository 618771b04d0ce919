"""Batched 2-D affine warps of NHWC tensors (port of
self6dpp_tpu/ops/warp.py): the geo mode's pose-variated augmentation,
applied alike to the student's ROI image and the teacher's label maps.

Coordinates are normalised to [-1, 1] with the image centre at the origin,
so one matrix warps tensors of any resolution. The warp is a gather of the
four neighbours (indices clipped to the image) blended bilinearly, or of the
nearest one; a sample whose source lies more than half a pixel outside the
image is 0.
"""

from __future__ import annotations

import math

import torch
from torch import Tensor


def make_affine(rot_rad: Tensor, scale: Tensor, trans: Tensor) -> Tensor:
    """Forward affine (B,2,3): p_dst = R(rot) diag(scale) p_src + trans."""
    c, s = torch.cos(rot_rad), torch.sin(rot_rad)
    sx, sy = scale[:, 0], scale[:, 1]
    return torch.stack([
        torch.stack([c * sx, -s * sy, trans[:, 0]], dim=-1),
        torch.stack([s * sx, c * sy, trans[:, 1]], dim=-1)], dim=1)


def invert_affine(m: Tensor) -> Tensor:
    """Inverse of a (B,2,3) affine (its 2x2 block invertible)."""
    a, b, tx = m[:, 0, 0], m[:, 0, 1], m[:, 0, 2]
    c, d, ty = m[:, 1, 0], m[:, 1, 1], m[:, 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    return torch.stack([
        torch.stack([ia, ib, -(ia * tx + ib * ty)], dim=-1),
        torch.stack([ic, id_, -(ic * tx + id_ * ty)], dim=-1)], dim=1)


def affine_warp(img: Tensor, mats: Tensor, mode: str = "bilinear") -> Tensor:
    """Warp img (B,H,W,C) by per-image dst -> src affines (B,2,3) in
    normalised centre-origin coordinates; mode 'bilinear' or 'nearest'."""
    if mode not in ("bilinear", "nearest"):
        raise ValueError(f"unknown warp mode: {mode!r}")
    B, H, W, C = img.shape
    dev = img.device
    u = (torch.arange(W, dtype=torch.float32, device=dev) + 0.5) / W * 2.0 - 1.0
    v = (torch.arange(H, dtype=torch.float32, device=dev) + 0.5) / H * 2.0 - 1.0
    m = mats.float()[:, :, :, None, None]                   # (B,2,3,1,1)
    src = m[:, :, 0] * u[None, :] + m[:, :, 1] * v[:, None] + m[:, :, 2]
    x = (src[:, 0] + 1.0) * 0.5 * W - 0.5                   # (B,H,W)
    y = (src[:, 1] + 1.0) * 0.5 * H - 0.5
    flat = img.reshape(B, H * W, C)

    def gather(yy: Tensor, xx: Tensor) -> Tensor:
        idx = yy.clamp(0, H - 1) * W + xx.clamp(0, W - 1)
        return torch.gather(flat, 1, idx.reshape(B, -1, 1).expand(-1, -1, C)
                            ).reshape(B, H, W, C)

    inb = (x >= -0.5) & (x <= W - 0.5) & (y >= -0.5) & (y <= H - 0.5)
    if mode == "nearest":
        out = gather(torch.round(y).long(), torch.round(x).long())
    else:
        x0f, y0f = torch.floor(x), torch.floor(y)
        x0, y0 = x0f.long(), y0f.long()
        fx = (x - x0f)[..., None]
        fy = (y - y0f)[..., None]
        out = ((1 - fy) * ((1 - fx) * gather(y0, x0) + fx * gather(y0, x0 + 1))
               + fy * ((1 - fx) * gather(y0 + 1, x0)
                       + fx * gather(y0 + 1, x0 + 1)))
    return out * inb[..., None].to(img.dtype)


def sample_pose_variated_affines(
        generator: torch.Generator, batch: int, *, rot_deg: float = 180.0,
        zoom: tuple[float, float] = (0.75, 1.25),
        trans: tuple[float, float] = (-0.1, 0.1),
        crop_percent: float = 0.1, device=None) -> Tensor:
    """Per-image dst -> src matrices (B,2,3) of the pose-variated warp:
    rotation within ±rot_deg, anisotropic zoom, translation as a share of
    the crop, and the crop-and-pad folded in as a shared zoom factor; drawn
    from `generator` (on the CPU), returned on `device`."""
    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator) * (hi - lo) + lo
    rot = uniform((batch,), -rot_deg, rot_deg) * (math.pi / 180.0)
    sc = uniform((batch, 2), *zoom)
    crop = uniform((batch, 1), 1.0 - crop_percent, 1.0 + crop_percent)
    tr = uniform((batch, 2), *trans)
    return invert_affine(make_affine(rot, sc * crop, 2.0 * tr)).to(device)
