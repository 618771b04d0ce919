"""Pose-conditioned crop/zoom ops for DeepIM refinement (port of
self6dpp_tpu/ops/zoom.py).

  deepim_boxes      crop region from rendered/observed boxes
                    (core/utils/zoom_utils.py:6-79)
  zoom_K            intrinsics of a crop resized to the network input
  crop_resize       ROIAlign(aligned=True) zoom as an explicit four-tap
                    bilinear gather with zero padding
"""

from __future__ import annotations

import torch
from torch import Tensor


def deepim_boxes(ren_boxes: Tensor, ren_centers_2d: Tensor,
                 obs_boxes: Tensor | None = None, lamb: float = 1.4,
                 out_hw: tuple[int, int] = (480, 640)) -> tuple[Tensor, Tensor]:
    """Crop of the output aspect covering the ren (and obs) boxes, centred
    on the rendered object centre. Returns (boxes x1y1x2y2 (N,4),
    resize ratios (N,2) = out / crop)."""
    ren_cx, ren_cy = ren_centers_2d[:, 0], ren_centers_2d[:, 1]
    out_h, out_w = out_hw
    aspect = out_w / out_h

    xs = [(ren_cx - ren_boxes[:, 0]).abs(), (ren_boxes[:, 2] - ren_cx).abs()]
    ys = [(ren_cy - ren_boxes[:, 1]).abs(), (ren_boxes[:, 3] - ren_cy).abs()]
    if obs_boxes is not None:
        xs += [(ren_cx - obs_boxes[:, 0]).abs(), (obs_boxes[:, 2] - ren_cx).abs()]
        ys += [(ren_cy - obs_boxes[:, 1]).abs(), (obs_boxes[:, 3] - ren_cy).abs()]
    xdist = torch.stack(xs, dim=1).amax(dim=1)
    ydist = torch.stack(ys, dim=1).amax(dim=1)

    crop_h = torch.maximum(xdist / aspect, ydist).clamp_min(1.0) * 2.0 * lamb
    crop_w = crop_h * aspect
    boxes = torch.stack([ren_cx - crop_w / 2, ren_cy - crop_h / 2,
                         ren_cx + crop_w / 2, ren_cy + crop_h / 2], dim=1)
    ratios = torch.stack([out_w / crop_w, out_h / crop_h], dim=1)
    return boxes, ratios


def zoom_K(K: Tensor, boxes: Tensor, out_hw: tuple[int, int]) -> Tensor:
    """Intrinsics for crop `boxes` resized to out_hw (get_K_crop_resize).
    K (N,3,3) or (3,3)."""
    out_h, out_w = out_hw
    if K.ndim == 2:
        K = K.expand(boxes.shape[0], 3, 3)
    sx = out_w / (boxes[:, 2] - boxes[:, 0])
    sy = out_h / (boxes[:, 3] - boxes[:, 1])
    fx = K[:, 0, 0] * sx
    fy = K[:, 1, 1] * sy
    px = (K[:, 0, 2] - boxes[:, 0]) * sx
    py = (K[:, 1, 2] - boxes[:, 1]) * sy
    z = torch.zeros_like(fx)
    o = torch.ones_like(fx)
    return torch.stack([
        torch.stack([fx, z, px], dim=1),
        torch.stack([z, fy, py], dim=1),
        torch.stack([z, z, o], dim=1),
    ], dim=1)


def crop_resize(imgs: Tensor, boxes: Tensor, out_h: int, out_w: int) -> Tensor:
    """Batched bilinear crop+resize, ROIAlign(aligned=True, ratio=0) parity.

    imgs (B, H, W, C); boxes (B, 4) x1y1x2y2 in pixels (box i crops image i).
    Output pixel j samples x1 + (j + 0.5) * w_box / out_w - 0.5.
    """
    x1, y1, x2, y2 = boxes.unbind(1)
    ju = torch.arange(out_w, device=imgs.device, dtype=imgs.dtype)
    jv = torch.arange(out_h, device=imgs.device, dtype=imgs.dtype)
    us = x1[:, None] + (ju + 0.5)[None, :] * (x2 - x1)[:, None] / out_w - 0.5
    vs = y1[:, None] + (jv + 0.5)[None, :] * (y2 - y1)[:, None] / out_h - 0.5
    B = imgs.shape[0]
    return _bilinear_sample(imgs, us[:, None, :].expand(B, out_h, out_w),
                            vs[:, :, None].expand(B, out_h, out_w))


def _bilinear_sample(img: Tensor, us: Tensor, vs: Tensor,
                     index: Tensor | None = None) -> Tensor:
    """img (N, H, W, C), us/vs (B, h, w) pixel coords -> (B, h, w, C): row
    b samples image index[b] (default b, N = B) with one gather from the
    flattened images, so that an image read by many rows (a class's
    texture) is not copied per row; taps outside the image read zero."""
    N, H, W, C = img.shape
    B = us.shape[0]
    index = torch.arange(B, device=us.device) if index is None else index
    u0 = torch.floor(us)
    v0 = torch.floor(vs)
    du = (us - u0)[..., None]
    dv = (vs - v0)[..., None]
    u0i = u0.long()
    v0i = v0.long()
    flat = img.reshape(N * H * W, C)
    base = (index.long() * (H * W)).view(B, *([1] * (us.ndim - 1)))

    def at(vi, ui):
        inb = (vi >= 0) & (vi < H) & (ui >= 0) & (ui < W)
        idx = base + vi.clamp(0, H - 1) * W + ui.clamp(0, W - 1)
        return flat[idx] * inb[..., None]

    top = at(v0i, u0i) * (1 - du) + at(v0i, u0i + 1) * du
    bot = at(v0i + 1, u0i) * (1 - du) + at(v0i + 1, u0i + 1) * du
    return top * (1 - dv) + bot * dv


def bboxes_from_pose(points: Tensor, K: Tensor, R: Tensor, t: Tensor) -> Tensor:
    """Projected 2D bbox of model points. points (B,N,3) -> (B,4) x1y1x2y2."""
    cam = torch.einsum("bij,bnj->bni", R, points) + t[:, None, :]
    z = cam[..., 2].clamp_min(1e-6)
    u = K[..., 0, 0][..., None] * cam[..., 0] / z + K[..., 0, 2][..., None]
    v = K[..., 1, 1][..., None] * cam[..., 1] / z + K[..., 1, 2][..., None]
    return torch.stack([u.amin(1), v.amin(1), u.amax(1), v.amax(1)], dim=1)


def centers_2d_from_pose(K: Tensor, R: Tensor, t: Tensor) -> Tensor:
    z = t[:, 2].clamp_min(1e-6)
    u = K[..., 0, 0] * t[:, 0] / z + K[..., 0, 2]
    v = K[..., 1, 1] * t[:, 1] / z + K[..., 1, 2]
    return torch.stack([u, v], dim=1)
