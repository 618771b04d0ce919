"""Farthest-point sampling and region labels on the host (port of the
numpy path of self6dpp_tpu/ops/fps.py: fps_numpy, farthest_point_sampling,
fps_points, xyz_to_region, xyz_to_region_batch): the FPS keypoints of the
vector-field labels, the region centres and PM points of the loader's
object models, and the region label of each crop pixel."""

from __future__ import annotations

import numpy as np


def fps_numpy(points: np.ndarray, k: int, init_center: bool = True) -> np.ndarray:
    """Greedy FPS: k indices, starting from the point nearest the centroid
    (or point 0), then each time the point farthest from those chosen."""
    n = len(points)
    pts = np.ascontiguousarray(points, dtype=np.float32)
    if init_center:
        c = pts.mean(axis=0)
        cur = int(np.argmin(((pts - c) ** 2).sum(axis=1)))
    else:
        cur = 0
    mind = np.full(n, np.inf, dtype=np.float32)
    idx = np.empty(k, dtype=np.int32)
    for j in range(k):
        idx[j] = cur
        d = ((pts - pts[cur]) ** 2).sum(axis=1)
        np.minimum(mind, d, out=mind)
        cur = int(np.argmax(mind))
    return idx


def farthest_point_sampling(points: np.ndarray, k: int,
                            init_center: bool = True) -> np.ndarray:
    """Indices (k,) of FPS-selected points: fps_numpy (the JAX package's
    native C++ FPS is not ported; its numpy path is this one)."""
    return fps_numpy(points, k, init_center)


def fps_points(points: np.ndarray, k: int, init_center: bool = True) -> np.ndarray:
    """The k FPS-selected points (k, 3)."""
    return np.asarray(points)[fps_numpy(points, k, init_center)]


def xyz_to_region(xyz: np.ndarray, fps_pts: np.ndarray,
                  mask: np.ndarray | None = None) -> np.ndarray:
    """Each (valid) pixel's object-frame xyz to its nearest FPS centre,
    1-based (0 = background): argmin_k |c_k|^2 - 2 x.c_k."""
    h, w = xyz.shape[:2]
    flat = xyz.reshape(-1, 3).astype(np.float32)
    fps_pts = np.asarray(fps_pts, np.float32)
    d = flat @ (-2.0 * fps_pts.T)
    d += (fps_pts * fps_pts).sum(-1)[None, :]
    region = d.argmin(axis=1).astype(np.int32).reshape(h, w) + 1
    if mask is not None:
        region = region * (mask > 0)
    return region


def xyz_to_region_batch(xyz: np.ndarray, fps_pts: np.ndarray,
                        mask: np.ndarray | None = None) -> np.ndarray:
    """xyz_to_region over a batch: xyz (B,h,w,3), fps_pts (B,K,3), mask
    (B,h,w), one batched matmul."""
    B, h, w, _ = xyz.shape
    flat = xyz.reshape(B, -1, 3).astype(np.float32)
    fps_pts = np.asarray(fps_pts, np.float32)
    d = flat @ (-2.0 * fps_pts.transpose(0, 2, 1))
    d += (fps_pts * fps_pts).sum(-1)[:, None, :]
    region = d.argmin(axis=2).astype(np.int32).reshape(B, h, w) + 1
    if mask is not None:
        region = region * (mask > 0)
    return region
