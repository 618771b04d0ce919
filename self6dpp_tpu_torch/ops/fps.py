"""Farthest-point sampling on the host (port of the numpy path of
self6dpp_tpu/ops/fps.py: fps_numpy, fps_points), for the FPS keypoints of
the vector-field labels (the stage-II batch's mesh_fps)."""

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


def fps_points(points: np.ndarray, k: int, init_center: bool = True) -> np.ndarray:
    """The k FPS-selected points (k, 3)."""
    return np.asarray(points)[fps_numpy(points, k, init_center)]
