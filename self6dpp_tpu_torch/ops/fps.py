"""Farthest-point sampling and region labels on the host (port of
self6dpp_tpu/ops/fps.py: fps_numpy, farthest_point_sampling, fps_points,
xyz_to_region, xyz_to_region_batch): the FPS keypoints of the
vector-field labels, the region centres and PM points of the loader's
object models, and the region label of each crop pixel.

farthest_point_sampling runs the host routine csrc/fps.c (one thread;
built at first use by kernels/build.py::load_host, called through
ctypes). It returns fps_numpy's indices bit for bit on every input: ties
go to the lowest index. The JAX package's native FPS
does not (its centroid is summed in double and its threads' merge takes
whichever thread comes first), so on a symmetric mesh its indices change
from run to run; the numpy function is the semantics both packages
document. fps_numpy stays as the plain twin, for tests and for a caller
that asks for it; a failed build raises and falls back to nothing.
"""

from __future__ import annotations

import ctypes

import numpy as np

_lib = None


def _native():
    """csrc/fps.c's library, built at first use, argtypes set once."""
    global _lib
    if _lib is None:
        from ..kernels.build import load_host
        lib = load_host("fps")
        lib.farthest_point_sampling.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.farthest_point_sampling.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    """Indices (k,) of FPS-selected points, by the native routine: equal to
    fps_numpy's bit for bit."""
    pts = np.ascontiguousarray(points, dtype=np.float32).reshape(-1, 3)
    if len(pts) == 0 and k > 0:
        raise ValueError("farthest_point_sampling: no points")
    out = np.empty(max(k, 0), dtype=np.int32)
    rc = _native().farthest_point_sampling(
        pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.c_int64(len(pts)), ctypes.c_int64(k),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(1 if init_center else 0))
    if rc != 0:
        raise MemoryError(f"fps: no room for the table of {len(pts)} points")
    return out


def fps_points(points: np.ndarray, k: int, init_center: bool = True) -> np.ndarray:
    """The k FPS-selected points (k, 3)."""
    return np.asarray(points)[farthest_point_sampling(points, k, init_center)]


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
