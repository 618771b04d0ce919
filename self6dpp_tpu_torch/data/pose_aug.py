"""Pose, depth and intrinsics augmentation on the host (port of
self6dpp_tpu/data/pose_aug.py; reference core/utils/pose_aug.py and
core/utils/depth_aug.py). numpy with a numpy.random.Generator: from the
same generator state each function draws what the JAX package's does."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def perturb_poses(R: np.ndarray, t: np.ndarray, rng: np.random.Generator,
                  rot_std_deg: float = 15.0,
                  trans_std: tuple[float, float, float] = (0.01, 0.01, 0.05),
                  rot_max_deg: float = 45.0,
                  trans_max: float = 0.25) -> tuple[np.ndarray, np.ndarray]:
    """Gaussian pose noise, clipped (the gt_noise init poses of
    configs/_base_/deepim_base.py:38-62): xyz Euler angles in degrees on
    the left of R (N, 3, 3), a shift of t (N, 3). float32 out."""
    n = len(R)
    ang = np.clip(rng.normal(0, rot_std_deg, (n, 3)),
                  -rot_max_deg, rot_max_deg)
    dR = Rotation.from_euler("xyz", ang, degrees=True).as_matrix()
    dt = np.clip(rng.normal(0, trans_std, (n, 3)), -trans_max, trans_max)
    return (dR @ R).astype(np.float32), (t + dt).astype(np.float32)


def uniform_z_flip_aug(R: np.ndarray, rng: np.random.Generator,
                       prob: float = 0.5) -> np.ndarray:
    """Each rotation turned 180° about its z axis with probability prob
    (one draw per rotation, in order)."""
    out = R.copy()
    flip = np.diag([-1.0, -1.0, 1.0]).astype(R.dtype)
    for i in range(len(R)):
        if rng.random() < prob:
            out[i] = R[i] @ flip
    return out


def aug_depth(depth: np.ndarray, rng: np.random.Generator,
              noise_std: float = 0.003, dropout_prob: float = 0.005,
              quantize_mm: float = 1.0) -> np.ndarray:
    """Sensor artefacts on a depth map: Gaussian noise on the valid pixels,
    random dropout to 0, quantisation to quantize_mm millimetres."""
    d = depth.copy()
    valid = d > 0
    d = d + rng.normal(0, noise_std, d.shape) * valid
    drop = rng.random(d.shape) < dropout_prob
    d = np.where(drop, 0.0, d)
    if quantize_mm > 0:
        q = quantize_mm / 1000.0
        d = np.round(d / q) * q
    return np.maximum(d, 0.0).astype(np.float32)


def jitter_K(K: np.ndarray, rng: np.random.Generator,
             f_ratio: float = 0.0, c_px: float = 0.0) -> np.ndarray:
    """Intrinsics jitter: both focal lengths scaled by one factor in
    1 ± f_ratio, the principal point shifted by up to c_px."""
    out = K.copy()
    if f_ratio > 0:
        s = 1.0 + rng.uniform(-f_ratio, f_ratio)
        out[0, 0] *= s
        out[1, 1] *= s
    if c_px > 0:
        out[0, 2] += rng.uniform(-c_px, c_px)
        out[1, 2] += rng.uniform(-c_px, c_px)
    return out
