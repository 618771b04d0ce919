"""Synthetic GDRN batches (numpy copy of
self6dpp_tpu/data/synthetic.py::make_gdrn_batch): the data pipeline's batch
contract with consistent ground-truth poses, from a seed. The same seed
gives the same arrays as the JAX package's function."""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation

from ..config import Config


def make_gdrn_batch(cfg: Config, batch_size: int = 4, seed: int = 0,
                    input_res: int | None = None, output_res: int | None = None,
                    n_points: int | None = None) -> dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    s = input_res or cfg.model.input_res
    o = output_res or cfg.model.output_res
    npts = n_points or cfg.data.model_points
    b = batch_size
    nc = cfg.model.num_classes
    nreg = cfg.model.geo_head.num_regions
    nsym = cfg.data.max_sym_rots
    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899], [0, 0, 1]],
                 dtype=np.float32)
    roi_center = rng.uniform(200, 440, (b, 2)).astype(np.float32)
    roi_wh = rng.uniform(80, 160, (b, 1)).astype(np.float32).repeat(2, axis=1)
    gt_rot = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    z = rng.uniform(0.6, 1.4, (b,)).astype(np.float32)
    cx = (roi_center[:, 0] - K[0, 2]) / K[0, 0] * z
    cy = (roi_center[:, 1] - K[1, 2]) / K[1, 1] * z
    gt_trans = np.stack([cx, cy, z], axis=1).astype(np.float32)
    resize_ratio = (o / (roi_wh[:, 0] * 1.5)).astype(np.float32)

    sym_rots = np.broadcast_to(np.eye(3, dtype=np.float32), (b, nsym, 3, 3)).copy()
    sym_valid = np.zeros((b, nsym), dtype=bool)
    sym_valid[:, 0] = True

    batch = {
        "roi_img": rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32),
        "roi_cls": rng.integers(0, nc, (b,)).astype(np.int32),
        "roi_cam": np.broadcast_to(K, (b, 3, 3)).copy(),
        "roi_center": roi_center,
        "roi_wh": roi_wh,
        "roi_extent": rng.uniform(0.05, 0.3, (b, 3)).astype(np.float32),
        "resize_ratio": resize_ratio,
        "roi_coord_2d": rng.uniform(0, 1, (b, o, o, 2)).astype(np.float32),
        "gt_xyz": rng.uniform(0, 1, (b, o, o, 3)).astype(np.float32),
        "gt_xyz_bin": rng.integers(0, 64, (b, o, o, 3)).astype(np.int32),
        "gt_mask_trunc": (rng.uniform(0, 1, (b, o, o)) > 0.5).astype(np.float32),
        "gt_mask_visib": (rng.uniform(0, 1, (b, o, o)) > 0.5).astype(np.float32),
        "gt_mask_obj": (rng.uniform(0, 1, (b, o, o)) > 0.5).astype(np.float32),
        "gt_mask_full": (rng.uniform(0, 1, (b, o, o)) > 0.5).astype(np.float32),
        "gt_region": rng.integers(0, nreg + 1, (b, o, o)).astype(np.int32),
        "gt_rot": gt_rot,
        "gt_trans": gt_trans,
        "gt_trans_ratio": np.stack(
            [np.zeros(b), np.zeros(b), z / resize_ratio], axis=1).astype(np.float32),
        "gt_points": (rng.normal(0, 0.05, (b, npts, 3))).astype(np.float32),
        "sym_rots": sym_rots,
        "sym_valid": sym_valid,
    }
    # the vf/norm targets draw after everything else, so that the arrays
    # above do not depend on the heads
    gh = cfg.model.geo_head
    if gh.with_vf:
        f = gh.num_vf_points
        for k in ("gt_vf_vis", "gt_vf_full"):
            v = rng.normal(0, 1, (b, o, o, 2 * f)).astype(np.float32)
            v /= np.maximum(np.linalg.norm(
                v.reshape(b, o, o, f, 2), axis=-1, keepdims=True),
                1e-8).reshape(b, o, o, f, 1).repeat(2, -1).reshape(b, o, o, -1)
            batch[k] = v
    if gh.with_norm:
        n = rng.normal(0, 1, (b, o, o, 3)).astype(np.float32)
        n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-8)
        batch["gt_norm"] = n * batch["gt_mask_visib"][..., None]
    return batch
