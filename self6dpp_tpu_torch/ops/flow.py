"""Optical flow ground truth from two depth maps (port of
self6dpp_tpu/ops/flow.py: flow_from_depth, relative_pose_KT).

Each source pixel with depth is backprojected through Kinv, moved by the
relative pose KT = K [R | t], projected, and kept where the target depth at
the rounded landing pixel agrees within depth_thresh (3 mm): the reference
CUDA loop (core/csrc/flow) as one vectorised gather.
"""

from __future__ import annotations

import torch
from torch import Tensor


def flow_from_depth(depth_src: Tensor, depth_tgt: Tensor, KT: Tensor,
                    Kinv: Tensor, depth_thresh: float = 3e-3
                    ) -> tuple[Tensor, Tensor]:
    """depth_src, depth_tgt (B, H, W); KT (B, 3, 4) = K @ [R_rel | t_rel];
    Kinv (B, 3, 3). Returns flow (B, H, W, 2) in the reference's channel
    order (dv, du) = (h_proj - h, w_proj - w), 0 where not valid, and valid
    (B, H, W) as 0/1 in depth_src's dtype."""
    B, H, W = depth_src.shape
    ws = torch.arange(W, dtype=depth_src.dtype, device=depth_src.device)[None, None, :]
    hs = torch.arange(H, dtype=depth_src.dtype, device=depth_src.device)[None, :, None]

    def k(m, i, j):
        return m[:, i, j, None, None]
    x = (ws * k(Kinv, 0, 0) + hs * k(Kinv, 0, 1) + k(Kinv, 0, 2)) * depth_src
    y = (ws * k(Kinv, 1, 0) + hs * k(Kinv, 1, 1) + k(Kinv, 1, 2)) * depth_src
    z = depth_src
    xp = x * k(KT, 0, 0) + y * k(KT, 0, 1) + z * k(KT, 0, 2) + k(KT, 0, 3)
    yp = x * k(KT, 1, 0) + y * k(KT, 1, 1) + z * k(KT, 1, 2) + k(KT, 1, 3)
    zp = x * k(KT, 2, 0) + y * k(KT, 2, 1) + z * k(KT, 2, 2) + k(KT, 2, 3) \
        + 1e-15

    wp = xp / zp
    hp = yp / zp
    # torch.round, like jnp.round, rounds half to even
    wi = torch.round(wp).to(torch.int64)
    hi = torch.round(hp).to(torch.int64)
    inb = (wp >= 0) & (wp <= W - 1) & (hp >= 0) & (hp <= H - 1)
    idx = hi.clamp(0, H - 1) * W + wi.clamp(0, W - 1)
    d_tgt = torch.gather(depth_tgt.reshape(B, -1), 1,
                         idx.reshape(B, -1)).reshape(B, H, W)

    valid = (depth_src > 1e-3) & inb & ((zp - d_tgt).abs() < depth_thresh)
    flow = torch.stack([hp - hs.expand(B, H, W), wp - ws.expand(B, H, W)],
                       dim=-1)
    flow = torch.where(valid[..., None], flow, 0.0)
    return flow, valid.to(depth_src.dtype)


def relative_pose_KT(K: Tensor, R_src: Tensor, t_src: Tensor, R_tgt: Tensor,
                     t_tgt: Tensor) -> tuple[Tensor, Tensor]:
    """(KT, Kinv) for flow_from_depth from two poses: the transform that
    carries source-camera points onto target-camera points,
    R_rel = R_tgt R_src^T, t_rel = t_tgt - R_rel t_src, and K^-1."""
    R_rel = torch.einsum("bij,bkj->bik", R_tgt, R_src)
    t_rel = t_tgt - torch.einsum("bij,bj->bi", R_rel, t_src)
    Rt = torch.cat([R_rel, t_rel[:, :, None]], dim=2)
    KT = torch.einsum("bij,bjk->bik", K, Rt)
    return KT, torch.linalg.inv(K)
