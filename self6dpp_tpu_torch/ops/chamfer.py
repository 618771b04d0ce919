"""Bidirectional nearest-neighbour (chamfer) distance between point clouds
(port of self6dpp_tpu/ops/chamfer.py): |a - b|² = |a|² + |b|² - 2 a.b with
the cross term as a batched matrix product; variable point counts are
padded points with validity weights.

Minima are taken with amin, whose gradient splits evenly between tied
entries, as JAX's min does (min(dim) gives it all to one index). Ties are
real here: the observed cloud of the stage-II loss is a constant-depth
plane on a regular pixel grid.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..parallel.dist import batch_denom


def _sq_norm(p: Tensor) -> Tensor:
    """|p|² over the last axis (3), as x·x + y·y + z·z with each add fused
    with its product (addcmul): the rounding of the JAX package's fused
    reduction, so that both packages pick the same winner among targets
    whose distances differ by rounding alone."""
    x, y, z = p.unbind(-1)
    return torch.addcmul(torch.addcmul(x * x, y, y), z, z)


def nn_distance(p1: Tensor, p2: Tensor, w1: Tensor,
                w2: Tensor) -> tuple[Tensor, Tensor]:
    """Squared nearest-neighbour distances both ways. p1 (B, N, 3), p2
    (B, M, 3); w1, w2 boolean or {0, 1} validity masks. Returns (d1 (B, N),
    the minimum over valid p2; d2 (B, M)). An invalid query gets 0; an
    invalid target never wins; a row with no valid target gets 0."""
    sq1, sq2 = _sq_norm(p1), _sq_norm(p2)
    cross = torch.bmm(p1, p2.transpose(1, 2))
    zero = torch.zeros((), dtype=p1.dtype, device=p1.device)
    # maximum, not clamp: at d == 0 its gradient is split in half, as JAX's
    d = torch.maximum(sq1[:, :, None] + sq2[:, None, :] - 2.0 * cross, zero)
    inf = torch.tensor(float("inf"), dtype=d.dtype, device=d.device)
    d1 = torch.where(w2[:, None, :] > 0, d, inf).amin(2)
    d2 = torch.where(w1[:, :, None] > 0, d, inf).amin(1)
    d1 = torch.where(w1 > 0, d1, zero)
    d2 = torch.where(w2 > 0, d2, zero)
    d1 = torch.where(torch.isfinite(d1), d1, zero)
    d2 = torch.where(torch.isfinite(d2), d2, zero)
    return d1, d2


def chamfer_loss(p1: Tensor, p2: Tensor, w1: Tensor, w2: Tensor,
                 dist_thr: float = 0.0, center_lw: float = 0.0) -> Tensor:
    """Masked chamfer: distances at or above dist_thr² (occlusion outliers)
    leave the means; with center_lw, plus the L1 between the masked
    centroids."""
    d1, d2 = nn_distance(p1, p2, w1, w2)
    m1, m2 = w1, w2
    if dist_thr > 0:
        m1 = m1 * (d1 < dist_thr ** 2)
        m2 = m2 * (d2 < dist_thr ** 2)
    loss = (d1 * m1).sum() / batch_denom(m1.sum()) \
        + (d2 * m2).sum() / batch_denom(m2.sum())
    if center_lw > 0:
        c1 = (p1 * m1[..., None]).sum(1) / m1.sum(1, keepdim=True).clamp_min(1.0)
        c2 = (p2 * m2[..., None]).sum(1) / m2.sum(1, keepdim=True).clamp_min(1.0)
        loss = loss + center_lw * (c1 - c2).abs().mean()
    return loss
