"""Fine stage of the rasterizer: the CUDA kernels csrc/fine_raster_fwd.cu
(B1) and csrc/fine_raster_bwd.cu (B2) and their plain PyTorch versions.

The kernels replace the TPU kernels of self6dpp_tpu/ops/raster_pallas.py,
_fine_fwd_kernel (fine_raster -> _fine_fwd -> pallas_call) and
_fine_bwd_kernel (the custom_vjp's _fine_bwd_rule). They compute the same
functions without the TPU's layout: no K-minor lane packing, no one-hot
matmul for the winner gather, no exp(sum(log)) for the silhouette product.
Design (details in the sources):
  * one thread per pixel, a warp an 8 x 4 block of pixels, a block of 256
    threads 8 such blocks: a 32 px tile runs as four blocks (tile_px a
    multiple of 8, at most 32);
  * _bin_faces packs a tile's valid candidates first, by ascending
    face-mean depth with stable ties: the kernels' precondition
    (cand_depth_sorted). So the first slot tells an empty tile, the count of
    filled slots ends B1's walk, and B1 stops a covered pixel at its first
    inside face, the z-test winner;
  * exact culling: a warp skips a face whose bounding box lies at squared
    distance >= b1_cull_d2 (B1) or b2_cull_d2 (B2) from its pixels' box,
    where the face's factor 1 - p rounds to 1 (B1) or p to 0 (B2);
  * under autograd (FineRaster) B1 also writes keep = prod(1 - p) per pixel,
    which B2 reads with the forward's face_id instead of recomputing the
    forward; B2 adds straight into a zero-filled d ftab with global atomics
    (the plain backward keeps per-tile partials and scatter_to_faces).
At the DeepIM shapes the bytes B1 writes bound it (most tiles are empty);
at the stage-II shapes the f32 work of the occupied tiles.

Both take the per-image face table and the per-tile candidates that
rasterizer.raster_inputs makes:
  ftab (B, F, 11 + 3D) f32  rows [x0,y0,x1,y1,x2,y2, zmean, valid,
                            1/z0,1/z1,1/z2, attr v0 (D), v1 (D), v2 (D)]
  cand (B*T, K) int32       face ids per tile, -1 for an empty slot;
                            tile t covers image t // T, tiles row-major
and return a RasterOut in (B, H, W[, D]) image layout.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from .rasterizer import RasterOut

_GEO = 11               # face-table columns before the attributes
_MAX_SMEM = 232_448     # bytes of shared memory a block may use on Hopper
# Culling cutoffs in units of sigma² (the kernels skip a face at squared
# distance d² >= cutoff * sigma² from a pixel box). B1: exp(-x) <= 2^-25 for
# x >= 25 ln 2 = 17.33, so 1.f - p rounds to 1.f and the face's factor of
# keep is exactly 1; 18 leaves room for expf's 2-ulp error and the rounding
# of d². B2: expf(-x) is exactly 0 for x >= 150 ln 2 = 103.97 (below half
# the least subnormal), so p = 0 and every gradient term of the face is 0.
B1_CULL = 18.0
B2_CULL = 105.0
# B1 also culls faces at least 1 px from the box (d² >= 1): no edge test of
# a face of nonzero area passes there, its rounding errors being far smaller.
INSIDE_CULL_D2 = 1.0


def b1_cull_d2(sigma_px: float, with_prob: bool) -> float:
    """Squared distance from which B1 skips a face."""
    d2 = B1_CULL * float(sigma_px) ** 2 if with_prob else 0.0
    return max(d2, INSIDE_CULL_D2)


def b2_cull_d2(sigma_px: float) -> float:
    """Squared distance from which B2 skips a face's silhouette terms."""
    return B2_CULL * float(sigma_px) ** 2


def box_gap_d2(x0, x1, y0, y1, fx0, fx1, fy0, fy1):
    """Squared distance between the boxes [x0, x1] x [y0, y1] (pixels) and
    [fx0, fx1] x [fy0, fy1] (a face's bounding box), as the kernels compute
    it: a lower bound of the distance from any of the pixels to the face."""
    gx = torch.clamp_min(torch.maximum(fx0 - x1, x0 - fx1), 0.0)
    gy = torch.clamp_min(torch.maximum(fy0 - y1, y0 - fy1), 0.0)
    return gx * gx + gy * gy


def cand_depth_sorted(ftab: Tensor, cand: Tensor) -> bool:
    """The kernels' precondition on cand, as rasterizer._bin_faces makes it:
    per tile the non-empty slots come first, name valid faces, and their
    face-mean depths never decrease (equal depths: ascending face id)."""
    B, F, _ = ftab.shape
    T = cand.shape[0]
    c = cand.long()
    filled = c >= 0
    if (filled[:, 1:] & ~filled[:, :-1]).any():
        return False
    rows = ftab[(torch.arange(T, device=c.device) // (T // B))[:, None],
                c.clamp_min(0)]
    if not (rows[..., 7][filled] > 0.5).all():
        return False
    z = rows[..., 6]
    both = filled[:, 1:]
    dz = z[:, 1:] - z[:, :-1]
    tie_ok = (dz > 0) | ((dz == 0) & (c[:, 1:] > c[:, :-1]))
    return bool((tie_ok | ~both).all())


def _grid(height: int, width: int, tile_px: int) -> tuple[int, int]:
    return -(-height // tile_px), -(-width // tile_px)


def fine_raster_plain(ftab: Tensor, cand: Tensor, height: int, width: int,
                      tile_px: int, sigma_px: float, with_prob: bool,
                      persp: bool) -> RasterOut:
    """Plain PyTorch version of kernel B1 (the math of the JAX package's
    ops/rasterizer.py::_raster_tile), on any device. Works through the tiles
    in chunks so that a (tiles, pixels, K) intermediate stays near 4M
    elements."""
    return _fine_plain(ftab, cand, height, width, tile_px, sigma_px,
                       with_prob, persp)[0]


def _fine_plain(ftab, cand, height, width, tile_px, sigma_px, with_prob,
                persp):
    """fine_raster_plain and, with the silhouette, keep = prod(1 - p)
    (B, H, W), the state the backward reads (else None)."""
    B, F, C = ftab.shape
    D = (C - _GEO) // 3
    T, K = cand.shape
    th, tw = _grid(height, width, tile_px)
    Tt = th * tw
    P = tile_px * tile_px
    dev = ftab.device
    r = torch.arange(P, device=dev)
    sigma2 = float(sigma_px) ** 2
    chunk = max(1, (1 << 22) // (P * K))
    outs = []
    for s in range(0, T, chunk):
        tiles = torch.arange(s, min(s + chunk, T), device=dev)
        n = tiles.shape[0]
        c = cand[s:s + n].long()                                   # (n,K)
        rows = ftab[(tiles // Tt)[:, None], c.clamp_min(0)]        # (n,K,C)
        val = (rows[..., 7] > 0.5) & (c >= 0)
        ti = tiles % Tt
        pv = ((ti // tw * tile_px)[:, None] + r // tile_px).float()[..., None]
        pu = ((ti % tw * tile_px)[:, None] + r % tile_px).float()[..., None]
        g = [rows[:, None, :, j] for j in range(7)]                # (n,1,K)
        x0, y0, x1, y1, x2, y2, zme = g
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        inv_area = torch.where(area.abs() > 1e-12, 1.0 / area,
                               torch.zeros_like(area))
        w0 = ((x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv)) * inv_area
        w1 = ((x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv)) * inv_area
        w2 = 1.0 - w0 - w1                                         # (n,P,K)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & val[:, None, :]

        # z-test on face-mean depth; the first minimum wins ties
        zkey = torch.where(inside, zme, torch.inf)
        best = zkey.argmin(dim=-1)                                 # (n,P)
        covered = inside.any(dim=-1)
        take = lambda a: a.gather(-1, best[..., None])[..., 0]
        b0 = take(w0).clamp(0.0, 1.0)
        b1 = take(w1).clamp(0.0, 1.0)
        b2 = take(w2).clamp(0.0, 1.0)
        bs = (b0 + b1 + b2).clamp_min(1e-8)
        b0, b1, b2 = b0 / bs, b1 / bs, b2 / bs
        win = rows[torch.arange(n, device=dev)[:, None], best]    # (n,P,C)
        a0 = win[..., _GEO:_GEO + D]
        a1 = win[..., _GEO + D:_GEO + 2 * D]
        a2 = win[..., _GEO + 2 * D:_GEO + 3 * D]
        if persp:
            p0, p1, p2 = b0 * win[..., 8], b1 * win[..., 9], b2 * win[..., 10]
            sp = (p0 + p1 + p2).clamp_min(1e-12)
            q0, q1, q2 = p0 / sp, p1 / sp, p2 / sp
            depth = 1.0 / sp
        else:
            q0, q1, q2 = b0, b1, b2
            depth = win[..., 6]
        attr = a0 * q0[..., None] + a1 * q1[..., None] + a2 * q2[..., None]
        zero = torch.zeros((), device=dev)
        attr = torch.where(covered[..., None], attr, zero)
        depth = torch.where(covered, depth, zero)
        bary = torch.where(covered[..., None], torch.stack([b0, b1, b2], -1),
                           zero)
        face_id = torch.where(covered, c.gather(1, best), -1).to(torch.int32)

        if with_prob:
            d2 = torch.minimum(torch.minimum(
                _seg_d2(pu, pv, x0, y0, x1, y1),
                _seg_d2(pu, pv, x1, y1, x2, y2)),
                _seg_d2(pu, pv, x2, y2, x0, y0))
            p_face = torch.where(inside, 1.0, torch.exp(-d2 / sigma2))
            p_face = torch.where(val[:, None, :], p_face, zero)
            keep = torch.prod(1.0 - p_face, dim=-1)
            prob = 1.0 - keep
        else:
            prob = covered.float()
            keep = prob
        outs.append((covered.float(), prob, depth, attr, face_id, bary, keep))

    *out, keep = (_untile(torch.cat(parts), B, tw, tile_px, height, width)
                  for parts in zip(*outs))
    return RasterOut(*out), keep if with_prob else None


def _untile(x: Tensor, B: int, tw: int, tile_px: int, height: int,
            width: int) -> Tensor:
    """(B*Tt, P, ...) tile layout -> (B, H, W, ...) image layout."""
    th = x.shape[0] // (B * tw)
    x = x.reshape((B, th, tw, tile_px, tile_px) + x.shape[2:])
    x = x.transpose(2, 3).reshape((B, th * tile_px, tw * tile_px)
                                  + x.shape[5:])
    return x[:, :height, :width].contiguous()


def keep_slot_order_plain(ftab: Tensor, cand: Tensor, height: int, width: int,
                          tile_px: int, sigma_px: float) -> Tensor:
    """keep = prod_k (1 - p_k) (B, H, W) multiplied slot by slot, in the
    order of B1's loop and of the recompute the backward made before it read
    the forward's keep, each step one plain operation (true divisions: a
    tensor divided by a Python number takes its reciprocal on CUDA). On the
    card it holds B1's saved keep bit for bit; the checks use it."""
    B, F, C = ftab.shape
    T, K = cand.shape
    th, tw = _grid(height, width, tile_px)
    dev = ftab.device
    r = torch.arange(tile_px * tile_px, device=dev)
    tiles = torch.arange(T, device=dev)
    ti = tiles % (th * tw)
    pv = ((ti // tw * tile_px)[:, None] + r // tile_px).float()     # (T,P)
    pu = ((ti % tw * tile_px)[:, None] + r % tile_px).float()
    rows = ftab[(tiles // (th * tw))[:, None], cand.long().clamp_min(0)]
    val = (rows[..., 7] > 0.5) & (cand >= 0)                         # (T,K)
    sigma2 = torch.tensor(float(sigma_px) ** 2, device=dev)
    keep = torch.ones_like(pu)
    for k in range(K):
        x0, y0, x1, y1, x2, y2 = (rows[:, k, j, None] for j in range(6))
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        inv = torch.where(area.abs() > 1e-12, 1.0 / area,
                          torch.zeros_like(area))
        w0 = ((x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv)) * inv
        w1 = ((x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv)) * inv
        w2 = 1.0 - w0 - w1
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        d2 = torch.minimum(torch.minimum(_seg_d2(pu, pv, x0, y0, x1, y1),
                                         _seg_d2(pu, pv, x1, y1, x2, y2)),
                           _seg_d2(pu, pv, x2, y2, x0, y0))
        p = torch.where(inside, 1.0, torch.exp(-d2 / sigma2))
        keep = torch.where(val[:, k, None], keep * (1.0 - p), keep)
    return _untile(keep, B, tw, tile_px, height, width)


def scattered_faces(device, seed=0, batch=2, height=70, width=100,
                    tile_px=32, faces=80, faces_per_tile=128, n_attr=3):
    """A scene for the kernels' checks, from a seed: `faces` triangles of
    1-4 px radius scattered over ragged images at random depths (every sixth
    face's depths copied from its neighbour: equal face-mean depths; a tenth
    of the faces invalid), binned by rasterizer._bin_faces. A 32 px tile
    then holds faces from 0 to ~45 px from its pixels, so both kernels'
    culling cutoffs fall inside its tiles. Cotangents of prob, depth and attr
    lie on about half of the 8 x 4 pixel blocks and on none of each image's
    first tile. Returns (ftab, cand, (dprob, ddepth, dattr)) on `device`."""
    from .rasterizer import _bin_faces, _pack_faces
    rng = np.random.default_rng(seed)
    b, f = batch, faces
    centre = rng.uniform((0, 0), (width, height), (b, f, 1, 2))
    ang = rng.uniform(0, 2 * np.pi, (b, f, 1)) + np.array([0.0, 2.2, 4.3])
    rad = rng.uniform(1, 4, (b, f, 1, 1))
    v2d = centre + rad * np.stack([np.cos(ang), np.sin(ang)], -1)
    z = rng.uniform(1, 2, (b, f, 3))
    z[:, 1::6] = z[:, 0::6][:, :z[:, 1::6].shape[1]]
    valid = rng.uniform(size=(b, f)) > 0.1
    attr = rng.uniform(size=(b, f, 3, n_attr))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)
    v2d, z = t(v2d), t(z)
    valid = torch.as_tensor(valid, device=device)
    zmean = z.mean(dim=2)
    ftab = _pack_faces(v2d, zmean, valid, 1.0 / z, t(attr))
    cand = _bin_faces(v2d, valid, height, width, tile_px, faces_per_tile,
                      zmean)
    on = rng.uniform(size=(b, -(-height // 4), -(-width // 8))) > 0.5
    on = on.repeat(4, 1).repeat(8, 2)[:, :height, :width].copy()
    on[:, :tile_px, :tile_px] = False
    on = t(on)
    cts = (t(rng.normal(size=(b, height, width))) * on,
           t(rng.normal(size=(b, height, width))) * on,
           t(rng.normal(size=(b, height, width, n_attr))) * on[..., None])
    return ftab, cand.reshape(-1, faces_per_tile).contiguous(), cts


def _seg_d2(pu, pv, ax, ay, bx, by):
    abx, aby = bx - ax, by - ay
    apx, apy = pu - ax, pv - ay
    tt = (apx * abx + apy * aby) / (abx * abx + aby * aby).clamp_min(1e-12)
    tt = tt.clamp(0.0, 1.0)
    dx = apx - tt * abx
    dy = apy - tt * aby
    return dx * dx + dy * dy


def _seg_bwd(pu, pv, ax, ay, bx, by, dd):
    """Gradients of the squared distance to segment ab, scaled by dd, with
    respect to (ax, ay, bx, by). The foot parameter t is held fixed: at the
    unconstrained minimiser d(d2)/dt = 0 (the envelope theorem), and where
    t is clipped it is constant."""
    abx, aby = bx - ax, by - ay
    apx, apy = pu - ax, pv - ay
    tt = (apx * abx + apy * aby) / (abx * abx + aby * aby).clamp_min(1e-12)
    tt = tt.clamp(0.0, 1.0)
    rx = apx - tt * abx
    ry = apy - tt * aby
    return (-2.0 * rx * (1.0 - tt) * dd, -2.0 * ry * (1.0 - tt) * dd,
            -2.0 * rx * tt * dd, -2.0 * ry * tt * dd)


def _tile_pixels(x: Tensor, tile_px: int, Tt: int, tw: int) -> Tensor:
    """(B, H, W[, D]) image layout -> (B*Tt, P[, D]) tile layout, zero past
    the ragged image edge (the inverse of fine_raster_plain's untile)."""
    B, H, W = x.shape[:3]
    th = Tt // tw
    pad = [0, 0] * (x.ndim - 3) + [0, tw * tile_px - W, 0, th * tile_px - H]
    x = torch.nn.functional.pad(x, pad)
    x = x.reshape((B, th, tile_px, tw, tile_px) + x.shape[3:]).transpose(2, 3)
    return x.reshape((B * Tt, tile_px * tile_px) + x.shape[5:])


def scatter_to_faces(partials: Tensor, cand: Tensor, B: int, F: int) -> Tensor:
    """(B*T, K, C) per-(tile, candidate) gradients -> d ftab (B, F, C): the
    backward of the candidate gather, an index_add_ over tiles. Empty slots
    (cand < 0) go to a spare row that is dropped."""
    T, K, C = partials.shape
    b_of_t = torch.arange(T, device=cand.device) // (T // B)
    idx = torch.where(cand >= 0, cand.long() + b_of_t[:, None] * F, B * F)
    out = torch.zeros((B * F + 1, C), dtype=partials.dtype,
                      device=partials.device)
    out.index_add_(0, idx.reshape(-1), partials.reshape(-1, C))
    return out[:B * F].reshape(B, F, C)


def fine_raster_bwd_partials_plain(ftab: Tensor, cand: Tensor, dprob: Tensor,
                                   ddepth: Tensor, dattr: Tensor, height: int,
                                   width: int, tile_px: int, sigma_px: float,
                                   with_prob: bool, persp: bool,
                                   saved: tuple | None = None) -> Tensor:
    """Per-(tile, candidate) gradients (B*T, K, C) of the fine stage, from
    the cotangents of prob, depth and attr ((B,H,W), (B,H,W), (B,H,W,D)):
    the rule of the JAX package's ops/raster_pallas.py::_fine_bwd_body,
    written with tensors and chunked over tiles as fine_raster_plain is.
    saved = (face_id, keep), the forward's winner and silhouette product
    (keep may be None without the silhouette), replaces their recompute;
    None recomputes them.

    The winner's columns get the gradients through the perspective-
    corrected barycentrics, the clip-and-renormalise chain (strict
    0 < b < 1 masks) and the edge functions; with the silhouette, every
    valid candidate of a pixel outside all faces gets the gradient of
    1 - prod(1 - p) through the leave-one-out product and the distance to
    its nearest edge (ties to edge 01, then 12, then 20). The z-test is
    piecewise constant (no gradient); `valid` gets none."""
    B, F, C = ftab.shape
    D = (C - _GEO) // 3
    T, K = cand.shape
    th, tw = _grid(height, width, tile_px)
    Tt = th * tw
    P = tile_px * tile_px
    dev = ftab.device
    r = torch.arange(P, device=dev)
    sigma2 = float(sigma_px) ** 2
    dprob_t = _tile_pixels(dprob, tile_px, Tt, tw)
    ddep_t = _tile_pixels(ddepth, tile_px, Tt, tw)
    dattr_t = _tile_pixels(dattr, tile_px, Tt, tw)
    if saved is not None:
        # -1 past the ragged image edge, like an uncovered pixel
        fid_t = _tile_pixels(saved[0] + 1, tile_px, Tt, tw).long() - 1
        keep_t = (None if saved[1] is None
                  else _tile_pixels(saved[1], tile_px, Tt, tw))
    chunk = max(1, (1 << 22) // (P * K))
    outs = []
    for s in range(0, T, chunk):
        tiles = torch.arange(s, min(s + chunk, T), device=dev)
        n = tiles.shape[0]
        c = cand[s:s + n].long()
        rows = ftab[(tiles // Tt)[:, None], c.clamp_min(0)]        # (n,K,C)
        val = (rows[..., 7] > 0.5) & (c >= 0)
        ti = tiles % Tt
        pv = ((ti // tw * tile_px)[:, None] + r // tile_px).float()[..., None]
        pu = ((ti % tw * tile_px)[:, None] + r % tile_px).float()[..., None]
        x0, y0, x1, y1, x2, y2, _ = [rows[:, None, :, j] for j in range(7)]
        area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
        inv_area = torch.where(area.abs() > 1e-12, 1.0 / area,
                               torch.zeros_like(area))
        e0 = (x1 - pu) * (y2 - pv) - (x2 - pu) * (y1 - pv)
        e1 = (x2 - pu) * (y0 - pv) - (x0 - pu) * (y2 - pv)
        w0 = e0 * inv_area
        w1 = e1 * inv_area
        w2 = 1.0 - w0 - w1                                         # (n,P,K)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0) & val[:, None, :]
        if saved is None:
            zkey = torch.where(inside, rows[:, None, :, 6], torch.inf)
            best = zkey.argmin(dim=-1)                             # (n,P)
            covf = inside.any(dim=-1).float()
        else:
            fid = fid_t[s:s + n]
            # the winner's slot; face ids are unique within a tile
            best = (c[:, None, :] == fid[..., None]).int().argmax(-1)
            covf = (fid >= 0).float()
        take = lambda a: a.gather(-1, best[..., None])[..., 0]
        b0r, b1r, b2r = take(w0), take(w1), take(w2)
        c0, c1, c2 = (b.clamp(0.0, 1.0) for b in (b0r, b1r, b2r))
        bs = (c0 + c1 + c2).clamp_min(1e-8)
        b0, b1, b2 = c0 / bs, c1 / bs, c2 / bs
        win = rows[torch.arange(n, device=dev)[:, None], best]    # (n,P,C)
        a = [win[..., _GEO + i * D:_GEO + (i + 1) * D] for i in range(3)]
        da = dattr_t[s:s + n] * covf[..., None]                    # (n,P,D)
        dd = ddep_t[s:s + n] * covf
        contrib = torch.zeros((n, P, C), device=dev)
        if persp:
            zi = [win[..., 8 + i] for i in range(3)]
            p = [b * z for b, z in zip((b0, b1, b2), zi)]
            sp = (p[0] + p[1] + p[2]).clamp_min(1e-12)
            q = [pi / sp for pi in p]
            dq = [(ai * da).sum(-1) for ai in a]
            mixq = q[0] * dq[0] + q[1] * dq[1] + q[2] * dq[2]
            ds_extra = -dd / (sp * sp)
            dp = [(dqi - mixq) / sp + ds_extra for dqi in dq]
            db = [dpi * zii for dpi, zii in zip(dp, zi)]
            for i, (dpi, bi) in enumerate(zip(dp, (b0, b1, b2))):
                contrib[..., 8 + i] = dpi * bi
            wts = q
        else:
            db = [(ai * da).sum(-1) for ai in a]
            contrib[..., 6] = dd
            wts = (b0, b1, b2)
        for i, wi in enumerate(wts):
            contrib[..., _GEO + i * D:_GEO + (i + 1) * D] = wi[..., None] * da
        mix = b0 * db[0] + b1 * db[1] + b2 * db[2]
        dc = [(dbi - mix) / bs * ((bri > 0) & (bri < 1)).float()
              for dbi, bri in zip(db, (b0r, b1r, b2r))]
        dw0, dw1 = dc[0] - dc[2], dc[1] - dc[2]
        inv, e0b, e1b = take(inv_area.expand_as(e0)), take(e0), take(e1)
        de0, de1 = dw0 * inv, dw1 * inv
        darea = -(dw0 * e0b + dw1 * e1b) * inv * inv
        X0, Y0, X1, Y1, X2, Y2 = (win[..., j] for j in range(6))
        pu2, pv2 = pu[..., 0], pv[..., 0]
        contrib[..., 0] = -de1 * (Y2 - pv2) + darea * (Y1 - Y2)
        contrib[..., 1] = de1 * (X2 - pu2) + darea * (X2 - X1)
        contrib[..., 2] = de0 * (Y2 - pv2) + darea * (Y2 - Y0)
        contrib[..., 3] = -de0 * (X2 - pu2) - darea * (X2 - X0)
        contrib[..., 4] = -de0 * (Y1 - pv2) + de1 * (Y0 - pv2) - darea * (Y1 - Y0)
        contrib[..., 5] = de0 * (X1 - pu2) - de1 * (X0 - pu2) + darea * (X1 - X0)
        part = torch.zeros((n, K, C), device=dev)
        part.scatter_add_(1, best[..., None].expand(n, P, C), contrib)

        if with_prob:
            d01 = _seg_d2(pu, pv, x0, y0, x1, y1)
            d12 = _seg_d2(pu, pv, x1, y1, x2, y2)
            d20 = _seg_d2(pu, pv, x2, y2, x0, y0)
            d2 = torch.minimum(torch.minimum(d01, d12), d20)
            p_face = torch.where(inside, 1.0, torch.exp(-d2 / sigma2))
            p_face = torch.where(val[:, None, :], p_face, 0.0)
            one_m = 1.0 - p_face
            if saved is None:
                tprod = torch.prod(one_m, dim=-1, keepdim=True)
            else:
                tprod = keep_t[s:s + n][..., None]
            loo = torch.where(one_m > 1e-6, tprod / one_m.clamp_min(1e-6), 0.0)
            dp_face = dprob_t[s:s + n][..., None] * loo
            outside = ~inside & val[:, None, :]
            dd2 = torch.where(outside, -p_face / sigma2 * dp_face, 0.0)
            m01 = (d01 <= d12) & (d01 <= d20)
            m12 = (d12 < d01) & (d12 <= d20)
            m20 = ~m01 & ~m12
            g01 = _seg_bwd(pu, pv, x0, y0, x1, y1, dd2 * m01)
            g12 = _seg_bwd(pu, pv, x1, y1, x2, y2, dd2 * m12)
            g20 = _seg_bwd(pu, pv, x2, y2, x0, y0, dd2 * m20)
            seg = (g01[0] + g20[2], g01[1] + g20[3], g01[2] + g12[0],
                   g01[3] + g12[1], g12[2] + g20[0], g12[3] + g20[1])
            part[..., :6] += torch.stack([g.sum(1) for g in seg], dim=-1)
        outs.append(part)
    return torch.cat(outs)


def fine_raster_bwd_plain(ftab: Tensor, cand: Tensor, dprob: Tensor,
                          ddepth: Tensor, dattr: Tensor, height: int,
                          width: int, tile_px: int, sigma_px: float,
                          with_prob: bool, persp: bool,
                          saved: tuple | None = None) -> Tensor:
    """Plain PyTorch version of kernel B2: d ftab (B, F, C) on any device,
    from the forward's saved (face_id, keep) or, with saved=None, from a
    recompute of them."""
    B, F, _ = ftab.shape
    part = fine_raster_bwd_partials_plain(ftab, cand, dprob, ddepth, dattr,
                                          height, width, tile_px, sigma_px,
                                          with_prob, persp, saved)
    return scatter_to_faces(part, cand, B, F)


class FineRaster(torch.autograd.Function):
    """The fine stage with its analytic backward, both in plain PyTorch:
    forward _fine_plain, backward fine_raster_bwd_plain. The forward saves
    its face_id and, with the silhouette, keep = prod(1 - p) for the
    backward. Gradients flow from prob, depth and attr to the face table;
    mask, face_id and bary are not differentiable."""

    @staticmethod
    def forward(ctx, ftab, cand, height, width, tile_px, sigma_px, with_prob,
                persp, impl):
        out, keep = _fine_plain(ftab, cand, height, width, tile_px,
                                sigma_px, with_prob, persp)
        ctx.save_for_backward(ftab, cand, out.face_id, keep)
        ctx.args = (height, width, tile_px, sigma_px, with_prob, persp)
        ctx.mark_non_differentiable(out.mask, out.face_id, out.bary)
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dmask, dprob, ddepth, dattr, dface_id, dbary):
        ftab, cand, face_id, keep = ctx.saved_tensors
        dftab = fine_raster_bwd_plain(ftab, cand, dprob, ddepth, dattr,
                                      *ctx.args, (face_id, keep))
        return (dftab,) + (None,) * 8
