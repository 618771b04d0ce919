"""Fine stage of the rasterizer: the CUDA kernel csrc/fine_raster_fwd.cu and
its plain PyTorch version.

The kernel replaces the TPU kernel B1, self6dpp_tpu/ops/raster_pallas.py::
_fine_fwd_kernel (fine_raster -> _fine_fwd -> pallas_call). It computes the
same function without the TPU's layout: no K-minor lane packing, no one-hot
matmul for the winner gather, no exp(sum(log)) for the silhouette product.
One block per (image, tile) and one thread per pixel; the tile's candidates
sit in shared memory; outputs are written straight in image layout. At the
DeepIM shapes the bytes it writes bound it (most tiles are empty); see the
source for the design.

Both take the per-image face table and the per-tile candidates that
rasterizer.raster_inputs makes:
  ftab (B, F, 11 + 3D) f32  rows [x0,y0,x1,y1,x2,y2, zmean, valid,
                            1/z0,1/z1,1/z2, attr v0 (D), v1 (D), v2 (D)]
  cand (B*T, K) int32       face ids per tile, -1 for an empty slot;
                            tile t covers image t // T, tiles row-major
and return a RasterOut in (B, H, W[, D]) image layout.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch import Tensor

from .rasterizer import RasterOut

_GEO = 11               # face-table columns before the attributes
_MAX_SMEM = 232_448     # bytes of shared memory a block may use on Hopper


def _grid(height: int, width: int, tile_px: int) -> tuple[int, int]:
    return -(-height // tile_px), -(-width // tile_px)


def fine_raster_plain(ftab: Tensor, cand: Tensor, height: int, width: int,
                      tile_px: int, sigma_px: float, with_prob: bool,
                      persp: bool) -> RasterOut:
    """Plain PyTorch version of the kernel (the math of the JAX package's
    ops/rasterizer.py::_raster_tile), on any device. Works through the tiles
    in chunks so that a (tiles, pixels, K) intermediate stays near 4M
    elements."""
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
            prob = 1.0 - torch.prod(1.0 - p_face, dim=-1)
        else:
            prob = covered.float()
        outs.append((covered.float(), prob, depth, attr, face_id, bary))

    def untile(x):
        # (B*Tt, P, ...) -> (B, H, W, ...)
        x = x.reshape((B, th, tw, tile_px, tile_px) + x.shape[2:])
        x = x.transpose(2, 3).reshape((B, th * tile_px, tw * tile_px)
                                      + x.shape[5:])
        return x[:, :height, :width].contiguous()

    return RasterOut(*(untile(torch.cat(parts)) for parts in zip(*outs)))


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
                                   with_prob: bool, persp: bool) -> Tensor:
    """Per-(tile, candidate) gradients (B*T, K, C) of the fine stage, from
    the cotangents of prob, depth and attr ((B,H,W), (B,H,W), (B,H,W,D)):
    the rule of the JAX package's ops/raster_pallas.py::_fine_bwd_body,
    written with tensors and chunked over tiles as fine_raster_plain is.

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
        zkey = torch.where(inside, rows[:, None, :, 6], torch.inf)
        best = zkey.argmin(dim=-1)                                 # (n,P)
        covf = inside.any(dim=-1).float()
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
            tprod = torch.prod(one_m, dim=-1, keepdim=True)
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
                          with_prob: bool, persp: bool) -> Tensor:
    """Plain PyTorch version of kernel B2: d ftab (B, F, C) on any device."""
    B, F, _ = ftab.shape
    part = fine_raster_bwd_partials_plain(ftab, cand, dprob, ddepth, dattr,
                                          height, width, tile_px, sigma_px,
                                          with_prob, persp)
    return scatter_to_faces(part, cand, B, F)


@functools.cache
def _lib() -> ctypes.CDLL:
    from ..kernels import build
    lib = build.load("fine_raster_fwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fine_raster_fwd.argtypes = [p] * 8 + [i] * 9 + [ctypes.c_float, i, i, p]
    lib.fine_raster_fwd.restype = i
    return lib


def fine_raster(ftab: Tensor, cand: Tensor, height: int, width: int,
                tile_px: int, sigma_px: float, with_prob: bool,
                persp: bool) -> RasterOut:
    """Fine stage: the CUDA kernel for CUDA tensors, the plain version for
    CPU tensors. `fine_raster.launches` counts kernel launches."""
    if ftab.device.type == "cpu" and cand.device.type == "cpu":
        return fine_raster_plain(ftab, cand, height, width, tile_px, sigma_px,
                                 with_prob, persp)
    if ftab.device.type != "cuda" or cand.device != ftab.device:
        raise ValueError(f"ftab on {ftab.device}, cand on {cand.device}: "
                         "both must lie on one CUDA device (or the CPU)")
    if ftab.dtype != torch.float32 or cand.dtype != torch.int32:
        raise TypeError(f"need ftab float32 and cand int32, got {ftab.dtype} "
                        f"and {cand.dtype}")
    if not (ftab.is_contiguous() and cand.is_contiguous()):
        raise ValueError("ftab and cand must be contiguous")
    B, F, C = ftab.shape
    D, rem = divmod(C - _GEO, 3)
    th, tw = _grid(height, width, tile_px)
    T, K = cand.shape
    if D < 1 or rem:
        raise ValueError(f"face table width {C} is not {_GEO} + 3*D")
    if T != B * th * tw:
        raise ValueError(f"cand has {T} tiles; {B} images of {height}x{width} "
                         f"in {tile_px} px tiles need {B * th * tw}")
    if not 1 <= tile_px * tile_px <= 1024:
        raise ValueError(f"tile_px {tile_px}: one thread per pixel allows at "
                         "most 32")
    if K * (C + 2) * 4 > _MAX_SMEM:
        raise ValueError(f"K={K} candidates of {C} floats exceed shared memory")

    f32 = dict(dtype=torch.float32, device=ftab.device)
    mask = torch.empty((B, height, width), **f32)
    prob = torch.empty((B, height, width), **f32)
    depth = torch.empty((B, height, width), **f32)
    attr = torch.empty((B, height, width, D), **f32)
    face_id = torch.empty((B, height, width), dtype=torch.int32,
                          device=ftab.device)
    bary = torch.empty((B, height, width, 3), **f32)
    with torch.cuda.device(ftab.device):
        stream = torch.cuda.current_stream(ftab.device).cuda_stream
        err = _lib().fine_raster_fwd(
            ftab.data_ptr(), cand.data_ptr(), mask.data_ptr(),
            prob.data_ptr(), depth.data_ptr(), attr.data_ptr(),
            face_id.data_ptr(), bary.data_ptr(), T, F, height, width, tile_px,
            tw, th * tw, K, D, float(sigma_px) ** 2, int(with_prob),
            int(persp), stream)
    if err != 0:
        raise RuntimeError(f"fine_raster_fwd launch failed: CUDA error {err}")
    fine_raster.launches += 1
    return RasterOut(mask, prob, depth, attr, face_id, bary)


fine_raster.launches = 0


@functools.cache
def _lib_bwd() -> ctypes.CDLL:
    from ..kernels import build
    lib = build.load("fine_raster_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fine_raster_bwd.argtypes = [p] * 6 + [i] * 9 + [ctypes.c_float, i, i, p]
    lib.fine_raster_bwd.restype = i
    return lib


def fine_raster_bwd(ftab: Tensor, cand: Tensor, dprob: Tensor, ddepth: Tensor,
                    dattr: Tensor, height: int, width: int, tile_px: int,
                    sigma_px: float, with_prob: bool, persp: bool) -> Tensor:
    """Backward of the fine stage, d ftab (B, F, C): the CUDA kernel
    csrc/fine_raster_bwd.cu (per-tile partials, then scatter_to_faces) for
    CUDA tensors, the plain version for CPU tensors.
    `fine_raster_bwd.launches` counts kernel launches."""
    if ftab.device.type == "cpu" and cand.device.type == "cpu":
        return fine_raster_bwd_plain(ftab, cand, dprob, ddepth, dattr, height,
                                     width, tile_px, sigma_px, with_prob, persp)
    grads = (dprob, ddepth, dattr)
    if ftab.device.type != "cuda" or any(x.device != ftab.device
                                         for x in (cand,) + grads):
        raise ValueError("ftab, cand and the cotangents must lie on one CUDA "
                         "device (or the CPU)")
    if ftab.dtype != torch.float32 or cand.dtype != torch.int32 or any(
            g.dtype != torch.float32 for g in grads):
        raise TypeError("need float32 ftab and cotangents and int32 cand")
    B, F, C = ftab.shape
    D = (C - _GEO) // 3
    th, tw = _grid(height, width, tile_px)
    T, K = cand.shape
    if T != B * th * tw:
        raise ValueError(f"cand has {T} tiles; {B} images of {height}x{width} "
                         f"in {tile_px} px tiles need {B * th * tw}")
    if (tile_px * tile_px) % 32 or tile_px > 32:
        raise ValueError(f"tile_px {tile_px}: the backward needs whole warps "
                         "(tile_px² a multiple of 32, at most 32²)")
    if dprob.shape != (B, height, width) or ddepth.shape != (B, height, width) \
            or dattr.shape != (B, height, width, D):
        raise ValueError("cotangent shapes do not match the image")
    if K * (2 * C + 2) * 4 > _MAX_SMEM:
        raise ValueError(f"K={K} candidates of {C} floats exceed shared memory")
    ftab, cand = ftab.contiguous(), cand.contiguous()
    dprob, ddepth, dattr = (g.contiguous() for g in grads)
    partials = torch.empty((T, K, C), dtype=torch.float32, device=ftab.device)
    with torch.cuda.device(ftab.device):
        stream = torch.cuda.current_stream(ftab.device).cuda_stream
        err = _lib_bwd().fine_raster_bwd(
            ftab.data_ptr(), cand.data_ptr(), dprob.data_ptr(),
            ddepth.data_ptr(), dattr.data_ptr(), partials.data_ptr(), T, F,
            height, width, tile_px, tw, th * tw, K, D, float(sigma_px) ** 2,
            int(with_prob), int(persp), stream)
    if err != 0:
        raise RuntimeError(f"fine_raster_bwd launch failed: CUDA error {err}")
    fine_raster_bwd.launches += 1
    return scatter_to_faces(partials, cand, B, F)


fine_raster_bwd.launches = 0


class FineRaster(torch.autograd.Function):
    """The fine stage with its analytic backward (the JAX package's
    fine_raster custom_vjp): forward B1 / fine_raster_plain, backward B2 /
    fine_raster_bwd_plain, by `impl` ('kernel': the kernels for CUDA
    tensors; 'plain': the plain versions on any device). Gradients flow
    from prob, depth and attr to the face table; mask, face_id and bary are
    not differentiable."""

    @staticmethod
    def forward(ctx, ftab, cand, height, width, tile_px, sigma_px, with_prob,
                persp, impl):
        fwd = fine_raster if impl == "kernel" else fine_raster_plain
        out = fwd(ftab, cand, height, width, tile_px, sigma_px, with_prob,
                  persp)
        ctx.save_for_backward(ftab, cand)
        ctx.args = (height, width, tile_px, sigma_px, with_prob, persp, impl)
        ctx.mark_non_differentiable(out.mask, out.face_id, out.bary)
        return tuple(out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dmask, dprob, ddepth, dattr, dface_id, dbary):
        ftab, cand = ctx.saved_tensors
        *args, impl = ctx.args
        bwd = fine_raster_bwd if impl == "kernel" else fine_raster_bwd_plain
        dftab = bwd(ftab, cand, dprob, ddepth, dattr, *args)
        return (dftab,) + (None,) * 8
