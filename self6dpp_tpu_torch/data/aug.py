"""Host-side ROI cropping for the data pipeline (the eval part of
self6dpp_tpu/data/aug.py): the dynamic zoom-in box, the crop affine, the
crop itself and the normalised 2D coordinate map.

The JAX package crops with cv2.warpAffine; warp_affine reproduces what
OpenCV computes for float32 images, bit for bit, with numpy:

  * float path (OpenCV 5 for 1, 3 and 4 channels): the source coordinate
    of destination pixel (x, y) is fma(M0, x, M1*y + M2) in float32 (the
    row term rounded on its own, the column term fused), likewise for y;
    INTER_NEAREST rounds it half to even; INTER_LINEAR takes the floor
    and blends the four neighbours by lerps in float32, x first:
    fma(ax, p01 - p00, p00), fma(ax, p11 - p10, p10), then along y;
  * fixed-point path (OpenCV 4, and OpenCV 5 for any other channel
    count: the 2-channel coordinate map, the 6-channel label cache of
    xyz and normals): the coordinate is rounded to 1/1024 px (AB_BITS =
    10) per row and column step; INTER_NEAREST rounds it to the pixel,
    INTER_LINEAR snaps its fraction to 1/32 px (INTER_BITS = 5) and weighs
    the neighbours by the products of (1 - a, a) along y and x.
Neighbours outside the image count as 0 (BORDER_CONSTANT). Without
WARP_INVERSE_MAP the 2x3 matrix maps source to destination and is
inverted in float64 as cv2.invertAffineTransform does. A fused
multiply-add is emulated by one product and sum in float64 rounded to
float32 (exact but for a double rounding, which needs a float64 sum that
falls on a float32 halfway point).
"""

from __future__ import annotations

import numpy as np

from ..config import DZIConfig

_F32 = np.float32
AB_BITS = 10
INTER_BITS = 5


def aug_bbox_dzi(cfg: DZIConfig, bbox_xyxy: np.ndarray, im_h: int, im_w: int,
                 rng: np.random.Generator) -> tuple[np.ndarray, float]:
    """Returns (center (2,), scale). Square crop of side `scale`."""
    x1, y1, x2, y2 = bbox_xyxy
    cx, cy = 0.5 * (x1 + x2), 0.5 * (y1 + y2)
    bw, bh = x2 - x1, y2 - y1
    if cfg.type == "uniform":
        scale_ratio = 1 + cfg.scale_ratio * (2 * rng.random() - 1)
        shift = cfg.shift_ratio * (2 * rng.random(2) - 1)
        center = np.array([cx + bw * shift[0], cy + bh * shift[1]])
        scale = max(bh, bw) * scale_ratio * cfg.pad_scale
    elif cfg.type == "roi10d":
        d = 0.15
        x1 += bw * (rng.random() * 2 * d - d)
        x2 += bw * (rng.random() * 2 * d - d)
        y1 += bh * (rng.random() * 2 * d - d)
        y2 += bh * (rng.random() * 2 * d - d)
        center = np.array([0.5 * (x1 + x2), 0.5 * (y1 + y2)])
        scale = max(y2 - y1, x2 - x1) * cfg.pad_scale
    else:  # none: test-time crop
        center = np.array([cx, cy])
        scale = max(bh, bw) * cfg.pad_scale
    scale = min(scale, max(im_h, im_w)) * 1.0
    return center, float(scale)


def get_affine_transform(center, scale, output_size: int) -> np.ndarray:
    """2x3 float32 affine mapping the square crop (center, side=scale) to
    output_size²."""
    s = output_size / scale
    tx = output_size / 2.0 - center[0] * s
    ty = output_size / 2.0 - center[1] * s
    return np.array([[s, 0, tx], [0, s, ty]], dtype=np.float32)


def invert_affine(M: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform in float64, operation for operation."""
    m = np.asarray(M, np.float64).reshape(-1).copy()
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    a11, a22 = m[4] * d, m[0] * d
    m[0], m[1], m[3], m[4] = a11, m[1] * -d, m[3] * -d, a22
    b1 = -m[0] * m[2] - m[1] * m[5]
    b2 = -m[3] * m[2] - m[4] * m[5]
    m[2], m[5] = b1, b2
    return m.reshape(2, 3)


def _fma(a, b, c) -> np.ndarray:
    """a * b + c rounded once to float32 (a, b, c float32)."""
    return (np.asarray(a, np.float64) * b
            + np.asarray(c, np.float64)).astype(_F32)


def _gather(src_p: np.ndarray, ys: np.ndarray, xs: np.ndarray) -> np.ndarray:
    """src[ys[:, None], xs[None, :]] (H, W, C), 0 outside the image, from
    src_p: the source padded by one zero pixel on every side (coordinates
    clipped to [-1, size] read the pad)."""
    h, w = src_p.shape[0] - 2, src_p.shape[1] - 2
    return src_p[np.clip(ys, -1, h)[:, None] + 1,
                 np.clip(xs, -1, w)[None, :] + 1]


def _warp_float(src_p, m, out_w, out_h, nearest):
    m = m.astype(_F32).reshape(-1)
    # x's coordinate is fma(M0, x, M1*y + M2) with M1 = 0, y's is
    # fma(M3, x, M4*y + M5) = M4*y + M5 (rounded apart) with M3 = 0
    sx = _fma(np.arange(out_w, dtype=_F32), m[0], m[2])
    sy = m[4] * np.arange(out_h, dtype=_F32) + m[5]
    if nearest:
        return _gather(src_p, np.rint(sy).astype(np.int64),
                       np.rint(sx).astype(np.int64))
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[None, :, None], (sy - fy)[:, None, None]
    X, Y = fx.astype(np.int64), fy.astype(np.int64)
    p00, p01 = _gather(src_p, Y, X), _gather(src_p, Y, X + 1)
    p10, p11 = _gather(src_p, Y + 1, X), _gather(src_p, Y + 1, X + 1)
    t0 = _fma(ax, p01 - p00, p00)
    t1 = _fma(ax, p11 - p10, p10)
    return _fma(ay, t1 - t0, t0)


def _warp_fixed(src_p, m, out_w, out_h, nearest):
    m = m.reshape(-1)
    scale = 1 << AB_BITS
    tab = 1 << INTER_BITS
    rd = scale // 2 if nearest else scale // tab // 2
    # the row step M1*y and the column step M3*x are 0
    X = (np.rint(m[2] * scale).astype(np.int64) + rd
         + np.rint(m[0] * np.arange(out_w, dtype=np.float64) * scale
                   ).astype(np.int64))
    Y = np.rint((m[4] * np.arange(out_h, dtype=np.float64) + m[5]) * scale
                ).astype(np.int64) + rd
    if nearest:
        return _gather(src_p, Y >> AB_BITS, X >> AB_BITS)
    X >>= AB_BITS - INTER_BITS
    Y >>= AB_BITS - INTER_BITS
    one = _F32(1)
    ax = ((X & (tab - 1)).astype(_F32) / _F32(tab))[None, :, None]
    ay = ((Y & (tab - 1)).astype(_F32) / _F32(tab))[:, None, None]
    X >>= INTER_BITS
    Y >>= INTER_BITS
    return (_gather(src_p, Y, X) * ((one - ay) * (one - ax))
            + _gather(src_p, Y, X + 1) * ((one - ay) * ax)
            + _gather(src_p, Y + 1, X) * (ay * (one - ax))
            + _gather(src_p, Y + 1, X + 1) * (ay * ax))


def warp_affine(src: np.ndarray, M: np.ndarray, dsize: tuple[int, int],
                interpolation: str = "linear",
                inverse_map: bool = False) -> np.ndarray:
    """cv2.warpAffine(src, M, dsize, flags) of a float32 image (H, W) or
    (H, W, C), border constant 0, for an axis-aligned M (scale and shift:
    every crop of the pipeline; raises otherwise): interpolation 'linear'
    or 'nearest'; inverse_map=True takes M as the destination-to-source
    map (WARP_INVERSE_MAP). dsize = (width, height). Returns float32 of
    the same channel layout."""
    if interpolation not in ("linear", "nearest"):
        raise ValueError(f"unknown interpolation: {interpolation!r}")
    img = np.asarray(src, _F32)
    planar = img.ndim == 2
    img = img[..., None] if planar else img
    m = np.asarray(M, np.float64).reshape(2, 3) if inverse_map \
        else invert_affine(M)
    if m[0, 1] != 0 or m[1, 0] != 0:
        raise ValueError(f"warp_affine takes axis-aligned maps only: {M}")
    w, h = dsize
    warp = _warp_float if img.shape[2] in (1, 3, 4) else _warp_fixed
    out = warp(np.pad(img, ((1, 1), (1, 1), (0, 0))), m, w, h,
               interpolation == "nearest")
    return out[..., 0] if planar else out


def crop_resize_by_warp_affine(img: np.ndarray, center, scale,
                               output_size: int,
                               interpolation: str = "linear") -> np.ndarray:
    """The square crop (center, side scale) of img resized to
    output_size², as the JAX package's cv2 crop."""
    trans = get_affine_transform(center, scale, output_size)
    return warp_affine(img, trans, (output_size, output_size), interpolation)


def get_2d_coord(width: int, height: int, low: float = 0.0,
                 high: float = 1.0) -> np.ndarray:
    """(H, W, 2) normalized image coordinates (endpoint excluded)."""
    x = np.linspace(low, high, width, dtype=np.float32, endpoint=False)
    y = np.linspace(low, high, height, dtype=np.float32, endpoint=False)
    xx, yy = np.meshgrid(x, y)
    return np.stack([xx, yy], axis=-1)
