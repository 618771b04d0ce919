"""Host-side augmentation and ROI cropping for the data pipeline (port of
self6dpp_tpu/data/aug.py): the dynamic zoom-in box, the crop affine, the
crop itself and the normalised 2D coordinate map; the train-time colour
augmentation, background replacement and depth noise, which draw from the
np.random.Generator in the JAX package's order, so one seed gives the same
augmentation.

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

The JAX package blurs with cv2.GaussianBlur(img, (5, 5), sigma) and
resizes backgrounds with cv2.resize; gaussian_blur_5 and resize_linear
compute what OpenCV computes for float images (its kernel from sigma, its
BORDER_REFLECT_101; its pixel-centre convention with edge clamping), and
resize_nearest is cv2.INTER_NEAREST, for the training CLI's image grids.
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


# ---------------------------------------------------------------------------
# OpenCV's blur and resizes for float images
# ---------------------------------------------------------------------------

def gaussian_kernel(ksize: int, sigma: float, dtype=np.float32) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma) for sigma > 0: exp(-x² / (2
    sigma²)) at x = i - (ksize - 1) / 2, normalised to sum 1 in float64,
    then cast to the image's kernel type (float32 for float32 images)."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp((-0.5 / (sigma * sigma)) * x * x)
    return (k * (1.0 / k.sum())).astype(dtype)


def _reflect101(n: int, r: int) -> np.ndarray:
    """Source indices of -r .. n-1+r under BORDER_REFLECT_101."""
    i = np.arange(-r, n + r)
    i = np.abs(i)
    return np.where(i > n - 1, 2 * (n - 1) - i, i)


def gaussian_blur_5(img: np.ndarray, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (5, 5), sigma) of a float32 or float64 image
    (H, W[, C]): the separable kernel along rows, then along columns, each
    pass summed as OpenCV sums a symmetric kernel (the centre tap, then the
    mirrored pairs), in the image's precision."""
    img = np.asarray(img)
    if img.dtype not in (np.float32, np.float64):
        raise TypeError(f"gaussian_blur_5 takes float images: {img.dtype}")
    k = gaussian_kernel(5, sigma, img.dtype)
    h, w = img.shape[:2]
    xs = _reflect101(w, 2)
    p = img[:, xs]
    row = k[0 + 2] * p[:, 2:w + 2] + (
        k[1 + 2] * (p[:, 1:w + 1] + p[:, 3:w + 3])
        + k[2 + 2] * (p[:, 0:w] + p[:, 4:w + 4]))
    ys = _reflect101(h, 2)
    q = row[ys]
    return (k[2] * q[2:h + 2] + (k[3] * (q[1:h + 1] + q[3:h + 3])
                                 + k[4] * (q[0:h] + q[4:h + 4]))
            ).astype(img.dtype)


def _linear_taps(n_src: int, n_dst: int):
    """OpenCV's INTER_LINEAR source index and weights (1 - a, a) along one
    axis: f = (d + 0.5) * n_src / n_dst - 0.5 in float64, floored, its
    fraction a rounded to float32; clamped to the edge pixels (weight 1
    on the edge)."""
    f = (np.arange(n_dst, dtype=np.float64) + 0.5) * (n_src / n_dst) - 0.5
    s = np.floor(f).astype(np.int64)
    a = (f - s).astype(_F32)
    lo = s < 0
    a[lo], s[lo] = 0, 0
    hi = s >= n_src - 1
    a[hi], s[hi] = 0, n_src - 1
    return s, np.minimum(s + 1, n_src - 1), (_F32(1) - a), a


def resize_linear(img: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, dsize) (INTER_LINEAR) of a float32 image (H, W[, C]);
    dsize = (width, height). Rows are resized first, then columns; an
    exact halving of both sides is the 2x2 mean (OpenCV takes INTER_AREA
    there)."""
    img = np.asarray(img, _F32)
    h, w = img.shape[:2]
    dw, dh = dsize
    if (dw, dh) == (w, h):
        return img.copy()
    if w == 2 * dw and h == 2 * dh:
        s = img[0::2, 0::2] + img[0::2, 1::2] + img[1::2, 0::2] \
            + img[1::2, 1::2]
        return (s * _F32(0.25)).astype(_F32)
    x0, x1, ax0, ax1 = _linear_taps(w, dw)
    y0, y1, ay0, ay1 = _linear_taps(h, dh)
    ext = (slice(None),) + (None,) * (img.ndim - 1)     # along rows
    xext = (None,) + ext[:-1]                           # along columns
    row = img[:, x0] * ax0[xext] + img[:, x1] * ax1[xext]
    return (row[y0] * ay0[ext] + row[y1] * ay1[ext]).astype(_F32)


def resize_nearest(img: np.ndarray, dsize: tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=cv2.INTER_NEAREST): source
    index floor(d * n_src / n_dst), clamped to the last pixel."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    dw, dh = dsize
    xs = np.minimum(np.floor(np.arange(dw) * (w / dw)).astype(np.int64), w - 1)
    ys = np.minimum(np.floor(np.arange(dh) * (h / dh)).astype(np.int64), h - 1)
    return img[ys[:, None], xs[None, :]]


# ---------------------------------------------------------------------------
# train-time augmentation
# ---------------------------------------------------------------------------

def color_aug(img: np.ndarray, rng: np.random.Generator,
              prob: float = 0.8) -> np.ndarray:
    """img float32 (H, W, 3) in [0, 1]. With probability `prob`, a random
    subset of coarse dropout, Gaussian blur, add, per-channel add,
    multiply, per-channel multiply, contrast and a grayscale blend (the
    reference's AAE chain, base_data_loader.py:230-250), clipped to [0, 1].
    The blur always runs when drawn (the JAX package's needs OpenCV)."""
    if rng.random() > prob:
        return img
    out = img.copy()
    if rng.random() < 0.5:    # coarse dropout
        h, w = out.shape[:2]
        gh, gw = max(h // 20, 1), max(w // 20, 1)
        drop = rng.random((gh, gw)) < 0.2
        drop = np.kron(drop, np.ones((h // gh + 1, w // gw + 1)))[:h, :w]
        out = out * (1 - drop[..., None])
    if rng.random() < 0.5:    # gaussian blur
        sig = 1.2 * rng.random()
        if sig > 0.3:
            out = gaussian_blur_5(out, sig)
    if rng.random() < 0.5:    # add
        out = out + rng.uniform(-0.1, 0.1)
    if rng.random() < 0.3:    # per-channel add
        out = out + rng.uniform(-0.06, 0.06, 3)
    if rng.random() < 0.5:    # multiply
        out = out * rng.uniform(0.75, 1.25)
    if rng.random() < 0.3:    # per-channel multiply
        out = out * rng.uniform(0.85, 1.15, 3)
    if rng.random() < 0.5:    # contrast
        mean = out.mean()
        out = (out - mean) * rng.uniform(0.7, 1.3) + mean
    if rng.random() < 0.3:    # grayscale blend
        g = out.mean(axis=-1, keepdims=True)
        alpha = rng.random()
        out = alpha * g + (1 - alpha) * out
    return np.clip(out, 0.0, 1.0).astype(np.float32)


def replace_bg(img: np.ndarray, mask: np.ndarray, bg: np.ndarray,
               truncate_fg: bool = False,
               rng: np.random.Generator | None = None) -> np.ndarray:
    """The foreground (mask > 0) over `bg`, resized to the image first
    (GDRN loader, data_loader.py:398-430). truncate_fg: along a random
    axis, a random cut of the mask's extent, the part past it dropped with
    probability 1/2."""
    h, w = img.shape[:2]
    if bg.shape[:2] != (h, w):
        bg = resize_linear(bg, (w, h))
    m = (mask > 0).astype(np.float32)
    if truncate_fg and rng is not None:
        ys, xs = np.nonzero(m)
        if len(ys) > 0:
            if rng.random() < 0.5:
                cut = rng.integers(xs.min(), max(xs.max(), xs.min() + 1))
                m[:, cut:] = 0 if rng.random() < 0.5 else m[:, cut:]
            else:
                cut = rng.integers(ys.min(), max(ys.max(), ys.min() + 1))
                m[cut:, :] = 0 if rng.random() < 0.5 else m[cut:, :]
    return img * m[..., None] + bg * (1 - m[..., None])


def add_noise_depth(depth: np.ndarray, rng: np.random.Generator,
                    level: float = 0.1) -> np.ndarray:
    """Gaussian depth noise at a level drawn from U(0, level) per image
    (reference core/utils/depth_aug.py:5); depth (H, W), or (H, W, C) with
    the noise shared across channels."""
    noise_level = rng.uniform(0, level)
    gauss = noise_level * rng.standard_normal(depth.shape[:2])
    if depth.ndim == 3:
        gauss = np.repeat(gauss[:, :, None], depth.shape[2], axis=2)
    return (depth + gauss).astype(np.float32)
