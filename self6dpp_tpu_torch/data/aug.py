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

The detector's loader (data/det_loader.py) works on uint8 images, where
OpenCV computes otherwise: resize_u8 (INTER_LINEAR and INTER_AREA, up and
down), warp_affine_u8 (any affine, a constant border), rotation_matrix_2d,
rgb_to_hsv_u8 and hsv_to_rgb_u8 reproduce OpenCV 5.0's uint8 paths bit for
bit (tests/test_torch_det_loader.py holds each against cv2). Where OpenCV
splits a row between vector steps and a scalar tail that round otherwise,
the split is that of its AVX2 build.
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


# ---------------------------------------------------------------------------
# OpenCV's uint8 paths (the detector's loader, data/det_loader.py)
# ---------------------------------------------------------------------------

RESIZE_COEF = 2048          # INTER_RESIZE_COEF_SCALE: 11-bit resize weights
HSV_SHIFT = 12              # the fixed point of the RGB -> HSV tables
HSV_VEC = 32                # pixels per vector step of HSV -> RGB (AVX2)
WARP_VEC = 16               # pixels per vector step of the uint8 warp (AVX2)


def _resize_weights(a: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(1 - a, a) of float32 fractions as 11-bit integers, each rounded
    half to even (saturate_cast<short>)."""
    one = _F32(1)
    return (np.rint((one - a) * _F32(RESIZE_COEF)).astype(np.int64),
            np.rint(a * _F32(RESIZE_COEF)).astype(np.int64))


def _u8_linear_taps(n_src: int, n_dst: int, area: bool):
    """OpenCV's source index and float32 fraction along one axis for the
    linear resize (f = (d + 0.5) · scale - 0.5 rounded to float32) or for
    INTER_AREA upscaling (s = floor(d · scale), a = (d + 1) - (s + 1) /
    scale, wrapped into [0, 1) and 0 where not positive); scale = n_src /
    n_dst as 1 / (n_dst / n_src) in float64."""
    inv = n_dst / n_src
    scale = 1.0 / inv
    d = np.arange(n_dst, dtype=np.float64)
    if area:
        s = np.floor(d * scale).astype(np.int64)
        a = ((d + 1) - (s + 1) * inv).astype(_F32)
        a = np.where(a <= 0, _F32(0), a - np.floor(a)).astype(_F32)
    else:
        f = ((d + 0.5) * scale - 0.5).astype(_F32)
        s = np.floor(f).astype(np.int64)
        a = (f - s.astype(_F32)).astype(_F32)
    return s, a


def _resize_u8_linear(img: np.ndarray, dw: int, dh: int, area: bool
                      ) -> np.ndarray:
    h, w = img.shape[:2]
    sx, ax = _u8_linear_taps(w, dw, area)
    sy, ay = _u8_linear_taps(h, dh, area)
    # columns past an edge take the edge pixel at weight (1, 0)
    ax[(sx < 0) | (sx >= w - 1)] = 0
    sx = np.clip(sx, 0, w - 1)
    a0, a1 = _resize_weights(ax)
    # rows past an edge read the edge row twice and keep their weights
    b0, b1 = _resize_weights(ay)
    y0, y1 = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    px = np.asarray(img, np.int64)
    cext = (None, slice(None)) + (None,) * (img.ndim - 2)
    row = px[:, sx] * a0[cext] + px[:, np.minimum(sx + 1, w - 1)] * a1[cext]
    rext = (slice(None),) + (None,) * (img.ndim - 1)
    # the vertical pass of VResizeLinearVec_32s8u: 16-bit high products of
    # the rows shifted right by 4, then (t0 + t1 + 2) >> 2
    out = (((b0[rext] * (row[y0] >> 4)) >> 16)
           + ((b1[rext] * (row[y1] >> 4)) >> 16) + 2) >> 2
    return out.astype(np.uint8)


def _area_table(n_src: int, n_dst: int) -> tuple[np.ndarray, np.ndarray]:
    """computeResizeAreaTab: per destination pixel its source indices and
    float32 weights, in OpenCV's order, padded with weight 0."""
    scale = 1.0 / (n_dst / n_src)
    rows = []
    for d in range(n_dst):
        f1 = d * scale
        f2 = f1 + scale
        cell = min(scale, n_src - f1)
        s1, s2 = int(np.ceil(f1)), int(np.floor(f2))
        s2 = min(s2, n_src - 1)
        s1 = min(s1, s2)
        taps = []
        if s1 - f1 > 1e-3:
            taps.append((s1 - 1, (s1 - f1) / cell))
        taps += [(s, 1.0 / cell) for s in range(s1, s2)]
        if f2 - s2 > 1e-3:
            taps.append((s2, min(min(f2 - s2, 1.0), cell) / cell))
        rows.append(taps)
    k = max(len(t) for t in rows)
    idx = np.zeros((n_dst, k), np.int64)
    wgt = np.zeros((n_dst, k), _F32)
    for d, taps in enumerate(rows):
        for j, (s, a) in enumerate(taps):
            idx[d, j], wgt[d, j] = s, a
    return idx, wgt


def _resize_u8_area_down(img: np.ndarray, dw: int, dh: int) -> np.ndarray:
    """ResizeArea_Invoker: each source row's weighted taps summed in
    float32 in table order, the rows summed likewise with their weights,
    rounded half to even."""
    h, w = img.shape[:2]
    xi, xw = _area_table(w, dw)
    yi, yw = _area_table(h, dh)
    src = np.asarray(img, _F32)
    src = src[..., None] if img.ndim == 2 else src
    buf = np.zeros((h, dw, src.shape[2]), _F32)
    for j in range(xi.shape[1]):
        buf = buf + src[:, xi[:, j]] * xw[None, :, j, None]
    out = yw[:, 0, None, None] * buf[yi[:, 0]]
    for j in range(1, yi.shape[1]):
        out = out + yw[:, j, None, None] * buf[yi[:, j]]
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out[..., 0] if img.ndim == 2 else out


def resize_u8(img: np.ndarray, dsize: tuple[int, int],
              interpolation: str = "linear") -> np.ndarray:
    """cv2.resize(img, dsize, interpolation=INTER_LINEAR or INTER_AREA) of a
    uint8 image (H, W[, C]), bit for bit with OpenCV 5.0; dsize = (width,
    height).
      * INTER_LINEAR, and INTER_AREA when it upscales: 11-bit fixed-point
        weights (the area mode's own fractions), the horizontal pass in
        integers, the vertical pass as its vector kernel rounds it; rows
        past an edge keep their weights and read the edge row twice;
      * an exact halving of both sides (either mode): (sum of 2x2 + 2) >> 2;
      * INTER_AREA downscaling: the area table's float32 weights summed
        along x, then y, rounded half to even."""
    if interpolation not in ("linear", "area"):
        raise ValueError(f"unknown interpolation: {interpolation!r}")
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise TypeError(f"resize_u8 takes uint8 images: {img.dtype}")
    h, w = img.shape[:2]
    dw, dh = dsize
    if (dw, dh) == (w, h):
        return img.copy()
    if w == 2 * dw and h == 2 * dh:
        px = img.astype(np.int32)
        s = px[0::2, 0::2] + px[0::2, 1::2] + px[1::2, 0::2] + px[1::2, 1::2]
        return ((s + 2) >> 2).astype(np.uint8)
    if interpolation == "area" and dw <= w and dh <= h:
        return _resize_u8_area_down(img, dw, dh)
    return _resize_u8_linear(img, dw, dh, interpolation == "area")


def rotation_matrix_2d(center: tuple[float, float], angle: float,
                       scale: float) -> np.ndarray:
    """cv2.getRotationMatrix2D(center, angle, scale): 2x3 float64, the
    centre rounded to float32 (a Point2f) first."""
    cx, cy = float(_F32(center[0])), float(_F32(center[1]))
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def warp_affine_u8(src: np.ndarray, M: np.ndarray, dsize: tuple[int, int],
                   border_value: int = 0) -> np.ndarray:
    """cv2.warpAffine(src, M, dsize, flags=INTER_LINEAR,
    borderValue=(v, v, v)) of a uint8 image (H, W, 3), any affine M (source
    to destination), bit for bit with OpenCV 5.0's uint8 kernel: M inverted
    in float64 and rounded to float32; the source coordinate of (x, y) is
    fma(M0, x, M1·y + M2) on the columns of whole 16-pixel vector steps of
    each row and fma(x, M0, M1·y) + M2 on the rest (the scalar tail);
    neighbours outside the image read the border value; the four are
    blended by float32 lerps (fma, x first) and rounded half to even."""
    img = np.asarray(src)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise TypeError(f"warp_affine_u8 takes uint8 (H, W, C): "
                        f"{img.dtype} {img.shape}")
    m = invert_affine(M).astype(_F32).reshape(-1)
    w, h = dsize
    xs = np.arange(w, dtype=_F32)[None, :]
    ys = np.arange(h, dtype=_F32)[:, None]
    vec = np.arange(w)[None, :] < w - w % WARP_VEC
    sx = np.where(vec, _fma(m[0], xs, m[1] * ys + m[2]),
                  _fma(xs, m[0], m[1] * ys) + m[2])
    sy = np.where(vec, _fma(m[3], xs, m[4] * ys + m[5]),
                  _fma(xs, m[3], m[4] * ys) + m[5])
    fx, fy = np.floor(sx), np.floor(sy)
    ax, ay = (sx - fx)[..., None], (sy - fy)[..., None]
    X, Y = fx.astype(np.int64), fy.astype(np.int64)
    hs, ws = img.shape[:2]
    p = np.pad(img.astype(_F32), ((1, 1), (1, 1), (0, 0)),
               constant_values=border_value)
    cx0, cx1 = np.clip(X, -1, ws) + 1, np.clip(X + 1, -1, ws) + 1
    cy0, cy1 = np.clip(Y, -1, hs) + 1, np.clip(Y + 1, -1, hs) + 1
    p00, p01, p10, p11 = p[cy0, cx0], p[cy0, cx1], p[cy1, cx0], p[cy1, cx1]
    t0 = _fma(ax, p01 - p00, p00)
    t1 = _fma(ax, p11 - p10, p10)
    return np.clip(np.rint(_fma(ay, t1 - t0, t0)), 0, 255).astype(np.uint8)


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_RGB2HSV) of uint8 (..., 3), bit for bit:
    OpenCV's integer tables sdiv[v] = round(255·4096 / v) and hdiv[d] =
    round(180·4096 / (6 d)), H in [0, 180)."""
    i = np.arange(1, 256, dtype=np.float64)
    sdiv = np.zeros(256, np.int64)
    hdiv = np.zeros(256, np.int64)
    sdiv[1:] = np.rint((255 << HSV_SHIFT) / i)
    hdiv[1:] = np.rint((180 << HSV_SHIFT) / (6.0 * i))
    x = np.asarray(img, np.int64)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    diff = v - np.minimum(np.minimum(r, g), b)
    half = 1 << (HSV_SHIFT - 1)
    s = (diff * sdiv[v] + half) >> HSV_SHIFT
    hue = np.where(v == r, g - b,
                   np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    hue = (hue * hdiv[diff] + half) >> HSV_SHIFT
    hue = np.where(hue < 0, hue + 180, hue)
    return np.stack([hue, s, v], -1).astype(np.uint8)


# OpenCV's sector table: the tab[] index of b, g, r per hue sector
_HSV_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                         [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb_u8(img: np.ndarray) -> np.ndarray:
    """cv2.cvtColor(img, cv2.COLOR_HSV2RGB) of uint8 (H, W, 3), bit for bit
    with OpenCV 5.0 on AVX2: s and v times 1/255 and h times 6/180 in
    float32, the tab of v·(1 - s), v·(1 - s·h) and v·(1 - s·(1 - h)) with
    the inner products fused, then times 255. The columns of whole
    32-pixel vector steps of each row take the sector by truncation and
    truncate the result; the scalar tail takes fmod(h, 6) and floor and
    rounds half to even."""
    x = np.asarray(img)
    if x.dtype != np.uint8 or x.ndim != 3:
        raise TypeError(f"hsv_to_rgb_u8 takes uint8 (H, W, 3): "
                        f"{x.dtype} {x.shape}")
    one = _F32(1)
    s = x[..., 1].astype(_F32) * _F32(1 / 255.0)
    v = x[..., 2].astype(_F32) * _F32(1 / 255.0)
    hs = x[..., 0].astype(_F32) * _F32(6.0 / 180)
    w = x.shape[1]
    vec = np.arange(w)[None, :] < w - w % HSV_VEC
    # vector steps: sector = trunc(h) mod 6 by truncation
    pre = np.trunc(hs)
    sec_v = (pre - np.trunc(pre * _F32(1 / 6.0)) * _F32(6)).astype(np.int64)
    # scalar tail: fmod, floor, a sector out of range is 0 with h = 0
    hm = np.fmod(hs, _F32(6)).astype(_F32)
    sec_s = np.floor(hm).astype(np.int64)
    frac_s = (hm - sec_s).astype(_F32)
    bad = (sec_s < 0) | (sec_s >= 6)
    sec_s[bad], frac_s[bad] = 0, 0
    sector = np.where(vec, sec_v, sec_s)
    frac = np.where(vec, (hs - pre).astype(_F32), frac_s)
    tab = np.stack([v, v * (one - s), v * _fma(-s, frac, one),
                    v * _fma(-s, one - frac, one)], -1)
    bgr = np.take_along_axis(tab, _HSV_SECTORS[sector], -1)
    out = bgr[..., ::-1] * _F32(255)
    out = np.where(vec[..., None], np.trunc(out), np.rint(out))
    return np.clip(out, 0, 255).astype(np.uint8)
