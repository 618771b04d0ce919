"""Visualisation helpers (port of self6dpp_tpu/utils/vis.py; reference
lib/vis_utils): image grids, heatmaps, flow as colour, boxes with a
label, projected pose axes. numpy only; the JAX package draws with
OpenCV, which the port does not use, so each drawing step is OpenCV's
own, reproduced:

  - grid_show resizes with data/aug.py::resize_u8 (cv2.resize's uint8
    INTER_LINEAR, bit for bit);
  - heatmap maps through OpenCV's 256-entry JET table;
  - flow_to_rgb converts with data/aug.py::hsv_to_rgb_u8
    (cv2.COLOR_HSV2RGB);
  - draw_bbox's rectangle and draw_pose_axes' lines are OpenCV's thick
    lines (thickness 2, 8-connected): the quadrilateral of the segment
    filled by scanlines in 16.16 fixed point, its outline traced by the
    fixed-point line walk, a radius-1 disc at the end(s) (line: both,
    rectangle: each edge's end);
  - draw_bbox's label blends cv2.putText's glyphs (FONT_HERSHEY_SIMPLEX
    at scale 0.5, thickness 1: OpenCV 5 draws each glyph anti-aliased at
    a whole pixel, blends it into the image glyph after glyph and
    advances the pen by a whole number of pixels), from the fixture
    fixtures/vis/hershey_simplex.npz (each glyph's coverage, offset and
    advance, and the JET table), which tests/test_torch_utils.py::
    make_vis_fixture writes with cv2.

Where a line leaves the image, OpenCV clips it to the image before its
walk, which can move the walk's pixels near the border by one; the port
walks the whole segment and drops the pixels outside. Everywhere else the
pixels are OpenCV's (tests/test_torch_utils.py holds them to cv2).
"""

from __future__ import annotations

import os
from functools import lru_cache

import numpy as np

from ..data.aug import hsv_to_rgb_u8, resize_u8

_FIXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "vis", "hershey_simplex.npz")
_SHIFT = 16
_ONE = 1 << _SHIFT


@lru_cache(maxsize=1)
def _fixture() -> dict:
    """{'jet': (256, 3) BGR uint8, 'glyphs': {char: (alpha (h, w) int,
    dx, dy, advance)}} from the committed fixture: each glyph's coverage
    as cv2.putText draws it, its offset from the pen and the pen's
    advance."""
    f = np.load(_FIXTURE)
    glyphs = {}
    for i, code in enumerate(f["codes"]):
        h, w = (int(v) for v in f["shape"][i])
        o = int(f["offset"][i])
        alpha = f["alpha"][o:o + h * w].reshape(h, w).astype(np.int32)
        glyphs[chr(code)] = (alpha, int(f["dx"][i]), int(f["dy"][i]),
                             int(f["advance"][i]))
    return {"jet": f["jet"], "glyphs": glyphs}


def to_uint8(img: np.ndarray) -> np.ndarray:
    """uint8 as it is; else min-max scaled to [0, 255] and truncated."""
    img = np.asarray(img)
    if img.dtype == np.uint8:
        return img
    lo, hi = float(img.min()), float(img.max())
    if hi - lo < 1e-12:
        return np.zeros_like(img, dtype=np.uint8)
    return ((img - lo) / (hi - lo) * 255).astype(np.uint8)


def grid_show(images: list[np.ndarray], titles: list[str] | None = None,
              ncol: int = 4, pad: int = 2) -> np.ndarray:
    """The images (to_uint8, grey made RGB) resized to the largest cell
    and laid out in a grid of ncol columns with pad pixels between."""
    cells = []
    for im in images:
        im = to_uint8(im)
        if im.ndim == 2:
            im = np.stack([im] * 3, axis=-1)
        cells.append(im[..., :3])
    ch = max(c.shape[0] for c in cells)
    cw = max(c.shape[1] for c in cells)
    cells = [resize_u8(np.ascontiguousarray(c), (cw, ch)) for c in cells]
    ncol = min(ncol, len(cells))
    nrow = -(-len(cells) // ncol)
    grid = np.zeros((nrow * (ch + pad), ncol * (cw + pad), 3), np.uint8)
    for i, c in enumerate(cells):
        r, col = divmod(i, ncol)
        grid[r * (ch + pad):r * (ch + pad) + ch,
             col * (cw + pad):col * (cw + pad) + cw] = c
    return grid


def heatmap(x: np.ndarray) -> np.ndarray:
    """A scalar map as RGB through the JET colormap."""
    return _fixture()["jet"][to_uint8(x)][..., ::-1]


def flow_to_rgb(flow: np.ndarray, max_mag: float | None = None) -> np.ndarray:
    """(H, W, 2) flow -> RGB: the direction as hue, the magnitude (over
    max_mag, default the largest) as value."""
    mag = np.linalg.norm(flow, axis=-1)
    ang = np.arctan2(flow[..., 0], flow[..., 1])      # dh, dw
    mm = max_mag or max(float(mag.max()), 1e-6)
    hsv = np.zeros(flow.shape[:2] + (3,), np.uint8)
    hsv[..., 0] = ((ang + np.pi) / (2 * np.pi) * 179).astype(np.uint8)
    hsv[..., 1] = 255
    hsv[..., 2] = np.clip(mag / mm * 255, 0, 255).astype(np.uint8)
    return hsv_to_rgb_u8(hsv)


# ---------------------------------------------------------------------------
# OpenCV's 8-connected thick line, in its 16.16 fixed point
# ---------------------------------------------------------------------------

def _put(img, color, x, y):
    if 0 <= x < img.shape[1] and 0 <= y < img.shape[0]:
        img[y, x] = color


def _walk(img, color, p1, p2) -> None:
    """The fixed-point line walk between two 16.16 points: one pixel per
    step along the longer axis, the other coordinate stepped by the
    slope, plus the end point."""
    (x1, y1), (x2, y2) = p1, p2
    dx, dy = x2 - x1, y2 - y1
    ax, ay = abs(dx), abs(dy)
    if ax > ay:
        if dx < 0:
            (x1, y1), (x2, y2), dy = (x2, y2), (x1, y1), -dy
        y_step = _cdiv(dy << _SHIFT, ax | 1)
        count = (x2 - x1) >> _SHIFT
    else:
        if dy < 0:
            (x1, y1), (x2, y2), dx = (x2, y2), (x1, y1), -dx
        x_step = _cdiv(dx << _SHIFT, ay | 1)
        count = (y2 - y1) >> _SHIFT
    x1 += _ONE >> 1
    y1 += _ONE >> 1
    _put(img, color, (x2 + (_ONE >> 1)) >> _SHIFT,
         (y2 + (_ONE >> 1)) >> _SHIFT)
    if ax > ay:
        x1 >>= _SHIFT
        while count >= 0:
            _put(img, color, x1, y1 >> _SHIFT)
            x1 += 1
            y1 += y_step
            count -= 1
    else:
        y1 >>= _SHIFT
        while count >= 0:
            _put(img, color, x1 >> _SHIFT, y1)
            x1 += x_step
            y1 += 1
            count -= 1


def _cdiv(a: int, b: int) -> int:
    """C's integer division (toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _fill_convex(img, color, v) -> None:
    """OpenCV's convex polygon fill of 16.16 points v: the outline walked,
    then each scanline between the two edges' rounded x."""
    n = len(v)
    half = _ONE >> 1
    p0 = v[-1]
    for p in v:
        _walk(img, color, p0, p)
        p0 = p
    xs = [p[0] for p in v]
    ys = [p[1] for p in v]
    imin = int(np.argmin(ys))
    xmin, xmax = (min(xs) + half) >> _SHIFT, (max(xs) + half) >> _SHIFT
    ymin, ymax = (min(ys) + half) >> _SHIFT, (max(ys) + half) >> _SHIFT
    h, w = img.shape[:2]
    if n < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = n
    e = [{"idx": imin, "di": 1, "x": -_ONE, "dx": 0, "ye": ymin},
         {"idx": imin, "di": n - 1, "x": -_ONE, "dx": 0, "ye": ymin}]
    y = ymin
    while True:
        for ed in e:
            if y >= ed["ye"]:
                idx0 = ed["idx"]
                idx = (idx0 + ed["di"]) % n
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + half) >> _SHIFT
                    if ty > y:
                        xs0, xe = v[idx0][0], v[idx][0]
                        ed["ye"] = ty
                        ed["dx"] = _cdiv((xe - xs0) * 2 + (ty - y),
                                         2 * (ty - y))
                        ed["x"] = xs0
                        ed["idx"] = idx
                        break
                    idx0 = idx
                    idx = (idx + ed["di"]) % n
        if edges < 0:
            break
        if y >= 0:
            lft, rgt = (e[1], e[0]) if e[0]["x"] > e[1]["x"] else (e[0], e[1])
            x1 = (lft["x"] + half) >> _SHIFT
            x2 = (rgt["x"] + half) >> _SHIFT
            if x2 >= 0 and x1 < w:
                img[y, max(x1, 0):min(x2, w - 1) + 1] = color
        e[0]["x"] += e[0]["dx"]
        e[1]["x"] += e[1]["dx"]
        y += 1
        if y > ymax:
            break


def _disc1(img, color, x, y) -> None:
    """OpenCV's filled circle of radius 1: the centre and its 4
    neighbours."""
    for xx, yy in ((x - 1, y), (x, y), (x + 1, y), (x, y - 1), (x, y + 1)):
        _put(img, color, xx, yy)


def _thick_line(img, color, p0, p1, caps: tuple[bool, bool]) -> None:
    """OpenCV's line of thickness 2 between integer points p0 and p1,
    with a radius-1 disc at each end whose cap is set."""
    a = (int(p0[0]) << _SHIFT, int(p0[1]) << _SHIFT)
    b = (int(p1[0]) << _SHIFT, int(p1[1]) << _SHIFT)
    dx = (a[0] - b[0]) / _ONE
    dy = (b[1] - a[1]) / _ONE
    r = dx * dx + dy * dy
    if abs(r) > np.finfo(np.float64).eps:
        r = _ONE / np.sqrt(r)
        ox, oy = int(round(dy * r)), int(round(dx * r))
        _fill_convex(img, color, [(a[0] + ox, a[1] + oy),
                                  (a[0] - ox, a[1] - oy),
                                  (b[0] - ox, b[1] - oy),
                                  (b[0] + ox, b[1] + oy)])
    for end, cap in zip((p0, p1), caps):
        if cap:
            _disc1(img, color, int(end[0]), int(end[1]))


def _text(img, color, text: str, org) -> None:
    """cv2.putText(img, text, org, FONT_HERSHEY_SIMPLEX, 0.5, color, 1)
    from the glyph fixture (any character outside ' '..'~' as '?'): glyph
    after glyph, each pixel blended as OpenCV 5 blends its coverage a:
    (old * (255 - a) + color * a + 127) // 255 per channel."""
    glyphs = _fixture()["glyphs"]
    x, y0 = int(org[0]), int(org[1])
    h, w = img.shape[:2]
    col = np.asarray(color, np.int32)
    for ch in text:
        alpha, dx, dy, adv = glyphs.get(ch, glyphs["?"])
        ys, xs = np.nonzero(alpha >= 0)
        a = alpha[ys, xs]
        ys, xs = ys + y0 + dy, xs + x + dx
        ok = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        ys, xs, a = ys[ok], xs[ok], a[ok]
        if img.ndim == 3:
            a = a[:, None]
        old = img[ys, xs].astype(np.int32)
        img[ys, xs] = ((old * (255 - a) + col * a + 127) // 255).astype(
            np.uint8)
        x += adv


def draw_bbox(img: np.ndarray, box, color=(0, 255, 0), text: str = "",
              thickness: int = 2) -> np.ndarray:
    """A copy of the image (to_uint8) with the box (x1, y1, x2, y2) drawn
    at thickness 2 and the label above it."""
    if thickness != 2:
        raise ValueError("draw_bbox draws OpenCV's thickness 2 only")
    out = to_uint8(img).copy()
    x1, y1, x2, y2 = [int(v) for v in box]
    col = np.asarray(color, np.uint8)[:out.shape[2]] if out.ndim == 3 \
        else color[0]
    pts = [(x1, y1), (x2, y1), (x2, y2), (x1, y2)]
    for i in range(4):
        _thick_line(out, col, pts[i - 1], pts[i], (False, True))
    if text:
        _text(out, col, text, (x1, max(y1 - 4, 10)))
    return out


def draw_pose_axes(img: np.ndarray, K: np.ndarray, R: np.ndarray,
                   t: np.ndarray, length: float = 0.05) -> np.ndarray:
    """A copy of the image (to_uint8) with the object frame's x, y and z
    axes projected at the pose (red, green, blue), thickness 2."""
    out = to_uint8(img).copy()
    pts = np.float32([[0, 0, 0], [length, 0, 0], [0, length, 0],
                      [0, 0, length]])
    cam = pts @ R.T + t
    uv = cam @ K.T
    uv = (uv[:, :2] / uv[:, 2:3]).astype(int)
    for i, color in enumerate([(255, 0, 0), (0, 255, 0), (0, 0, 255)]):
        _thick_line(out, np.asarray(color, np.uint8), uv[0], uv[i + 1],
                    (True, True))
    return out
