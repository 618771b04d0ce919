"""The YOLOv4 detector's data pipeline (port of
self6dpp_tpu/data/det_loader.py): mosaic, random affine, HSV jitter and
flips for training, the no-scale-up letterbox for evaluation, and the
fixed-shape batches

    images  (B, S, S, 3) float32 RGB in [0, 1]
    targets (B, M, 5)    [cls, cx, cy, w, h] in pixels of the S x S frame
    valid   (B, M)       bool

The JAX package augments with OpenCV on uint8 images; the port takes
data/aug.py's bit-exact uint8 reproductions (resize_u8, warp_affine_u8,
rotation_matrix_2d, rgb_to_hsv_u8, hsv_to_rgb_u8) and the same
np.random.Generator draws in the same order, so one seed gives the JAX
loader's samples. The loader is a plain generator on the host, as in the
JAX package (no worker threads).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass

import numpy as np

from ..parallel.dist import rank, world_size
from .aug import (hsv_to_rgb_u8, resize_u8, rgb_to_hsv_u8,
                  rotation_matrix_2d, warp_affine_u8)
from .bop import Record
from .image_io import imread

_FILL = 114  # canvas gray of the letterbox, the mosaic and the affine


# ---------------------------------------------------------------------------
# geometric primitives
# ---------------------------------------------------------------------------

def load_resize_image(path: str, img_size: int, train: bool
                      ) -> tuple[np.ndarray, tuple[int, int]]:
    """RGB uint8 resized so that max(h, w) == img_size (linear in
    training, area in evaluation); returns (img, (h0, w0)), the original
    size."""
    img = imread(path, "color")
    h0, w0 = img.shape[:2]
    r = img_size / max(h0, w0)
    if r != 1.0:
        img = resize_u8(img, (int(round(w0 * r)), int(round(h0 * r))),
                        "linear" if train else "area")
    return np.ascontiguousarray(img), (h0, w0)


def letterbox(img: np.ndarray, size: int, scaleup: bool = True
              ) -> tuple[np.ndarray, float, tuple[float, float]]:
    """The image centred on a size x size gray canvas, aspect kept.
    Returns (canvas, ratio, (padw, padh)); a canvas point maps back to the
    original by (x - padw) / ratio."""
    h, w = img.shape[:2]
    r = size / max(h, w)
    if not scaleup:
        r = min(r, 1.0)
    nw, nh = int(round(w * r)), int(round(h * r))
    if (nw, nh) != (w, h):
        img = resize_u8(img, (nw, nh), "linear")
    padw, padh = (size - nw) / 2, (size - nh) / 2
    top = int(round(padh - 0.1))
    left = int(round(padw - 0.1))
    canvas = np.full((size, size, 3), _FILL, np.uint8)
    canvas[top:top + nh, left:left + nw] = img
    return canvas, r, (left, top)


def random_affine(img: np.ndarray, labels: np.ndarray, *,
                  degrees: float = 0.0, translate: float = 0.0,
                  scale: float = 0.5, shear: float = 0.0,
                  border: tuple[int, int] = (0, 0),
                  rng: np.random.Generator) -> tuple[np.ndarray, np.ndarray]:
    """Random rotation, scale, translation and shear of the image and its
    (N, 5) [cls, x1, y1, x2, y2] labels. A box that degenerates (w or h <=
    2 px, area shrunk over 5x, aspect >= 20) is dropped; border < 0 shrinks
    the canvas (the mosaic's 2S -> S)."""
    height = img.shape[0] + border[0] * 2
    width = img.shape[1] + border[1] * 2

    a = rng.uniform(-degrees, degrees)
    s = rng.uniform(1 - scale, 1 + scale)
    R = np.eye(3)
    R[:2] = rotation_matrix_2d((img.shape[1] / 2, img.shape[0] / 2), a, s)
    T = np.eye(3)
    T[0, 2] = rng.uniform(-translate, translate) * img.shape[1] + border[1]
    T[1, 2] = rng.uniform(-translate, translate) * img.shape[0] + border[0]
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(rng.uniform(-shear, shear)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-shear, shear)))
    M = S @ T @ R
    if border != (0, 0) or not np.allclose(M, np.eye(3)):
        img = warp_affine_u8(img, M[:2], (width, height), _FILL)

    n = len(labels)
    if n == 0:
        return img, labels.reshape(0, 5)
    # warp the 4 corners of every box, refit axis-aligned boxes
    corners = np.ones((n * 4, 3))
    corners[:, :2] = labels[:, [1, 2, 3, 4, 1, 4, 3, 2]].reshape(n * 4, 2)
    warped = (corners @ M.T)[:, :2].reshape(n, 8)
    xs, ys = warped[:, 0::2], warped[:, 1::2]
    new = np.stack([xs.min(1), ys.min(1), xs.max(1), ys.max(1)], axis=1)
    new[:, [0, 2]] = new[:, [0, 2]].clip(0, width)
    new[:, [1, 3]] = new[:, [1, 3]].clip(0, height)
    w = new[:, 2] - new[:, 0]
    h = new[:, 3] - new[:, 1]
    area0 = (labels[:, 3] - labels[:, 1]) * (labels[:, 4] - labels[:, 2])
    ar = np.maximum(w / (h + 1e-16), h / (w + 1e-16))
    keep = (w > 2) & (h > 2) & (w * h / (area0 * s + 1e-16) > 0.2) & (ar < 20)
    out = labels[keep].copy()
    out[:, 1:5] = new[keep]
    return img, out


def augment_hsv(img: np.ndarray, *, hgain: float = 0.015, sgain: float = 0.7,
                vgain: float = 0.4, rng: np.random.Generator) -> np.ndarray:
    """Random HSV jitter of an RGB uint8 image through per-channel lookup
    tables. Returns a new array."""
    r = rng.uniform(-1, 1, 3) * [hgain, sgain, vgain] + 1
    hsv = rgb_to_hsv_u8(img)
    x = np.arange(256, dtype=np.int16)
    lut_h = ((x * r[0]) % 180).astype(np.uint8)
    lut_s = np.clip(x * r[1], 0, 255).astype(np.uint8)
    lut_v = np.clip(x * r[2], 0, 255).astype(np.uint8)
    hsv = np.stack([lut_h[hsv[..., 0]], lut_s[hsv[..., 1]],
                    lut_v[hsv[..., 2]]], -1)
    return hsv_to_rgb_u8(hsv)


# ---------------------------------------------------------------------------
# record -> labels
# ---------------------------------------------------------------------------

def record_labels(rec: Record, class_of_obj_id) -> np.ndarray:
    """(N, 5) [cls, x1, y1, x2, y2] in the original image frame."""
    rows = [[class_of_obj_id(inst.obj_id), *np.asarray(inst.bbox_visib, float)]
            for inst in rec.instances]
    return np.asarray(rows, np.float32).reshape(-1, 5)


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class EvalShapes:
    """The letterbox geometry that maps detections back to the original
    frame."""
    orig_hw: tuple[int, int]
    ratio: float
    pad: tuple[float, float]

    def to_original(self, boxes_xyxy: np.ndarray) -> np.ndarray:
        out = np.asarray(boxes_xyxy, np.float32).copy()
        if out.size:
            out[:, [0, 2]] = (out[:, [0, 2]] - self.pad[0]) / self.ratio
            out[:, [1, 3]] = (out[:, [1, 3]] - self.pad[1]) / self.ratio
            out[:, [0, 2]] = out[:, [0, 2]].clip(0, self.orig_hw[1])
            out[:, [1, 3]] = out[:, [1, 3]].clip(0, self.orig_hw[0])
        return out


class DetDataset:
    """Train and eval samples over BOP records. Train: the 4-image mosaic
    (optional), the random affine, the HSV jitter and the flips, as
    fixed-shape (img, targets, valid). Eval: the no-scale-up letterbox, its
    EvalShapes and the ground truth in the original frame. `timings` gets
    one {'host_s'} per batch: the seconds spent building it."""

    def __init__(self, records: list[Record], det_cfg, class_of_obj_id,
                 train: bool, seed: int = 0):
        self.records = records
        self.cfg = det_cfg
        self.class_of = class_of_obj_id
        self.train = train
        self.rng = np.random.default_rng(seed)
        self.timings: list[dict] = []

    def __len__(self) -> int:
        return len(self.records)

    def _load_scaled(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """The image resized to max side S and its labels in that frame."""
        rec = self.records[idx]
        img, (h0, w0) = load_resize_image(rec.file_name, self.cfg.input_size,
                                          self.train)
        labels = record_labels(rec, self.class_of)
        h, w = img.shape[:2]
        labels[:, [1, 3]] *= w / w0
        labels[:, [2, 4]] *= h / h0
        return img, labels

    def _mosaic4(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        """4-image mosaic on a 2S x 2S canvas around a random centre, then
        the border affine back to S x S."""
        s = self.cfg.input_size
        yc = int(self.rng.uniform(s // 2, 2 * s - s // 2))
        xc = int(self.rng.uniform(s // 2, 2 * s - s // 2))
        indices = [idx] + list(self.rng.integers(0, len(self.records), 3))
        canvas = np.full((2 * s, 2 * s, 3), _FILL, np.uint8)
        labels4 = []
        for i, index in enumerate(indices):
            img, labels = self._load_scaled(index)
            h, w = img.shape[:2]
            if i == 0:    # top left: the image's bottom right at (xc, yc)
                x1a, y1a, x2a, y2a = max(xc - w, 0), max(yc - h, 0), xc, yc
            elif i == 1:  # top right
                x1a, y1a, x2a, y2a = xc, max(yc - h, 0), min(xc + w, 2 * s), yc
            elif i == 2:  # bottom left
                x1a, y1a, x2a, y2a = max(xc - w, 0), yc, xc, min(yc + h, 2 * s)
            else:         # bottom right
                x1a, y1a, x2a, y2a = xc, yc, min(xc + w, 2 * s), min(yc + h, 2 * s)
            if x2a <= x1a or y2a <= y1a:
                continue
            # the source crop anchored at the corner facing the centre
            if i == 0:
                x1b, y1b = w - (x2a - x1a), h - (y2a - y1a)
            elif i == 1:
                x1b, y1b = 0, h - (y2a - y1a)
            elif i == 2:
                x1b, y1b = w - (x2a - x1a), 0
            else:
                x1b, y1b = 0, 0
            x2b, y2b = x1b + (x2a - x1a), y1b + (y2a - y1a)
            canvas[y1a:y2a, x1a:x2a] = img[y1b:y2b, x1b:x2b]
            if len(labels):
                shifted = labels.copy()
                shifted[:, [1, 3]] += x1a - x1b
                shifted[:, [2, 4]] += y1a - y1b
                labels4.append(shifted)
        labels4 = (np.concatenate(labels4, 0) if labels4
                   else np.zeros((0, 5), np.float32))
        labels4[:, 1:] = labels4[:, 1:].clip(0, 2 * s)
        return random_affine(
            canvas, labels4, degrees=self.cfg.rand_rotate_deg,
            translate=self.cfg.rand_translate, scale=self.cfg.rand_scale,
            shear=self.cfg.rand_shear, border=(-s // 2, -s // 2),
            rng=self.rng)

    def train_sample(self, idx: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        cfg = self.cfg
        s = cfg.input_size
        if cfg.aug_mosaic:
            img, labels = self._mosaic4(idx)
        else:
            img, labels = self._load_scaled(idx)
            img, ratio, pad = letterbox(img, s, scaleup=True)
            if len(labels):
                labels = labels.copy()
                labels[:, [1, 3]] = labels[:, [1, 3]] * ratio + pad[0]
                labels[:, [2, 4]] = labels[:, [2, 4]] * ratio + pad[1]
            img, labels = random_affine(
                img, labels, degrees=cfg.rand_rotate_deg,
                translate=cfg.rand_translate, scale=cfg.rand_scale,
                shear=cfg.rand_shear, rng=self.rng)
        if self.rng.random() < cfg.aug_hsv_prob:
            img = augment_hsv(img, hgain=cfg.hsv_h, sgain=cfg.hsv_s,
                              vgain=cfg.hsv_v, rng=self.rng)
        if cfg.rand_hflip and self.rng.random() < 0.5:
            img = np.ascontiguousarray(img[:, ::-1])
            if len(labels):
                labels[:, [1, 3]] = s - labels[:, [3, 1]]
        if cfg.rand_vflip and self.rng.random() < 0.5:
            img = np.ascontiguousarray(img[::-1])
            if len(labels):
                labels[:, [2, 4]] = s - labels[:, [4, 2]]

        tgt = np.zeros((cfg.max_objs, 5), np.float32)
        valid = np.zeros((cfg.max_objs,), bool)
        n = min(len(labels), cfg.max_objs)
        if n:
            lb = labels[:n]
            tgt[:n, 0] = lb[:, 0]
            tgt[:n, 1] = (lb[:, 1] + lb[:, 3]) / 2
            tgt[:n, 2] = (lb[:, 2] + lb[:, 4]) / 2
            tgt[:n, 3] = lb[:, 3] - lb[:, 1]
            tgt[:n, 4] = lb[:, 4] - lb[:, 2]
            valid[:n] = True
        return img.astype(np.float32) / 255.0, tgt, valid

    def eval_sample(self, idx: int) -> tuple[np.ndarray, EvalShapes, np.ndarray]:
        rec = self.records[idx]
        img, (h0, w0) = load_resize_image(rec.file_name, self.cfg.input_size,
                                          train=False)
        # the max-side pre-resize folded into the ratio, so one factor maps
        # canvas -> original
        pre = img.shape[0] / h0 if h0 >= w0 else img.shape[1] / w0
        img, r, pad = letterbox(img, self.cfg.input_size, scaleup=False)
        shapes = EvalShapes(orig_hw=(h0, w0), ratio=r * pre,
                            pad=(float(pad[0]), float(pad[1])))
        return img.astype(np.float32) / 255.0, shapes, \
            record_labels(rec, self.class_of)

    def train_batches(self, batch_size: int):
        """Infinite shuffled fixed-shape batches; under data parallel
        (parallel/dist.py) rank r of W takes order[r::W] of each epoch's
        order, which every rank draws alike."""
        while True:
            order = self.rng.permutation(len(self.records))
            order = order[rank():: world_size()]
            for i in range(0, len(order) - batch_size + 1, batch_size):
                t0 = time.perf_counter()
                samples = [self.train_sample(int(j))
                           for j in order[i:i + batch_size]]
                imgs, tgts, valids = zip(*samples)
                batch = (np.stack(imgs), np.stack(tgts), np.stack(valids))
                self.timings.append({"host_s": time.perf_counter() - t0})
                yield batch

    def eval_batches(self, batch_size: int):
        """One pass; the last batch padded by repeating the final record
        (only the real entries' shapes, ground truth and records come
        with it)."""
        n = len(self.records)
        for i in range(0, n, batch_size):
            t0 = time.perf_counter()
            idxs = list(range(i, min(i + batch_size, n)))
            real = len(idxs)
            while len(idxs) < batch_size:
                idxs.append(idxs[-1])
            samples = [self.eval_sample(j) for j in idxs]
            imgs, shapes, gts = zip(*samples)
            batch = (np.stack(imgs), list(shapes)[:real], list(gts)[:real],
                     [self.records[j] for j in idxs[:real]])
            self.timings.append({"host_s": time.perf_counter() - t0})
            yield batch
