"""The port's detector data pipeline (self6dpp_tpu_torch/data/det_loader.py)
and its OpenCV uint8 reproductions (data/aug.py) against cv2 and the JAX
package's loader, on the CPU.

  * resize_u8 (INTER_LINEAR and INTER_AREA, up and down, odd sizes, the
    exact halving), warp_affine_u8 (rotation, scale, shear, translation,
    border 114, widths that leave a scalar tail), rotation_matrix_2d and
    the HSV conversions (both directions, every width split between vector
    steps and the tail) equal cv2's bit for bit on random uint8 images;
  * DetDataset's train samples (mosaic on and off, HSV, flips, rotation
    and shear) and eval samples with their EvalShapes equal the JAX
    loader's bit for bit on the port's synthetic set
    (data/synthetic_bop.py), from the same seed, and so do the batches of
    train_batches and eval_batches.
"""

import dataclasses
import math

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from self6dpp_tpu.config.base import DetConfig as JDetConfig
from self6dpp_tpu.data import bop as jbop
from self6dpp_tpu.data import det_loader as JD
from self6dpp_tpu_torch.config import DetConfig
from self6dpp_tpu_torch.data import aug as A
from self6dpp_tpu_torch.data import bop as tbop
from self6dpp_tpu_torch.data import det_loader as TD

RESIZES = [(120, 160, 480, 640), (37, 53, 101, 77), (480, 640, 120, 160),
           (31, 45, 17, 22), (120, 160, 48, 64), (120, 160, 60, 80),
           (99, 99, 33, 33), (5, 7, 64, 48), (121, 161, 96, 128),
           (1, 5, 3, 9)]


@pytest.mark.parametrize("interp", ["linear", "area"])
@pytest.mark.parametrize("channels", [1, 3])
def test_resize_u8_is_cv2(interp, channels):
    rng = np.random.default_rng(channels)
    flag = cv2.INTER_LINEAR if interp == "linear" else cv2.INTER_AREA
    for h, w, dh, dw in RESIZES:
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, (dw, dh), interpolation=flag)
        got = A.resize_u8(img, (dw, dh), interp)
        assert got.dtype == np.uint8 and got.shape == want.shape
        assert np.array_equal(got, want), (h, w, dh, dw)


def _affine(rng, w, h):
    R = np.eye(3)
    R[:2] = cv2.getRotationMatrix2D(angle=rng.uniform(-40, 40),
                                    center=(w / 2, h / 2),
                                    scale=rng.uniform(0.5, 1.5))
    T = np.eye(3)
    T[:2, 2] = rng.uniform(-30, 30, 2)
    S = np.eye(3)
    S[0, 1] = math.tan(math.radians(rng.uniform(-10, 10)))
    S[1, 0] = math.tan(math.radians(rng.uniform(-10, 10)))
    return (S @ T @ R)[:2]


def test_warp_affine_u8_is_cv2():
    rng = np.random.default_rng(0)
    for _ in range(24):
        h, w = rng.integers(10, 160, 2)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        M = _affine(rng, w, h)
        dw, dh = int(rng.integers(1, 160)), int(rng.integers(1, 160))
        want = cv2.warpAffine(img, M, dsize=(dw, dh), flags=cv2.INTER_LINEAR,
                              borderValue=(114, 114, 114))
        assert np.array_equal(A.warp_affine_u8(img, M, (dw, dh), 114), want)


def test_rotation_matrix_is_cv2():
    rng = np.random.default_rng(1)
    for _ in range(50):
        c = tuple(rng.uniform(0, 700, 2) / 2)
        a, s = rng.uniform(-180, 180), rng.uniform(0.2, 2)
        want = cv2.getRotationMatrix2D(angle=a, center=c, scale=s)
        assert np.array_equal(A.rotation_matrix_2d(c, a, s), want)


@pytest.mark.parametrize("width", [1, 7, 31, 32, 33, 65, 161])
def test_hsv_u8_is_cv2(width):
    rng = np.random.default_rng(width)
    img = rng.integers(0, 256, (64, width, 3), dtype=np.uint8)
    hsv = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    assert np.array_equal(A.rgb_to_hsv_u8(img), hsv)
    assert np.array_equal(A.hsv_to_rgb_u8(hsv),
                          cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))
    # hues past 180 (the sectors wrap) and the grays (s = 0)
    img[..., 1] = np.where(rng.random((64, width)) < 0.1, 0, img[..., 1])
    assert np.array_equal(A.hsv_to_rgb_u8(img),
                          cv2.cvtColor(img, cv2.COLOR_HSV2RGB))


def test_hsv_u8_is_cv2_on_every_color():
    """Every RGB triple through RGB -> HSV, every HSV triple with a hue below
    180 (the jitter's tables) through HSV -> RGB, in rows of 96 pixels
    (three vector steps) and of 1 (the scalar tail alone)."""
    v = np.arange(256, dtype=np.uint8)
    rgb = np.stack(np.meshgrid(v, v, v, indexing="ij"), -1).reshape(-1, 3)
    img = rgb.reshape(-1, 128, 3)
    assert np.array_equal(A.rgb_to_hsv_u8(img),
                          cv2.cvtColor(img, cv2.COLOR_RGB2HSV))
    hsv = rgb[rgb[:, 0] < 180]
    for w in (96, 1):
        x = hsv.reshape(-1, w, 3)
        assert np.array_equal(A.hsv_to_rgb_u8(x),
                              cv2.cvtColor(x, cv2.COLOR_HSV2RGB)), w


# ------------------------------------------------------------------ loader
@pytest.fixture(scope="module")
def records(tmp_path_factory):
    from self6dpp_tpu_torch.data.synthetic_bop import generate_full
    root = str(tmp_path_factory.mktemp("synth"))
    generate_full(root, n_images=6, device="cpu", impl="plain")
    d = f"{root}/lm/train"
    return jbop.load_bop_split(d), tbop.load_bop_split(d)


def _class_of(oid):
    return oid - 1


DET_CASES = {
    "letterbox": dict(),
    "mosaic": dict(aug_mosaic=True),
    "mosaic_rot_shear": dict(aug_mosaic=True, rand_rotate_deg=10.0,
                             rand_shear=5.0, rand_translate=0.1,
                             rand_vflip=True),
    "affine_no_hsv": dict(rand_rotate_deg=15.0, rand_shear=3.0,
                          aug_hsv_prob=0.0, rand_hflip=False),
}


@pytest.mark.parametrize("case", sorted(DET_CASES))
@pytest.mark.parametrize("size", [64, 96])
def test_train_samples_match_jax(records, case, size):
    jrec, trec = records
    kw = dict(DET_CASES[case], input_size=size, max_objs=4)
    jds = JD.DetDataset(jrec, JDetConfig(**kw), _class_of, train=True, seed=3)
    tds = TD.DetDataset(trec, DetConfig(**kw), _class_of, train=True, seed=3)
    for _ in range(2):
        for i in range(len(jrec)):
            for a, b in zip(jds.train_sample(i), tds.train_sample(i)):
                assert a.dtype == b.dtype and np.array_equal(a, b), (case, i)
    jb, tb = jds.train_batches(4), tds.train_batches(4)
    for _ in range(2):
        for a, b in zip(next(jb), next(tb)):
            assert np.array_equal(a, b)
    assert len(tds.timings) == 2


@pytest.mark.parametrize("size", [64, 128, 200])
def test_eval_samples_match_jax(records, size):
    """Eval resizes by INTER_AREA: down at 64 and 128, up at 200 (the
    synthetic frame is 160x120)."""
    jrec, trec = records
    jds = JD.DetDataset(jrec, JDetConfig(input_size=size), _class_of,
                        train=False)
    tds = TD.DetDataset(trec, DetConfig(input_size=size), _class_of,
                        train=False)
    for i in range(len(jrec)):
        (ja, js, jg), (ta, ts, tg) = jds.eval_sample(i), tds.eval_sample(i)
        assert np.array_equal(ja, ta) and np.array_equal(jg, tg)
        assert dataclasses.asdict(js) == dataclasses.asdict(ts)
        boxes = np.array([[1.5, 2.0, 30.0, 41.0], [-3.0, 5.0, 300.0, 70.0]])
        assert np.array_equal(js.to_original(boxes), ts.to_original(boxes))
    jb = list(jds.eval_batches(4))
    tb = list(tds.eval_batches(4))
    assert len(jb) == len(tb) == 2 and len(tb[1][1]) == 2
    for a, b in zip(jb, tb):
        assert np.array_equal(a[0], b[0])
        assert [dataclasses.asdict(s) for s in a[1]] == \
            [dataclasses.asdict(s) for s in b[1]]
        assert [r.scene_im_id for r in a[3]] == [r.scene_im_id for r in b[3]]


def test_det_config_defaults_match_jax():
    assert dataclasses.asdict(DetConfig()) == dataclasses.asdict(JDetConfig())
