"""The port's train-time augmentation and its OpenCV stand-ins on the CPU:

  * gaussian_blur_5 against cv2.GaussianBlur(img, (5, 5), sigma) of
    float32 and float64 images (1e-6; OpenCV sums in another order, so the
    two differ by an ulp at places);
  * resize_linear against cv2.resize (INTER_LINEAR) of float32 images, up,
    down and by an exact half (1e-6), and resize_nearest against
    INTER_NEAREST (bit for bit);
  * color_aug, replace_bg (with and without truncate_fg) and
    add_noise_depth against the JAX package's from one seed: equal draws,
    outputs within 1e-6 (the blur and the resize are the only ops that
    differ).

The samplers' index streams from one seed equal the JAX package's.
"""

import itertools

import cv2
import numpy as np
import pytest

from self6dpp_tpu.data import aug as jaug
from self6dpp_tpu.data import samplers as jsamp
from self6dpp_tpu_torch.data import aug as taug
from self6dpp_tpu_torch.data import samplers as tsamp

TOL = 1e-6


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape", [(37, 53, 3), (20, 31), (5, 6, 3)])
def test_gaussian_blur_matches_cv2(dtype, shape):
    img = np.random.default_rng(0).random(shape).astype(dtype)
    for sigma in (0.31, 0.7, 1.19):
        got = taug.gaussian_blur_5(img, sigma)
        ref = cv2.GaussianBlur(img, (5, 5), sigma)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


@pytest.mark.parametrize("shape,dsize", [
    ((37, 53, 3), (64, 48)), ((40, 60, 3), (17, 23)), ((10, 12), (31, 29)),
    ((40, 60, 3), (30, 20)), ((100, 80), (120, 150)), ((33, 47, 3), (641, 479))])
def test_resize_matches_cv2(shape, dsize):
    img = np.random.default_rng(1).random(shape).astype(np.float32)
    got, ref = taug.resize_linear(img, dsize), cv2.resize(img, dsize)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
    assert np.array_equal(taug.resize_nearest(img, dsize), cv2.resize(
        img, dsize, interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("prob", [1.0, 0.8])
def test_color_aug_matches_jax(prob):
    img = np.random.default_rng(2).random((60, 80, 3)).astype(np.float32)
    blurred = 0
    for seed in range(24):
        jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
        ref, got = jaug.color_aug(img, jr, prob), taug.color_aug(img, tr, prob)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
        assert jr.random() == tr.random(), seed      # the same draws
        # a blur drawn: the JAX chain with the blur left out differs
        blurred += not np.allclose(ref, _without_blur(img, seed, prob))
    assert blurred > 0


def _without_blur(img, seed, prob):
    real = jaug.cv2
    jaug.cv2 = None
    try:
        return jaug.color_aug(img, np.random.default_rng(seed), prob)
    finally:
        jaug.cv2 = real


@pytest.mark.parametrize("truncate", [False, True])
def test_replace_bg_matches_jax(truncate):
    rng = np.random.default_rng(4)
    img = rng.random((48, 64, 3)).astype(np.float32)
    mask = np.zeros((48, 64), np.float32)
    mask[10:40, 12:50] = 1
    for bg_shape in ((30, 44, 3), (48, 64, 3)):
        bg = rng.random(bg_shape).astype(np.float32)
        for seed in range(6):
            jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
            ref = jaug.replace_bg(img, mask, bg, truncate, jr)
            got = taug.replace_bg(img, mask, bg, truncate, tr)
            assert got.dtype == ref.dtype
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)
            assert jr.random() == tr.random()


@pytest.mark.parametrize("shape", [(30, 40), (30, 40, 2)])
def test_add_noise_depth_matches_jax(shape):
    depth = np.random.default_rng(5).random(shape).astype(np.float32)
    jr, tr = np.random.default_rng(6), np.random.default_rng(6)
    ref = jaug.add_noise_depth(depth, jr, 0.1)
    got = taug.add_noise_depth(depth, tr, 0.1)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)


def _take(it, n=40):
    return [int(i) for i in itertools.islice(it, n)]


def test_samplers_match_jax():
    cats = np.array([1, 1, 1, 2, 3, 3, 1, 2, 1, 1])
    rf_j = jsamp.repeat_factors_from_category_frequency(cats, 0.5)
    rf_t = tsamp.repeat_factors_from_category_frequency(cats, 0.5)
    assert np.array_equal(rf_j, rf_t) and rf_t.max() > 1
    w = np.arange(1, 11, dtype=np.float64)
    pairs = [
        (jsamp.training_sampler(7, seed=3), tsamp.training_sampler(7, seed=3)),
        (jsamp.training_sampler(7, 3, False), tsamp.training_sampler(7, 3, False)),
        (jsamp.repeat_factor_sampler(rf_j, 4), tsamp.repeat_factor_sampler(rf_t, 4)),
        (jsamp.infinite_subset_random_sampler(10, 0.4, 5),
         tsamp.infinite_subset_random_sampler(10, 0.4, 5)),
        (jsamp.infinite_subset_random_sampler(10, 0.5, 5, w),
         tsamp.infinite_subset_random_sampler(10, 0.5, 5, w)),
        (jsamp.inference_sampler(9), tsamp.inference_sampler(9))]
    for j, t in pairs:
        assert _take(j) == _take(t)
    for r in range(3):
        assert _take(jsamp.process_shard(jsamp.training_sampler(7, 1), r, 3)) \
            == _take(tsamp.process_shard(tsamp.training_sampler(7, 1), r, 3))
