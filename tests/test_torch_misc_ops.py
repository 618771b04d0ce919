"""The rest of the port's geometry and colour functions
(self6dpp_tpu_torch/ops/geometry.py, ops/color.py) against the JAX
package's in float32 at 1e-6, and the host pose augmentation
(data/pose_aug.py) and batch_separated_batches against the JAX package's
from the same seeds, exactly."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from self6dpp_tpu.data import pose_aug as jpa
from self6dpp_tpu.data import samplers as jsm
from self6dpp_tpu.ops import color as jcol
from self6dpp_tpu.ops import geometry as jgeo
from self6dpp_tpu_torch.data import pose_aug as tpa
from self6dpp_tpu_torch.data import samplers as tsm
from self6dpp_tpu_torch.ops import color as tcol
from self6dpp_tpu_torch.ops import geometry as tgeo

TOL = 1e-6


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def rots(n=64, seed=0):
    return Rotation.random(n, random_state=seed).as_matrix().astype(np.float32)


def rng_f32(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def test_quat_mul_and_axangle():
    a, b = rng_f32(0, 16, 4), rng_f32(1, 16, 4)
    close(tgeo.quat_mul(torch.from_numpy(a), torch.from_numpy(b)),
          jgeo.quat_mul(a, b))
    ax, ang = rng_f32(2, 16, 3), rng_f32(3, 16)
    close(tgeo.axangle_to_quat(torch.from_numpy(ax), torch.from_numpy(ang)),
          jgeo.axangle_to_quat(ax, ang))
    close(tgeo.axangle_to_mat(torch.from_numpy(ax), torch.from_numpy(ang)),
          jgeo.axangle_to_mat(ax, ang))


def branch_rotations():
    """Rotations whose largest diagonal combination is each of the four
    (1 + tr, 1 + m00 - m11 - m22, ...): angles near 0 and near pi about
    x, y and z, and random ones."""
    out = [np.eye(3)]
    for axis in np.eye(3):
        for ang in (0.3, np.pi - 0.2, np.pi):
            out.append(Rotation.from_rotvec(axis * ang).as_matrix())
    return np.concatenate([np.asarray(out), rots(60, 5)]).astype(np.float32)


def test_mat_to_quat_every_branch():
    m = branch_rotations()
    mags = np.stack([1 + np.trace(m, axis1=1, axis2=2),
                     1 + m[:, 0, 0] - m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] + m[:, 1, 1] - m[:, 2, 2],
                     1 - m[:, 0, 0] - m[:, 1, 1] + m[:, 2, 2]], -1)
    assert set(mags.argmax(-1)) == {0, 1, 2, 3}
    close(tgeo.mat_to_quat(torch.from_numpy(m)), jgeo.mat_to_quat(m))


def test_rot6d_ego_allo_and_angle():
    m = rots(32, 1)
    close(tgeo.mat_to_rot6d(torch.from_numpy(m)), jgeo.mat_to_rot6d(m))
    t = (rng_f32(4, 32, 3) * [0.1, 0.1, 0.2] + [0, 0, 1]).astype(np.float32)
    close(tgeo.ego_to_allo_mat(torch.from_numpy(t), torch.from_numpy(m)),
          jgeo.ego_to_allo_mat(t, m))
    m2 = rots(32, 2)
    np.testing.assert_allclose(
        tgeo.quat_from_two_mats_angle(torch.from_numpy(m),
                                      torch.from_numpy(m2)).numpy(),
        np.asarray(jgeo.quat_from_two_mats_angle(m, m2)), rtol=TOL)


def colours():
    """Random colours, greys (r = g = b, h and s at 0), blacks, and
    colours with two equal largest channels."""
    rgb = np.random.default_rng(9).random((4, 16, 3)).astype(np.float32)
    grey = np.repeat(np.linspace(0, 1, 16, dtype=np.float32)[:, None], 3, 1)
    ties = rgb[1].copy()
    ties[:, 1] = ties[:, 0]
    return np.concatenate([rgb.reshape(-1, 3), grey, ties,
                           np.zeros((2, 3), np.float32)])


@pytest.mark.parametrize("name", ["rgb_to_linear", "rgb_to_xyz", "rgb_to_lab",
                                  "rgb_to_gray", "rgb_to_hsv", "rgb_to_yuv",
                                  "rgb_to_luv"])
def test_colour_conversions(name):
    x = colours()
    got = getattr(tcol, name)(torch.from_numpy(x))
    want = np.asarray(getattr(jcol, name)(jnp.asarray(x)))
    # Lab and LUV reach about 100: 1e-6 of their range
    tol = TOL * (100 if name in ("rgb_to_lab", "rgb_to_luv") else 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=tol)
    if name == "rgb_to_hsv":
        grey = got[64:80]
        assert (grey[:, :2] == 0).all()


def test_perturb_poses_and_z_flip():
    R, t = rots(12, 3), rng_f32(5, 12, 3)
    for kw in ({}, dict(rot_std_deg=60.0, trans_std=(0.2, 0.2, 0.3),
                        rot_max_deg=30.0, trans_max=0.1)):
        a = jpa.perturb_poses(R, t, np.random.default_rng(1), **kw)
        b = tpa.perturb_poses(R, t, np.random.default_rng(1), **kw)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    a = jpa.uniform_z_flip_aug(R, np.random.default_rng(2), prob=0.4)
    b = tpa.uniform_z_flip_aug(R, np.random.default_rng(2), prob=0.4)
    assert np.array_equal(a, b) and not np.array_equal(b, R)


def test_aug_depth_and_jitter_K():
    d = np.abs(rng_f32(6, 48, 64)) + 0.5
    d[:8] = 0
    for kw in ({}, dict(noise_std=0.01, dropout_prob=0.1, quantize_mm=0.0)):
        a = jpa.aug_depth(d, np.random.default_rng(3), **kw)
        b = tpa.aug_depth(d, np.random.default_rng(3), **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]])
    for kw in ({}, dict(f_ratio=0.05, c_px=4.0)):
        assert np.array_equal(jpa.jitter_K(K, np.random.default_rng(4), **kw),
                              tpa.jitter_K(K, np.random.default_rng(4), **kw))


@pytest.mark.parametrize("batch_size", [1, 3])
def test_batch_separated_batches(batch_size):
    gid = np.random.default_rng(0).integers(0, 4, 37)
    a = itertools.islice(jsm.batch_separated_batches(gid, batch_size, 7), 40)
    b = itertools.islice(tsm.batch_separated_batches(gid, batch_size, 7), 40)
    for x, y in zip(a, b):
        assert np.array_equal(x, y)
        assert len(set(gid[y])) == 1
