"""The port's geometry, pose-decode and zoom ops against the JAX package's,
on the same numpy-seeded inputs (float32 on both sides, within 1e-5;
pixel-valued outputs of a few hundred also within a relative 1e-6)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from self6dpp_tpu.ops import geometry as JG
from self6dpp_tpu.ops import pose_decode as JP
from self6dpp_tpu.ops import zoom as JZ
from self6dpp_tpu_torch.ops import geometry as TG
from self6dpp_tpu_torch.ops import pose_decode as TP
from self6dpp_tpu_torch.ops import zoom as TZ


def close(j, t, atol=1e-5, rtol=1e-6):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=atol, rtol=rtol)


def f32(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def rotations(rng, b):
    q = rng.normal(size=(b, 4)).astype(np.float32)
    return np.array(JG.quat_to_mat(jnp.asarray(q)))


def test_quat_to_mat(rng):
    q = rng.normal(size=(7, 4)).astype(np.float32) * 3.0
    close(JG.quat_to_mat(jnp.asarray(q)), TG.quat_to_mat(torch.from_numpy(q)))


def test_rot6d_to_mat_with_fallbacks(rng):
    d6 = f32(rng, 9, 6)
    d6[1] *= 1e-5                      # fresh-head magnitudes
    d6[2] = 0.0                        # exact zeros: canonical basis
    d6[3, :3] = 0.0                    # zero first column
    d6[4, 3:] = 2.0 * d6[4, :3]        # second column parallel to the first
    close(JG.rot6d_to_mat(jnp.asarray(d6)),
          TG.rot6d_to_mat(torch.from_numpy(d6)))


def test_allo_to_ego_mat(rng):
    t = np.concatenate([f32(rng, 6, 2, lo=-0.3, hi=0.3),
                        f32(rng, 6, 1, lo=0.5, hi=1.5)], 1)
    t[0] = (0.0, 0.0, 1.0)             # on the optical axis
    R = rotations(rng, 6)
    close(JG.allo_to_ego_mat(jnp.asarray(t), jnp.asarray(R)),
          TG.allo_to_ego_mat(torch.from_numpy(t), torch.from_numpy(R)))


@pytest.mark.parametrize("rot_type", ["ego_rot6d", "allo_quat"])
def test_rot_rep_to_mat(rng, rot_type):
    x = f32(rng, 5, 6 if rot_type.endswith("rot6d") else 4)
    close(JP.rot_rep_to_mat(jnp.asarray(x), rot_type),
          TP.rot_rep_to_mat(torch.from_numpy(x), rot_type))


@pytest.mark.parametrize("kw", [
    dict(),
    dict(delta_z_style="deepim"),
    dict(delta_T_space="3D"),
    dict(is_allo=True),
    dict(K_aware=False, delta_T_weight=0.5),
], ids=["cosypose", "deepim", "3D", "allo", "no_K"])
def test_pose_from_delta_init(rng, kw):
    b = 6
    rd, ri = rotations(rng, b), rotations(rng, b)
    td = f32(rng, b, 3, lo=-0.5, hi=1.5)
    td[0, 2] = -0.3                    # cosypose vz <= 0: the eps clamp
    ti = np.concatenate([f32(rng, b, 2, lo=-0.2, hi=0.2),
                         f32(rng, b, 1, lo=0.5, hi=1.5)], 1)
    ti[1, 2] = -0.1                    # a source behind the camera
    K = np.broadcast_to(np.array([[600.0, 0, 256], [0, 610.0, 250],
                                  [0, 0, 1]], np.float32), (b, 3, 3)).copy()
    args = (rd, td, ri, ti, K)
    jr, jt = JP.pose_from_delta_init(*map(jnp.asarray, args[:4]),
                                     Ks=jnp.asarray(K), **kw)
    tr, tt = TP.pose_from_delta_init(*map(torch.from_numpy, args[:4]),
                                     Ks=torch.from_numpy(K), **kw)
    close(jr, tr)
    close(jt, tt)


def zoom_inputs(rng, b=4):
    K = np.array([[572.4114, 0, 325.2611], [0, 573.57043, 242.04899],
                  [0, 0, 1]], np.float32)
    R = rotations(rng, b)
    t = np.concatenate([f32(rng, b, 2, lo=-0.1, hi=0.1),
                        f32(rng, b, 1, lo=0.6, hi=1.4)], 1)
    pts = f32(rng, b, 50, 3, lo=-0.05, hi=0.05)
    obs = np.concatenate([f32(rng, b, 2, lo=200, hi=300),
                          f32(rng, b, 2, lo=350, hi=420)], 1)
    return np.broadcast_to(K, (b, 3, 3)).copy(), R, t, pts, obs


@pytest.mark.parametrize("with_obs", [False, True])
def test_deepim_boxes_and_zoom_K(rng, with_obs):
    K, R, t, pts, obs = zoom_inputs(rng)
    J = lambda *a: [jnp.asarray(x) for x in a]
    T = lambda *a: [torch.from_numpy(x) for x in a]
    jb = JZ.bboxes_from_pose(*J(pts, K, R, t))
    tb = TZ.bboxes_from_pose(*T(pts, K, R, t))
    close(jb, tb)
    jc = JZ.centers_2d_from_pose(*J(K, R, t))
    tc = TZ.centers_2d_from_pose(*T(K, R, t))
    close(jc, tc)
    jbox, jrat = JZ.deepim_boxes(jnp.asarray(np.asarray(jb)),
                                 jnp.asarray(np.asarray(jc)),
                                 obs_boxes=jnp.asarray(obs) if with_obs else None,
                                 lamb=1.5, out_hw=(512, 512))
    tbox, trat = TZ.deepim_boxes(torch.from_numpy(np.array(jb)),
                                 torch.from_numpy(np.array(jc)),
                                 obs_boxes=torch.from_numpy(obs) if with_obs else None,
                                 lamb=1.5, out_hw=(512, 512))
    close(jbox, tbox)
    close(jrat, trat)
    box = np.array(jbox)
    close(JZ.zoom_K(jnp.asarray(K), jnp.asarray(box), (512, 512)),
          TZ.zoom_K(torch.from_numpy(K), torch.from_numpy(box), (512, 512)))
    close(JZ.zoom_K(jnp.asarray(K[0]), jnp.asarray(box), (480, 640)),
          TZ.zoom_K(torch.from_numpy(K[0]), torch.from_numpy(box), (480, 640)))


def test_crop_resize(rng):
    imgs = f32(rng, 3, 30, 40, 3, lo=0.0, hi=1.0)
    boxes = np.array([[5.5, 3.25, 30.0, 25.0],       # inside
                      [-8.0, -6.0, 20.0, 14.0],      # past the top-left
                      [25.0, 20.0, 52.0, 41.0]],     # past the bottom-right
                     np.float32)
    close(JZ.crop_resize(jnp.asarray(imgs), jnp.asarray(boxes), 16, 24),
          TZ.crop_resize(torch.from_numpy(imgs), torch.from_numpy(boxes),
                         16, 24))


def test_backproject_depth(rng):
    """Forward and gradient (with respect to depth and K) on a ragged
    19x23 depth map of two images."""
    import jax
    depth = f32(rng, 2, 19, 23, lo=0.5, hi=1.5)
    K = np.array([[[300.0, 0, 11.3], [0, 310.0, 9.1], [0, 0, 1]],
                  [[250.0, 0, 12.0], [0, 240.0, 8.5], [0, 0, 1]]], np.float32)
    w = f32(rng, 2, 19, 23, 3)
    jf = jax.jit(jax.value_and_grad(
        lambda d, k: (JG.backproject_depth(d, k) * w).sum(), argnums=(0, 1)))
    jv, (jgd, jgk) = jf(jnp.asarray(depth), jnp.asarray(K))
    close(JG.backproject_depth(jnp.asarray(depth), jnp.asarray(K)),
          TG.backproject_depth(torch.from_numpy(depth), torch.from_numpy(K)))
    td = torch.tensor(depth, requires_grad=True)
    tk = torch.tensor(K, requires_grad=True)
    tv = (TG.backproject_depth(td, tk) * torch.from_numpy(w)).sum()
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    close(jgd, td.grad)
    np.testing.assert_allclose(tk.grad.numpy(), np.asarray(jgk), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(jgk)).max()))
