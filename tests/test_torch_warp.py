"""The port's affine warps (ops/warp.py) against the JAX package's, in
float32 on the CPU: make_affine, invert_affine, affine_warp (bilinear and
nearest, with samples past the border, where JAX clips the gather and
zeroes by a half-pixel test) and sample_pose_variated_affines' composition
of its draws; the port's own sampler keeps to its ranges.
"""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from self6dpp_tpu.ops import warp as jw
from self6dpp_tpu_torch.ops import warp as tw

RTOL = 1e-5


def draws(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-math.pi, math.pi, b).astype(np.float32),
            rng.uniform(0.6, 1.4, (b, 2)).astype(np.float32),
            rng.uniform(-0.3, 0.3, (b, 2)).astype(np.float32))


def test_make_and_invert_affine_match_jax():
    rot, sc, tr = draws(5, 0)
    jm = jw.make_affine(*map(jnp.asarray, (rot, sc, tr)))
    tm = tw.make_affine(*map(torch.from_numpy, (rot, sc, tr)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=1e-7)
    ji, ti = jw.invert_affine(jm), tw.invert_affine(tm)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), rtol=RTOL,
                               atol=1e-6)
    # inverse: [A t] [A' t'] = identity
    a, b = ti[:, :, :2], tm[:, :, :2]
    eye = torch.eye(2).expand(5, 2, 2)
    torch.testing.assert_close(a @ b, eye, rtol=0, atol=1e-6)
    torch.testing.assert_close(
        (a @ tm[:, :, 2:] + ti[:, :, 2:])[..., 0], torch.zeros(5, 2),
        rtol=0, atol=1e-6)


def warp_cases():
    """Per image: identity, a random affine, one zoomed out (a border of
    out-of-bounds samples), one shifted by a bit more than half the image
    (samples across the edge and its clipped neighbours)."""
    rot, sc, tr = draws(4, 1)
    sc[2] = (0.6, 0.7)
    tr[3] = (0.55, -0.6)
    rot[0], sc[0], tr[0] = 0.0, (1.0, 1.0), (0.0, 0.0)
    return tw.invert_affine(tw.make_affine(*map(torch.from_numpy,
                                                (rot, sc, tr)))).numpy()


@pytest.mark.parametrize("mode", ["bilinear", "nearest"])
@pytest.mark.parametrize("h,w,c", [(16, 16, 3), (9, 13, 5)])
def test_affine_warp_matches_jax(mode, h, w, c):
    mats = warp_cases()
    img = np.random.default_rng(2).uniform(0.1, 1, (4, h, w, c)).astype(
        np.float32)
    jo = jax.jit(lambda x, m: jw.affine_warp(x, m, mode=mode))(
        jnp.asarray(img), jnp.asarray(mats))
    to = tw.affine_warp(torch.from_numpy(img), torch.from_numpy(mats), mode)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=1e-6)
    # the identity reads every pixel centre as it is; the zoomed-out image
    # has a zero border; the shifted one has zeros and values
    np.testing.assert_allclose(to[0].numpy(), img[0], rtol=0, atol=1e-6)
    assert (to[2] == 0).all(-1).any() and (to[2] != 0).any()
    assert (to[3] == 0).all(-1).float().mean() > 0.2


def test_affine_warp_gradient_matches_jax():
    """The warp of the teacher's maps takes no gradient, the student's
    input warp is a constant of the loss: the image gradient still agrees
    (a gather's transpose)."""
    mats = warp_cases()
    img = np.random.default_rng(3).uniform(0, 1, (4, 12, 12, 2)).astype(
        np.float32)
    ct = np.random.default_rng(4).standard_normal(img.shape).astype(np.float32)
    jg = jax.jit(jax.grad(lambda x: (jw.affine_warp(x, jnp.asarray(mats))
                                     * ct).sum()))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_(True)
    (tw.affine_warp(x, torch.from_numpy(mats)) * torch.from_numpy(ct)).sum() \
        .backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=RTOL,
                               atol=1e-5)


def test_pose_variated_affines_compose_as_jax():
    """JAX's sampler against the port's make/invert composition of the same
    uniform draws (taken from JAX's key splits): one matrix per image."""
    key = jax.random.PRNGKey(5)
    b, rot_deg, zoom, trans, crop = 6, 180.0, (0.75, 1.25), (-0.1, 0.1), 0.1
    jm = jw.sample_pose_variated_affines(key, b, rot_deg=rot_deg, zoom=zoom,
                                         trans=trans, crop_percent=crop)
    r1, r2, r3, r4 = jax.random.split(key, 4)
    u = lambda k, shape, lo, hi: np.array(
        jax.random.uniform(k, shape, minval=lo, maxval=hi))
    rot = torch.from_numpy(u(r1, (b,), -rot_deg, rot_deg)) * (math.pi / 180)
    sc = torch.from_numpy(u(r2, (b, 2), *zoom))
    cr = torch.from_numpy(u(r4, (b, 1), 1 - crop, 1 + crop))
    tr = torch.from_numpy(u(r3, (b, 2), *trans))
    tm = tw.invert_affine(tw.make_affine(rot, sc * cr, 2.0 * tr))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=RTOL,
                               atol=1e-6)


def test_port_sampler_keeps_its_ranges():
    g = torch.Generator().manual_seed(0)
    m = tw.sample_pose_variated_affines(g, 4000, rot_deg=30.0,
                                        zoom=(0.8, 1.2), trans=(-0.1, 0.1),
                                        crop_percent=0.1)
    fwd = tw.invert_affine(m)
    a = fwd[:, :, :2]
    # the column norms are the scales (zoom x crop); the angle is the
    # rotation's; the translation is twice the drawn share
    scale = torch.linalg.vector_norm(a, dim=1)
    assert scale.min() >= 0.8 * 0.9 - 1e-5 and scale.max() <= 1.2 * 1.1 + 1e-5
    ang = torch.atan2(a[:, 1, 0], a[:, 0, 0]) * 180 / math.pi
    assert ang.abs().max() <= 30 + 1e-3 and ang.abs().max() > 29
    assert fwd[:, :, 2].abs().max() <= 0.2 + 1e-6
    again = tw.sample_pose_variated_affines(
        torch.Generator().manual_seed(0), 4000, rot_deg=30.0,
        zoom=(0.8, 1.2), trans=(-0.1, 0.1), crop_percent=0.1)
    assert torch.equal(m, again)
