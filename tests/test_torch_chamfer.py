"""The port's nearest-neighbour distances and chamfer loss against the JAX
package's, on the same numpy inputs, in float32 on the CPU: distances and
loss within a relative 1e-5, gradients with respect to both clouds within
1e-5 of their largest magnitude.

The 'ties' case puts query points exactly halfway between targets of a
regular grid, with coordinates that are multiples of 1/8 (every square,
sum and product is exact in float32), so both packages see the same exact
ties and must split the gradient between them the same way."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self6dpp_tpu.ops import chamfer as jc
from self6dpp_tpu_torch.ops import chamfer as tcham

RTOL = 1e-5


def grid_plane(b, n_side, step=0.25, z=1.0):
    """(b, n_side², 3) points of a regular grid on the plane z."""
    u = (np.arange(n_side) - n_side // 2) * step
    xx, yy = np.meshgrid(u, u, indexing="ij")
    p = np.stack([xx, yy, np.full_like(xx, z)], -1).reshape(-1, 3)
    return np.repeat(p[None], b, 0).astype(np.float32)


def case_inputs(name, seed=0):
    """(p1, p2, w1, w2, kwargs) of one case."""
    rng = np.random.default_rng(seed)
    b = 2
    p2 = grid_plane(b, 6)
    if name == "ties":
        # halfway between two grid columns, or at the centre of four
        # targets; 1/8 above the plane
        k = rng.integers(-2, 2, (b, 24, 2)).astype(np.float32) * 0.25
        half = np.where(rng.uniform(size=(b, 24, 2)) < 0.5, 0.125, 0.0)
        half[..., 0] = 0.125
        p1 = np.concatenate([k + half, np.full((b, 24, 1), 1.125)], -1)
        w1, w2 = (np.ones(p.shape[:2], np.float32) for p in (p1, p2))
        return p1.astype(np.float32), p2, w1, w2, dict(dist_thr=0.0)
    p1 = (rng.normal(0, 0.4, (b, 40, 3)) + [0, 0, 1.1]).astype(np.float32)
    p2 = p2 + rng.normal(0, 0.01, p2.shape).astype(np.float32)
    w1 = (rng.uniform(size=(b, 40)) > 0.3).astype(np.float32)
    w2 = (rng.uniform(size=(b, p2.shape[1])) > 0.2).astype(np.float32)
    if name == "invalid":
        w2[1] = 0.0                         # image 1 has no valid target
        return p1, p2, w1, w2, dict(dist_thr=0.0)
    if name == "thr":
        return p1, p2, w1, w2, dict(dist_thr=0.3)
    return p1, p2, w1, w2, dict(dist_thr=0.3, center_lw=0.5)


CASES = ["ties", "invalid", "thr", "center"]


@pytest.mark.parametrize("name", CASES)
def test_nn_distance_matches_jax(name):
    p1, p2, w1, w2, _ = case_inputs(name)
    jd1, jd2 = jax.jit(jc.nn_distance)(*map(jnp.asarray, (p1, p2, w1, w2)))
    td1, td2 = tcham.nn_distance(*map(torch.from_numpy, (p1, p2, w1, w2)))
    for j, t in ((jd1, td1), (jd2, td2)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL, atol=1e-7)
        assert np.isfinite(t.numpy()).all()
    if name == "invalid":
        assert not td1[1].any() and not td2[1].any()


@pytest.mark.parametrize("name", CASES)
def test_chamfer_loss_and_gradient_match_jax(name):
    p1, p2, w1, w2, kw = case_inputs(name)
    f = jax.jit(jax.value_and_grad(
        lambda a, b: jc.chamfer_loss(a, b, jnp.asarray(w1), jnp.asarray(w2),
                                     **kw),
        argnums=(0, 1)))
    jv, (jg1, jg2) = f(jnp.asarray(p1), jnp.asarray(p2))
    t1 = torch.tensor(p1, requires_grad=True)
    t2 = torch.tensor(p2, requires_grad=True)
    tv = tcham.chamfer_loss(t1, t2, torch.from_numpy(w1), torch.from_numpy(w2),
                            **kw)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    assert tv.item() > 0
    for got, ref in ((t1.grad, jg1), (t2.grad, jg2)):
        ref = np.asarray(ref)
        assert np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_ties_split_the_gradient_evenly():
    """A query halfway between two targets takes half of each target's
    pull (amin's rule and JAX's), not all of one (min(dim)'s)."""
    p2 = torch.tensor([[[0.0, 0.0, 1.0], [0.25, 0.0, 1.0]]])
    p1 = torch.tensor([[[0.125, 0.0, 1.0]]], requires_grad=True)
    ones = torch.ones(1, 1), torch.ones(1, 2)
    d1, _ = tcham.nn_distance(p1, p2, *ones)
    d1.sum().backward()
    # d/dp1 of |p1 - t|² is 2 (p1 - t): +0.25 and -0.25 in x, averaged
    torch.testing.assert_close(p1.grad, torch.zeros_like(p1), rtol=0, atol=0)
    jw = [jnp.asarray(w.numpy()) for w in ones]
    jg = jax.grad(lambda a: jc.nn_distance(a, jnp.asarray(p2.numpy()),
                                           *jw)[0].sum())(
        jnp.asarray(p1.detach().numpy()))
    np.testing.assert_array_equal(np.asarray(jg), p1.grad.numpy())
