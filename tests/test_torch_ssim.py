"""The port's SSIM and MS-SSIM against the JAX package's, on the same
numpy-seeded images, in float32 on the CPU: values within a relative 1e-5,
gradients with respect to both images within 1e-5 of their largest
magnitude (a gradient element sums blur taps of every level). The images
of a pair are correlated, so every level's contrast-structure term is
positive; where one is not, the two packages' gradients differ (last
test)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self6dpp_tpu.ops import ssim as js
from self6dpp_tpu_torch.ops import ssim as ts

RTOL = 1e-5


def pair(shape, seed, mix=0.7):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    # a smooth structure shared by both images, plus independent noise
    yy, xx = np.mgrid[:shape[1], :shape[2]] / max(shape[1:3])
    base = 0.5 + 0.4 * np.sin(6 * xx + 4 * yy)[None, ..., None]
    a = (mix * base + (1 - mix) * a).astype(np.float32)
    b = (mix * base + (1 - mix) * rng.uniform(0, 1, shape)).astype(np.float32)
    return a, b


def torch_value_grad(fn, a, b):
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    v = fn(ta, tb)
    v.backward()
    return v.item(), ta.grad.numpy(), tb.grad.numpy()


def assert_grad_close(got, ref, name):
    np.testing.assert_allclose(got, ref, rtol=RTOL,
                               atol=1e-5 * float(np.abs(ref).max()), err_msg=name)


# (shape, levels): 3 levels at 64², 5 at 256², and an odd, non-square image
# whose pooling drops a trailing row and column (3 levels)
CASES = [((2, 64, 64, 3), 3), ((1, 256, 256, 3), 5), ((1, 45, 52, 3), 3)]


@pytest.mark.parametrize("shape,levels", CASES)
def test_ms_ssim_matches_jax(shape, levels, monkeypatch):
    a, b = pair(shape, seed=shape[1])
    jv, (jga, jgb) = jax.jit(jax.value_and_grad(js.ms_ssim, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    calls = []
    orig = ts._ssim_cs
    monkeypatch.setattr(ts, "_ssim_cs", lambda *x: calls.append(1) or orig(*x))
    tv, tga, tgb = torch_value_grad(ts.ms_ssim, a, b)
    assert len(calls) == levels
    np.testing.assert_allclose(tv, float(jv), rtol=RTOL)
    assert 0.05 < tv < 0.95
    assert_grad_close(tga, np.asarray(jga), "d img1")
    assert_grad_close(tgb, np.asarray(jgb), "d img2")
    np.testing.assert_allclose(
        ts.ms_ssim_loss(torch.tensor(a), torch.tensor(b)).item(), 1.0 - tv,
        rtol=RTOL)


def test_ssim_matches_jax():
    a, b = pair((2, 40, 33, 3), seed=3)
    f = jax.jit(lambda x, y: js.ssim(x, y, return_cs=True))
    js_, jcs = f(jnp.asarray(a), jnp.asarray(b))
    ts_, tcs = ts.ssim(torch.tensor(a), torch.tensor(b), return_cs=True)
    np.testing.assert_allclose(ts_.item(), float(js_), rtol=RTOL)
    np.testing.assert_allclose(tcs.item(), float(jcs), rtol=RTOL)
    jv, (jga, jgb) = jax.jit(jax.value_and_grad(js.ssim_loss, argnums=(0, 1)))(
        jnp.asarray(a), jnp.asarray(b))
    tv, tga, tgb = torch_value_grad(ts.ssim_loss, a, b)
    np.testing.assert_allclose(tv, float(jv), rtol=RTOL)
    assert_grad_close(tga, np.asarray(jga), "d img1")
    assert_grad_close(tgb, np.asarray(jgb), "d img2")


def test_gaussian_window_matches_jax():
    np.testing.assert_array_equal(ts._WIN, js._gaussian_kernel(11, 1.5))


def test_clamped_level_gradient_differs_from_jax():
    """Where a level's contrast-structure mean is negative, max(cs, 0) is 0
    and so is MS-SSIM. JAX's gradient is then NaN (0 ** w has an infinite
    derivative, and max's zero branch multiplies it); the port's is 0.
    Recorded, not copied: a NaN gradient would reach every parameter behind
    the render (ROADMAP C)."""
    a, _ = pair((1, 64, 64, 3), seed=5)
    b = (1.0 - a).astype(np.float32)              # anti-correlated
    jv, jg = jax.jit(jax.value_and_grad(js.ms_ssim, argnums=1))(
        jnp.asarray(a), jnp.asarray(b))
    tv, _, tg = torch_value_grad(ts.ms_ssim, a, b)
    assert float(jv) == 0.0 and tv == 0.0
    assert np.isnan(np.asarray(jg)).all()
    assert np.isfinite(tg).all() and not tg.any()
