"""Kernel B3's scaled entry on the CPU: lab_value_grad_scaled(_plain)'s
(value, g_raw, scale) composed into the JAX package's lab_value_grad_pallas
(Pallas interpret mode on the CPU), and InjectGrad's scaled cotangent add
against the unscaled one it replaces in the stage-II step."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from self6dpp_tpu.ops.lab_pallas import lab_value_grad_pallas
from self6dpp_tpu_torch.losses.self_loss import InjectGrad
from self6dpp_tpu_torch.ops import lab_cuda as LC

RTOL = 1e-5
WEIGHT = 0.2            # stage2_pose_flagship's lab_lw


def lab_inputs(b, s, seed, empty):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    gt = rng.uniform(0, 1, (b, s, s, 3)).astype(np.float32)
    m = (rng.uniform(0, 1, (b, s, s)) > 0.4).astype(np.float32)
    return pred, gt, np.zeros_like(m) if empty else m


# B * S^2 = 2 * 7^2 = 98 pixels (not a multiple of 4), and an empty mask
@pytest.mark.parametrize("no_l", [True, False])
@pytest.mark.parametrize("b,s,empty", [(2, 7, False), (1, 16, True)])
def test_scaled_entry_composes_to_jax(b, s, empty, no_l):
    """value equals JAX's, g_raw * scale equals WEIGHT x JAX's normalised
    gradient, scale equals WEIGHT / (max(sum(mask), 1) * n_ch); the wrapper
    takes the plain version for CPU tensors (no launch)."""
    pred, gt, m = lab_inputs(b, s, seed=b * 100 + s, empty=empty)
    jv, jg = jax.jit(lambda p, g, m_: lab_value_grad_pallas(
        p, g, m_, no_l=no_l))(jnp.asarray(pred), jnp.asarray(gt),
                              jnp.asarray(m))
    before = LC.lab_value_grad.launches
    v, g_raw, scale = LC.lab_value_grad_scaled(
        *map(torch.from_numpy, (pred, gt, m)), no_l, WEIGHT)
    assert LC.lab_value_grad.launches == before
    np.testing.assert_allclose(v.item(), float(jv), rtol=RTOL)
    n_ch = 2 if no_l else 3
    np.testing.assert_allclose(
        scale.item(), WEIGHT / (max(m.sum(), 1.0) * n_ch), rtol=1e-6)
    ref = WEIGHT * np.asarray(jg)
    # a gradient element sums terms as large as the largest element: 1e-6
    # of the largest magnitude, as in test_torch_losses.py
    np.testing.assert_allclose((g_raw * scale).numpy(), ref, rtol=RTOL,
                               atol=1e-6 * float(np.abs(ref).max()) + 1e-12)
    if empty:
        assert v.item() == 0 and not g_raw.any()
    else:
        assert v.item() > 1 and g_raw.abs().max() > 1e-4


def test_inject_grad_scaled_matches_the_unscaled_add():
    """ct + g_raw * scale (one addcmul) against the step's former ct +
    lab_lw * (g_raw * norm): equal but for the order of two roundings of
    the product, so within 1e-6 of the added term's largest magnitude."""
    rng = np.random.default_rng(3)
    ct = torch.from_numpy(rng.standard_normal((2, 9, 9, 3)).astype(np.float32))
    g_raw = torch.from_numpy(
        (50.0 * rng.standard_normal((2, 9, 9, 3))).astype(np.float32))
    norm = torch.tensor(1.0 / (97.0 * 2), dtype=torch.float32)
    x = torch.zeros_like(ct, requires_grad=True)
    InjectGrad.apply(x, g_raw, WEIGHT * norm).backward(ct)
    term = WEIGHT * (g_raw * norm)
    torch.testing.assert_close(x.grad, ct + term, rtol=0,
                               atol=1e-6 * term.abs().max().item())
    assert (x.grad - ct).abs().max() > 1e-2
    y = torch.zeros_like(ct, requires_grad=True)
    InjectGrad.apply(y, term).backward(ct)
    torch.testing.assert_close(y.grad, ct + term, rtol=0, atol=0)
