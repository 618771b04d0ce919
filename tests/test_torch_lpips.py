"""The port's LPIPS (AlexNet) against the JAX package's, in float32 on the
CPU: weights from JAX's own init, converted by convert.py; distances
within a relative 1e-5, gradients with respect to both images within 1e-5
of their largest magnitude. Also: the reference checkpoint's names and the
.npz layout load into the same module, the seeded init follows Flax's
distributions, and what each package gives at an all-zero feature vector.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self6dpp_tpu.models import lpips as JL
from self6dpp_tpu_torch.convert import (LPIPS_REFERENCE_MAP,
                                        lpips_flax_to_state_dict,
                                        lpips_reference_to_state_dict)
from self6dpp_tpu_torch.models import lpips as TL

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))

RTOL = 1e-5


def images(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.2, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.fixture(scope="module")
def jax_params():
    a, _ = images((2, 64, 64, 3), 0)
    return jax.jit(JL.LPIPS().init)(jax.random.PRNGKey(1), a, a)["params"]


def port_from(params):
    model = TL.LPIPS()
    model.load_state_dict(lpips_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), model))
    return model.eval().requires_grad_(False)


def jax_value_grad(params, a, b):
    f = jax.jit(jax.value_and_grad(
        lambda x, y: JL.LPIPS().apply({"params": params}, x, y).sum(),
        argnums=(0, 1)))
    dist = jax.jit(lambda x, y: JL.LPIPS().apply({"params": params}, x, y))
    return dist(a, b), f(a, b)


def check(model, params, a, b):
    jd, (_, (jga, jgb)) = jax_value_grad(params, jnp.asarray(a), jnp.asarray(b))
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    td = model(ta, tb)
    td.sum().backward()
    np.testing.assert_allclose(td.detach().numpy(), np.asarray(jd), rtol=RTOL)
    for got, ref in ((ta.grad, jga), (tb.grad, jgb)):
        ref = np.asarray(ref)
        assert np.isfinite(ref).all() and np.abs(ref).max() > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL,
                                   atol=1e-5 * float(np.abs(ref).max()))
    return td


@pytest.mark.parametrize("shape", [(2, 64, 64, 3), (1, 83, 70, 3)])
def test_lpips_matches_jax(jax_params, shape):
    a, b = images(shape, seed=shape[1])
    td = check(port_from(jax_params), jax_params, a, b)
    assert (td > 0).all()


def test_reference_names_and_npz_load_the_same_weights(jax_params, tmp_path):
    """The reference checkpoint's names, through the repo's tools converter
    and the .npz the JAX package reads, give the port's module the weights
    lpips_flax_to_state_dict gives it."""
    from convert_torch_weights import convert_lpips
    model = port_from(jax_params)
    want = model.state_dict()
    inv = {v: k for k, v in LPIPS_REFERENCE_MAP.items()}
    ref = {}
    for k, v in want.items():
        v = v.numpy()
        if k.startswith("lin"):
            ref[f"{inv[k]}.weight"] = v.reshape(1, -1, 1, 1)
        else:
            mod, leaf = k.rsplit(".", 1)
            ref[f"{inv[mod]}.{leaf}"] = v
    got = lpips_reference_to_state_dict(ref, TL.LPIPS())
    path = tmp_path / "lpips.npz"
    np.savez(path, **convert_lpips(ref))
    from_npz = TL.load_lpips_params(str(path))
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
        torch.testing.assert_close(from_npz[k], v, rtol=0, atol=0)
    jp = JL.load_lpips_params(str(path))
    back = lpips_flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jp),
                                    TL.LPIPS())
    for k, v in want.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    assert TL.load_lpips_params(str(tmp_path / "missing.npz")) is None


def test_seeded_init_follows_flax():
    """build_lpips draws LeCun-normal (truncated at 2 std) conv kernels,
    zero biases and linear heads in [0, 0.1), frozen and in eval mode."""
    model = TL.build_lpips("cpu", seed=3)
    assert not model.training
    assert not any(p.requires_grad for p in model.parameters())
    again = TL.build_lpips("cpu", seed=3).state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, again[k]), k
    w = model.alex.conv3.weight
    std = (w.shape[1] * 9) ** -0.5
    assert abs(w.std().item() - std) < 0.05 * std
    assert w.abs().max().item() <= 2 * std / 0.87962566103423978
    assert not model.alex.conv3.bias.any()
    for i in range(5):
        lin = getattr(model, f"lin{i}")
        assert lin.min() >= 0 and lin.max() < 0.1 and lin.std() > 0.02


def test_zero_feature_vector(jax_params):
    """At an all-zero feature vector, the gradient of a / max(|a|, 1e-10) is
    NaN in JAX (the norm's gradient at 0) and finite in the port (1e10
    scale). Through LPIPS neither reaches the image: the zero vector comes
    out of a ReLU, whose backward selects 0 there in both packages. Here
    conv5 is zeroed with a bias of -1, so every relu5 vector is zero, and the
    image gradients still agree (ROADMAP C)."""
    z = np.zeros((1, 4), np.float32)
    jg = jax.grad(lambda a: (a / jnp.maximum(jnp.linalg.norm(
        a, axis=-1, keepdims=True), 1e-10)).sum())(jnp.asarray(z))
    assert np.isnan(np.asarray(jg)).all()
    ta = torch.tensor(z, requires_grad=True)
    TL.unit_channels(ta).sum().backward()
    assert torch.isfinite(ta.grad).all()
    assert ta.grad.abs().max().item() == pytest.approx(1e10, rel=1e-6)

    p = jax.tree_util.tree_map(np.array, jax_params)
    p["alex"]["conv5"]["kernel"][:] = 0.0
    p["alex"]["conv5"]["bias"][:] = -1.0
    a, b = images((1, 64, 64, 3), seed=9)
    check(port_from(p), p, a, b)
