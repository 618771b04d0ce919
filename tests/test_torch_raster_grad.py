"""The port's fine-raster backward (the plain version of kernel B2, through
raster_cuda.FineRaster) against the JAX package's, on the scenes of
tests/test_torch_raster.py: gradients of a loss mixing prob, depth and attr
with respect to the pose (t, R) and the vertex colours.

Against rasterize_batch(impl="pallas") (fine_raster's custom_vjp, Pallas
in interpret mode) the rule is the same: rtol 1e-4, atol 1e-6. Against
impl="xla" autodiff the package's own tolerance holds (rtol 2e-2, atol
1e-3, tests/test_raster_pallas.py): autodiff splits ties of the clip and
the edge minimum where the analytic rule takes one side. The poses keep the
drawn edges clear of pixel centres (tests/test_torch_raster.py::scene).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import self6dpp_tpu.ops.raster_pallas as RP
from self6dpp_tpu.ops import rasterizer as JR
from self6dpp_tpu_torch.ops import raster_cuda as RC
from self6dpp_tpu_torch.ops import rasterizer as TR
from test_torch_raster import CASES, scene

_orig_pallas_call = pl.pallas_call


def _interp_pallas_call(*args, **kw):
    kw.setdefault("interpret", True)
    return _orig_pallas_call(*args, **kw)


@pytest.fixture
def interpret_mode(monkeypatch):
    monkeypatch.setattr(RP.pl, "pallas_call", _interp_pallas_call)
    # one torch thread, as tests/test_torch_self_engine.py runs
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def loss_terms(out, width):
    us = np.arange(width, dtype=np.float32)[None, :]
    if torch.is_tensor(out.prob):
        us = torch.from_numpy(us)
    return ((out.prob * us).sum() * 1e-2 + (out.attr ** 2).sum()
            + (out.depth ** 2).sum() * 0.1)


def grads_both(mesh, impl, hw, with_prob, zbuf):
    verts, faces, colors, K, R, t = scene(mesh)
    h, w = hw
    kw = dict(height=h, width=w, tile_px=16, faces_per_tile=16,
              with_prob=with_prob, zbuf_mode=zbuf)

    def jloss(t_, R_, c_):
        out = JR.rasterize_batch(jnp.asarray(verts), jnp.asarray(faces), c_,
                                 jnp.asarray(K), R_, t_, impl=impl, **kw)
        return loss_terms(out, w)

    # one compiled program per case: quicker on the CPU than dispatching
    # the interpret-mode kernel's operations one by one
    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(t), jnp.asarray(R), jnp.asarray(colors))
    args = [torch.tensor(x, requires_grad=True) for x in (t, R, colors)]
    out = TR.rasterize_batch(verts, faces, args[2], K, args[1], args[0],
                             device="cpu", **kw)
    loss_terms(out, w).backward()
    return [np.asarray(g) for g in gj], [a.grad.numpy() for a in args]


def check(gj, gt, rtol, atol):
    for name, a, b in zip(("t", "R", "colors"), gj, gt):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol, err_msg=name)
        assert np.abs(a).max() > 1e-2, name       # the gradient is live


@pytest.mark.parametrize("mesh,with_prob,zbuf,hw", CASES)
def test_plain_bwd_matches_jax_pallas_vjp(interpret_mode, mesh, with_prob,
                                          zbuf, hw):
    check(*grads_both(mesh, "pallas", hw, with_prob, zbuf), 1e-4, 1e-6)


@pytest.mark.parametrize("mesh,with_prob,zbuf,hw", [
    ("sphere", True, "persp", (32, 32)), ("cube", True, "face", (32, 32)),
    ("sphere", False, "face", (40, 56))])
def test_plain_bwd_matches_jax_xla_autodiff(interpret_mode, mesh, with_prob,
                                            zbuf, hw):
    check(*grads_both(mesh, "xla", hw, with_prob, zbuf), 2e-2, 1e-3)


def test_fine_raster_function_routes_by_impl_and_device():
    """FineRaster runs the plain versions on CPU tensors whatever impl says;
    without gradients rasterize_batch skips the Function; mask, face_id and
    bary carry no gradient."""
    verts, faces, colors, K, R, t = scene("sphere")
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    ftab, cand = TR.raster_inputs(f32(verts), torch.as_tensor(faces),
                                  f32(colors), f32(K), f32(R), f32(t), 32, 32,
                                  16, 16)
    ftab.requires_grad_(True)
    before = (RC.fine_raster.launches, RC.fine_raster_bwd.launches)
    outs = [RC.FineRaster.apply(ftab, cand, 32, 32, 16, 1.0, True, True, impl)
            for impl in ("kernel", "plain")]
    grads = []
    for out in outs:
        mask, prob, depth, attr, face_id, bary = out
        assert not (mask.requires_grad or face_id.requires_grad
                    or bary.requires_grad)
        (g,) = torch.autograd.grad(prob.sum() + depth.sum() + attr.sum(), ftab)
        grads.append(g)
    assert (RC.fine_raster.launches, RC.fine_raster_bwd.launches) == before
    torch.testing.assert_close(grads[0], grads[1], rtol=0, atol=0)
    assert grads[0][..., 7].abs().max() == 0          # `valid` gets nothing
    with torch.no_grad():
        out = TR.rasterize_batch(verts, faces, colors, K, R, t, height=32,
                                 width=32, tile_px=16, faces_per_tile=16,
                                 device="cpu")
    assert out.prob.grad_fn is None
