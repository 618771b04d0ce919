"""The LAB modes of the port's stage-II step (lab_impl 'surrogate',
'split_grad', 'pixel_split' beside 'direct' and 'pallas'):
ops/color.py::lab_loss_surrogate and engine/self_engine.py::
make_lab_pixel_fn against the JAX package's at 1e-6, and one micro
stage-II step in each mode, routed by build_self_train_step, against the
port's 'direct' step (parameters within 1e-6). No JAX stage-II step is
jitted here."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.ops import color as jcol
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.engine import self_engine as se
from self6dpp_tpu_torch.losses.self_loss import check_supported
from self6dpp_tpu_torch.ops import color as tcol
from self6dpp_tpu_torch.utils import profiling

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def pair(seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    pred = rng.random((b, s, s, 3)).astype(np.float32)
    gt = rng.random((b, s, s, 3)).astype(np.float32)
    mask = (rng.random((b, s, s)) > 0.3).astype(np.float32)
    return pred, gt, mask


@pytest.mark.parametrize("no_l", [True, False])
def test_lab_loss_surrogate_matches_jax(no_l):
    pred, gt, mask = pair(1)
    jv, jg = jax.value_and_grad(
        lambda p: jcol.lab_loss_surrogate(p, gt, mask=mask, no_l=no_l))(
        jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    tv = tcol.lab_loss_surrogate(p, torch.from_numpy(gt),
                                 mask=torch.from_numpy(mask), no_l=no_l)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=TOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg), rtol=TOL,
                               atol=TOL * np.abs(np.asarray(jg)).max())
    # the same value and gradient as lab_loss itself
    q = torch.from_numpy(pred).requires_grad_(True)
    dv = tcol.lab_loss(q, torch.from_numpy(gt), mask=torch.from_numpy(mask),
                       no_l=no_l)
    dv.backward()
    assert tv.item() == dv.item()
    assert torch.equal(p.grad, q.grad)


def test_lab_pixel_fn_matches_jax():
    pred, gt, mask = pair(2)
    ss = dict(lab_lw=0.2, lab_no_l=True)
    jv, jg = jse.make_lab_pixel_fn(jc.Config(self_sup=jc.SelfSupConfig(**ss)))(
        jnp.asarray(pred), jnp.asarray(gt), jnp.asarray(mask))
    tv, tg = se.make_lab_pixel_fn(tc.Config(self_sup=tc.SelfSupConfig(**ss)))(
        torch.from_numpy(pred), torch.from_numpy(gt), torch.from_numpy(mask))
    np.testing.assert_allclose(tv.item(), float(jv), rtol=TOL)
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=TOL,
                               atol=TOL * np.abs(jg).max())


def test_every_mode_is_accepted():
    for mode in ("pixel_split", "split_grad", "surrogate", "direct", "pallas"):
        check_supported(tc.SelfSupConfig(lab_lw=0.2, lab_impl=mode))
    with pytest.raises(ValueError, match="lab_impl"):
        check_supported(tc.SelfSupConfig(lab_lw=0.2, lab_impl="fused"))


@pytest.fixture(scope="module")
def built():
    """One micro stage-II build (lab_lw 0.5) and a copy of its state: each
    mode's step starts from that copy."""
    cfg = tc.stage2_pose_tiny()
    # a constant learning rate: the first step moves the parameters by
    # ~1e-3 (flat_and_anneal's first rate is base_lr x warmup_factor)
    cfg = dataclasses.replace(
        cfg, self_sup=dataclasses.replace(cfg.self_sup, lab_lw=0.5),
        solver=dataclasses.replace(cfg.solver, lr_sched="constant"))
    model, state, batch, lpips = se.build_stage2(cfg, 2, "cpu")
    snap = copy.deepcopy((model.state_dict(), state.teacher.state_dict(),
                          state.opt.state_dict()))
    return cfg, model, state, batch, lpips, snap


def one_step(built, mode):
    cfg, model, state, batch, lpips, snap = built
    model.load_state_dict(snap[0])
    state.teacher.load_state_dict(snap[1])
    state.opt.load_state_dict(copy.deepcopy(snap[2]))
    state.step = 0
    cfg = dataclasses.replace(cfg, self_sup=dataclasses.replace(
        cfg.self_sup, lab_impl=mode))
    step = se.build_self_train_step(cfg, model, lpips, impl="plain")
    with profiling.recording() as rec:
        _, metrics = step(state, batch)
    return ([p.detach().clone() for p in model.parameters()],
            {k: float(v) for k, v in metrics.items()}, rec.spans)


@pytest.fixture(scope="module")
def direct(built):
    return one_step(built, "direct")


@pytest.mark.parametrize("mode", ["surrogate", "split_grad", "pixel_split",
                                  "pallas"])
def test_stage2_step_in_each_mode_equals_direct(mode, built, direct):
    params, metrics, spans = one_step(built, mode)
    ref_params, ref_metrics, _ = direct
    # every mode's step, side steps included, is one root span over the
    # pose step's phases
    assert [s.name for s in spans if s.parent < 0] == ["train_step"]
    assert {s.name for s in spans if s.parent == 0} >= {
        "student_fwd", "teacher_fwd", "render_fwd", "losses", "backward",
        "optimizer_ema"}
    assert ref_metrics["loss_color_ab_obj"] > 0
    assert sorted(metrics) == sorted(ref_metrics)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(metrics[k], v, rtol=TOL, err_msg=k)
    init = [built[5][0][n] for n, _ in built[1].named_parameters()]
    moved = 0.0
    for a, b, c in zip(params, ref_params, init):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=TOL)
        moved = max(moved, (b - c).abs().max().item())
    assert moved > 100 * TOL
