"""The port's stage-II pose step with the in-step refiners against the JAX
package's, in float32 on the CPU: refine_with_deepim (the teacher's pseudo
pose refined by 2 DeepIM iterations: micro FlowNetS, 32² zoom, 8 input
channels with the pseudo mask, no mask or flow head, as
tests/test_self_engine.py::test_refine_with_deepim_in_loop builds it) and
repj_refine (the RepjRefiner weak loss on the student's pose at 64²) on
test_torch_self_engine.py's tiny step, weights and batch, LPIPS off. Two
Ranger steps: every loss term, the parameters and the EMA teacher at 1e-4.
The refiner's weights go across with convert.py. The JAX side renders the
student in Pallas interpret mode, the refiner and the repj renders on its
XLA path (their renders take no impl); the port on its plain fine stage.

The step's mask head has one channel, so repj's full mask is its visible
mask and every view's cosine is 1 up to float32 rounding: the best view is
a tie that each package's summation order breaks. The JAX step's pick is
recorded from inside its jitted step and pinned in the port's batch
("repj_best"), so every term is compared at one chosen view.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import self6dpp_tpu.models.deepim as JDM
import self6dpp_tpu.models.repj_refiner as JRR
from self6dpp_tpu.config import base as jc
from self6dpp_tpu.engine import deepim_engine as jde
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.models.backbones.flownet import FlowNetS as JFlowNetS
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import flax_to_state_dict, gdrn_flax_to_state_dict
from self6dpp_tpu_torch.engine import deepim_engine as tde
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.models.deepim import DeepIM
from self6dpp_tpu_torch.models.repj_refiner import view_cosines
from test_torch_deepim import MICRO, identity_heads, random_params
from test_torch_self_engine import cpu_run, jax_cfg, jax_state, setup

RTOL, ATOL = 1e-4, 1e-6
STEPS = 2
REFINER = dict(num_classes=2, input_h=32, input_w=32, in_channels=8,
               n_iter_test=2, flow_lw=0.0, with_flow=False,
               with_mask_head=False)


def configs():
    s = setup()
    t = s["tcfg"]
    t = dataclasses.replace(t, self_sup=dataclasses.replace(
        t.self_sup, refine_with_deepim=True, repj_refine=True,
        perceptual_lw=0.0))
    rt = tc.Config(deepim=tc.DeepIMConfig(**REFINER), renderer=t.renderer,
                   dist=tc.DistConfig(compute_dtype="float32"))
    rj = jc.Config(deepim=jc.DeepIMConfig(**REFINER),
                   renderer=jc.RendererConfig(
                       tile_px=t.renderer.tile_px,
                       faces_per_tile=t.renderer.faces_per_tile),
                   dist=jc.DistConfig(compute_dtype="float32"))
    return s, t, jax_cfg(t), rt, rj


def _jax_cosines(vis_prob, full_prob):
    """repj_weak_loss's best-view cosines, as its own lines compute them
    (self6dpp_tpu/models/repj_refiner.py:192-199)."""
    B = vis_prob.shape[0]
    f = full_prob.reshape(B, -1)
    v = vis_prob.reshape(B, -1)
    h = (f > 0.5).astype(f.dtype)
    dot = (f * v * h).sum(-1)
    nrm = jnp.sqrt(jnp.maximum((f * f * h).sum(-1), 1e-12)) * \
        jnp.sqrt(jnp.maximum((v * v * h).sum(-1), 1e-12))
    return dot / jnp.maximum(nrm, 1e-12)


def _runs():
    s, tcfg, jcfg, rt, rj = configs()
    mp = pytest.MonkeyPatch()
    mp.setattr(JDM, "FlowNetS", functools.partial(JFlowNetS, widths=MICRO))
    jcos, tcos = [], []
    jrepj, trepj = JRR.repj_weak_loss, tse.repj_weak_loss

    def jax_repj(rot, trans, vis_prob, full_prob, *a, **k):
        jax.debug.callback(lambda c: jcos.append(np.asarray(c)),
                           _jax_cosines(vis_prob, full_prob), ordered=True)
        return jrepj(rot, trans, vis_prob, full_prob, *a, **k)

    def port_repj(rot, trans, vis_prob, full_prob, *a, **k):
        tcos.append(view_cosines(vis_prob, full_prob).detach().numpy())
        return trepj(rot, trans, vis_prob, full_prob, *a, **k)
    mp.setattr(JRR, "repj_weak_loss", jax_repj)
    try:
        dmodel = jde.build_deepim(rj)
        b = s["jb"]
        x = jnp.zeros((2, 32, 32, 8))
        v = jax.jit(dmodel.init)(jax.random.PRNGKey(2), x, b["gt_rot"],
                                 b["gt_trans"], b["roi_zoom_K"])
        rparams = identity_heads(random_params(
            jax.tree_util.tree_map(np.asarray, v["params"]), 3, 0.05))
        jstep = jax.jit(jse.make_self_train_step(
            jcfg, s["jmodel"], refiner=(dmodel, {"params": rparams}, rj)))
        jstate, jmetrics = jax_state(s), []
        for _ in range(STEPS):
            jstate, m = jstep(jstate, None, b, jax.random.PRNGKey(0))
            jmetrics.append({k: float(x) for k, x in m.items()})
    finally:
        mp.undo()

    refiner = DeepIM(rt.deepim, widths=MICRO).eval()
    refiner.load_state_dict(flax_to_state_dict(rparams, refiner), strict=True)
    model = tge.build_gdrn(tcfg, device="cpu")
    model.load_state_dict(gdrn_flax_to_state_dict(s["variables"], model))
    state = tge.init_state(tcfg, model)
    state.teacher.load_state_dict(gdrn_flax_to_state_dict(s["teacher"], model))
    step = tse.make_self_train_step(tcfg, model, refiner=(refiner, rt))
    tmetrics = []
    mp.setattr(tse, "repj_weak_loss", port_repj)
    try:
        for i in range(STEPS):
            best = torch.tensor([int(np.argmax(jcos[i]))])
            state, m = step(state, dict(s["tb"], repj_best=best))
            tmetrics.append({k: float(x) for k, x in m.items()})
    finally:
        mp.undo()
    return dict(s=s, rt=rt, refiner=refiner, jstate=jstate,
                jmetrics=jmetrics, tstate=state, tmetrics=tmetrics,
                jcos=jcos, tcos=tcos,
                init=gdrn_flax_to_state_dict(s["variables"], model))


@pytest.fixture(scope="module")
def runs():
    return cpu_run(_runs)


def test_refined_step_metrics_match_jax(runs):
    for jm, tm in zip(runs["jmetrics"], runs["tmetrics"]):
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    last = runs["tmetrics"][-1]
    repj = {k for k in last if "repj" in k}
    assert repj == {"loss_PM_R_repj", "loss_PM_T_repj", "loss_repj_3d2d_iou",
                    *(f"loss_repj_{t}_{s}" for t in ("miou", "msssim")
                      for s in (1, 2, 4))}
    assert all(last[k] > 0 for k in repj if "miou" in k), last


def test_best_view_is_a_float32_tie(runs):
    """With one mask channel the best-view cosines are all 1 but for
    rounding: in each step they lie within 4 float32 ulps of 1, so
    neither package's pick (the argmax of its own rounded cosines) is a
    property of the model, and the step pins the JAX pick in the port."""
    ulp = np.spacing(np.float32(1))
    assert len(runs["jcos"]) == len(runs["tcos"]) == STEPS
    for jc_, tc_ in zip(runs["jcos"], runs["tcos"]):
        assert jc_.dtype == tc_.dtype == np.float32
        assert jc_.shape == tc_.shape == (2,)
        np.testing.assert_allclose(jc_, 1.0, rtol=0, atol=4 * ulp)
        np.testing.assert_allclose(tc_, 1.0, rtol=0, atol=4 * ulp)


@pytest.mark.parametrize("which", ["params", "ema_params"])
def test_refined_step_params_match_jax(runs, which):
    j = runs["jstate"]
    ts = runs["tstate"]
    ref = gdrn_flax_to_state_dict({"params": getattr(j, which),
                                   "batch_stats": j.batch_stats}, ts.model)
    net = ts.model if which == "params" else ts.teacher
    init = runs["init"]
    moved = 0.0
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        moved = max(moved, ((p.detach() - init[k]).abs()
                            / (ATOL + RTOL * init[k].abs())).max().item())
    assert moved > 100, moved


def test_the_refiner_moves_the_pseudo_pose(runs):
    """The refine the step runs (its 2 iterations on the ROI frame) moves
    the teacher's pose well past the tolerance, so the PM terms above read
    a refined pose."""
    s, rt = runs["s"], runs["rt"]
    tb = s["tb"]
    state = tge.init_state(s["tcfg"], tge.build_gdrn(s["tcfg"], device="cpu"))
    state.teacher.load_state_dict(gdrn_flax_to_state_dict(
        s["teacher"], state.model))
    with torch.no_grad():
        tout = state.teacher(*tge.model_inputs(tb))
    refine = tde.make_refine_fn(rt, runs["refiner"], rt.deepim.n_iter_test)
    obs_mask = torch.ones(tb["roi_img"].shape[:3])
    with torch.no_grad():
        rot, trans = refine(tse.refiner_batch(tb, obs_mask), tout["rot"],
                            tout["trans"])
    assert (rot - tout["rot"]).abs().max() > 1e-2
    assert (trans - tout["trans"]).abs().max() > 1e-3


def test_refine_with_deepim_needs_the_refiner():
    cfg = tc.stage2_refined_flagship()
    model = tge.build_gdrn(tc.stage2_pose_tiny(), device="cpu")
    with pytest.raises(ValueError, match="needs the refiner"):
        tse.make_self_train_step(cfg, model)


def test_refined_flagship_config():
    """stage2_refined_flagship is stage2_pose_flagship with the refiners
    that configs/self6dpp/synthetic_smoke.py turns on, at the JAX
    package's repj weights and a 64² render."""
    import importlib.util
    import os
    t = tc.stage2_refined_flagship()
    f = tc.stage2_pose_flagship()
    assert dataclasses.replace(t, exp_name=f.exp_name,
                               self_sup=f.self_sup) == f
    assert dataclasses.replace(t.self_sup, refine_with_deepim=False,
                               repj_refine=False) == f.self_sup
    ss, js = t.self_sup, jc.SelfSupConfig()
    assert ss.refine_with_deepim and ss.repj_refine
    for k in ("repj_iou2d3d_lw", "repj_pm_lw", "repj_miou_lw",
              "repj_msssim_lw", "repj_render_res"):
        assert getattr(ss, k) == getattr(js, k), k
    path = os.path.join(os.path.dirname(__file__), "..", "configs",
                        "self6dpp", "synthetic_smoke.py")
    spec = importlib.util.spec_from_file_location("_s2_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    smoke = mod.get_config().self_sup
    assert smoke.refine_with_deepim and smoke.repj_refine
