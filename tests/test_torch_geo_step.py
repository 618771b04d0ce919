"""The port's geo-mode and synsup steps and its mode picker against the JAX
package's, in float32 on the CPU, at test size with the MaskNormVF heads
(micro backbone, 64² ROI, 16² output, 2 classes, 4 vector-field points):
two geo steps fed JAX's own warp and colour-jitter draws (jax.random
cannot be reproduced in torch, so the port's step takes its draws as an
argument), two synsup steps, the mode sequence of each schedule for a
seed, and the gated EMA decay. Teacher and EMA ramp as in
test_torch_self_engine.py; the mask logit is biased to 2 (probability
0.88), so the teacher's thresholded mask stays clear of 0.5 but where the
warp blends it with the zero border.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.engine.optim import build_optimizer
from self6dpp_tpu.engine.train_state import create_train_state
from self6dpp_tpu.ops.warp import sample_pose_variated_affines
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import (gdrn_flax_to_state_dict,
                                        gdrn_state_dict_to_flax)
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.engine import train_state as tts
from test_torch_gdrn_train import jax_tree, to_jax
from test_torch_self_engine import aim, cpu_run, noisy

RTOL, ATOL = 1e-4, 1e-6
STEPS = 2
MASK_BIAS = 2.0


def setup():
    t = tc.masknormvf_tiny()
    t = dataclasses.replace(
        t, solver=dataclasses.replace(t.solver, ema_warmup_iters=1),
        self_sup=dataclasses.replace(t.self_sup, vf_lw=1.0, norm_lw=1.0))
    tb = tse.stage2_batch(t, 2, "cpu")
    jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
    jcfg = to_jax(t)
    jmodel = jge.build_gdrn(jcfg)
    z_rel = float(np.median(tb["gt_trans"][:, 2].numpy()
                            / tb["resize_ratio"].numpy()))
    variables = aim(gdrn_state_dict_to_flax(
        tge.build_gdrn(t, device="cpu", seed=0)), z_rel)
    variables["params"]["geo_head"]["Conv_0"]["bias"][0] = MASK_BIAS
    teacher = {"params": noisy(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    return dict(t=t, jcfg=jcfg, tb=tb, jb=jb, jmodel=jmodel,
                variables=variables, teacher=teacher)


def jax_state(s):
    tx, _ = build_optimizer(s["jcfg"].solver, flatten=True)
    st = create_train_state(jax_tree(s["variables"]["params"]),
                            jax_tree(s["variables"]["batch_stats"]), tx)
    return st.replace(ema_params=jax_tree(s["teacher"]["params"]))


def port_state(s):
    model = tge.build_gdrn(s["t"], device="cpu")
    model.load_state_dict(gdrn_flax_to_state_dict(s["variables"], model))
    state = tge.init_state(s["t"], model)
    state.teacher.load_state_dict(gdrn_flax_to_state_dict(s["teacher"], model))
    return model, state


def jax_geo_draws(jcfg, img, key):
    """The draws of JAX's geo step for `key`, split as it splits them."""
    ss = jcfg.self_sup
    r1, r2, r3, r4 = jax.random.split(key, 4)
    b = img.shape[0]
    mats = sample_pose_variated_affines(
        r4, b, rot_deg=ss.geo_aug_rot_deg, zoom=ss.geo_aug_zoom,
        trans=ss.geo_aug_trans, crop_percent=ss.geo_aug_crop)
    return {"mats": mats,
            "gain": jax.random.uniform(r1, (b, 1, 1, 1), minval=0.8,
                                       maxval=1.2),
            "shift": jax.random.uniform(r2, (b, 1, 1, 3), minval=-0.05,
                                        maxval=0.05),
            "noise": jax.random.normal(r3, img.shape)}


def _runs():
    s = setup()
    out = {"init": None}
    keys = [jax.random.PRNGKey(i + 1) for i in range(STEPS)]
    for name in ("geo", "synsup"):
        make = (jse.make_self_geo_train_step if name == "geo"
                else jse.make_synsup_train_step)
        jstep = jax.jit(make(s["jcfg"], s["jmodel"]))
        jstate, jm = jax_state(s), []
        for k in keys:
            jstate, m = jstep(jstate, s["jb"], k)
            jm.append({k: float(v) for k, v in m.items()})
        model, state = port_state(s)
        out["init"] = gdrn_flax_to_state_dict(s["variables"], model)
        tstep = (tse.make_self_geo_train_step(s["t"], model) if name == "geo"
                 else tse.make_synsup_train_step(s["t"], model))
        tm = []
        for k in keys:
            if name == "geo":
                aug = {n: torch.from_numpy(np.array(v)) for n, v in
                       jax_geo_draws(s["jcfg"], s["jb"]["roi_img"], k).items()}
                state, m = tstep(state, s["tb"], aug)
            else:
                state, m = tstep(state, s["tb"])
            tm.append({k: float(v) for k, v in m.items()})
        out[name] = dict(jstate=jstate, jm=jm, tstate=state, tm=tm)
    return out


@pytest.fixture(scope="module")
def runs():
    return cpu_run(_runs)


@pytest.mark.parametrize("name", ["geo", "synsup"])
def test_step_losses_match_jax(runs, name):
    r = runs[name]
    want = ({"loss_vis_mask_init_pred", "loss_init_pred_xyz",
             "loss_region_init_pred", "loss_vf", "loss_norm"} if name == "geo"
            else {"loss_vf_vis", "loss_vf_full", "loss_norm", "loss_mask_full"})
    for jm, tm in zip(r["jm"], r["tm"]):
        assert set(jm) == set(tm) and want <= set(tm), sorted(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
            assert np.isfinite(tm[k]) and tm[k] > 0, k


@pytest.mark.parametrize("which", ["params", "ema_params"])
@pytest.mark.parametrize("name", ["geo", "synsup"])
def test_step_params_match_jax(runs, name, which):
    r = runs[name]
    j, ts = r["jstate"], r["tstate"]
    ref = gdrn_flax_to_state_dict(
        {"params": getattr(j, which), "batch_stats": j.batch_stats}, ts.model)
    net = ts.model if which == "params" else ts.teacher
    init = runs["init"]
    moved = 0.0
    for k, v in net.named_parameters():
        v = v.detach()
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        moved = max(moved, ((v - init[k]).abs()
                            / (ATOL + RTOL * init[k].abs())).max().item())
    assert moved > 10, moved


def test_geo_steps_run_no_render(runs, monkeypatch):
    """Neither step renders: the rasterizer is never called."""
    from self6dpp_tpu_torch.ops import rasterizer as R
    calls = []
    monkeypatch.setattr(R, "raster_inputs", lambda *a, **k: calls.append(1))
    s = setup()
    model, state = port_state(s)
    aug = tse.draw_geo_aug(s["t"], s["tb"], torch.Generator().manual_seed(0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tse.make_self_geo_train_step(s["t"], model)(state, s["tb"], aug)
        tse.make_synsup_train_step(s["t"], model)(state, s["tb"])
    finally:
        torch.set_num_threads(threads)
    assert not calls
    assert set(aug) == {"mats", "gain", "shift", "noise"}
    assert aug["noise"].shape == s["tb"]["roi_img"].shape


SCHEDULES = [("random", 0.3), ("random", 0.5), ("alternate", 0.25),
             ("alternate", 0.3), ("fix_pose", 0.5), ("fix_geo", 0.0),
             ("random", 0.0)]


@pytest.mark.parametrize("sched,ratio", SCHEDULES)
def test_mode_picker_matches_jax(sched, ratio):
    from self6dpp_tpu.config import base as jc
    t = dataclasses.replace(tc.SelfSupConfig(), mode_schedule=sched,
                            geo_mode_ratio=ratio)
    j = dataclasses.replace(jc.SelfSupConfig(), mode_schedule=sched,
                            geo_mode_ratio=ratio)
    jp = jse.make_mode_picker(j, np.random.default_rng(7))
    tp = tse.make_mode_picker(t, np.random.default_rng(7))
    seq = [tp() for _ in range(60)]
    assert seq == [jp() for _ in range(60)]
    assert set(seq) <= {"pose", "geo"}


def test_mode_picker_rejects_an_unknown_schedule():
    t = dataclasses.replace(tc.SelfSupConfig(), mode_schedule="every_other")
    with pytest.raises(ValueError, match="mode_schedule"):
        tse.make_mode_picker(t, np.random.default_rng(0))


@pytest.mark.parametrize("every", [1, 3])
def test_gated_ema_decay_matches_jax(every):
    jd = jse.gated_ema_decay(0.999, 10, every)
    td = tts.gated_ema_decay(0.999, 10, every)
    for step in range(1, 10):
        np.testing.assert_allclose(float(td(step)),
                                   float(jd(jnp.int32(step))), rtol=1e-6,
                                   err_msg=str(step))
