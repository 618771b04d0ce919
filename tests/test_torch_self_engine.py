"""The port's stage-II pose-mode step against the JAX package's, on the same
weights and batch, in float32 on the CPU: two tiny steps (micro backbone,
64² ROI, 16² output, 2 classes) of the whole loss suite (mask, LAB, LPIPS
with the same weights on both sides, MS-SSIM at 3 levels, depth chamfer,
init-pred, PM, trans) through Ranger with no warm-up, the renderer's fine
stage in Pallas interpret mode and LAB through its Pallas kernel on the JAX
side, the plain versions of B1-B3 on the port's side; and two split_lab
steps fed a fixed lab_linear.

The pose heads are biased so the student's pose puts the mesh in view (the
render, and so its gradient, is not empty); the mask logit is biased so the
teacher's pseudo mask covers the ROI (LAB and the init-pred terms then see
every pixel, and no rendered pixel sits in RW_BCE's saturated negative
term, where XLA's fused evaluation of -log(1 - p + 1e-8) rounds away from
the literal one); the teacher is the student with 5 % noise and a rotation
head turned by about 0.1 rad, as a teacher after some training is, and the
EMA ramps over 1 step instead of 2000 (decay 0.63, then 0.86), so the
teacher stays apart from the student: the pseudo pose is not the student's
own, and the PM and init-pred terms do not measure a difference of nearly
equal numbers. Both sides get the same weights.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

import self6dpp_tpu.ops.raster_pallas as RP
from self6dpp_tpu.config import base as jc
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine import self_engine as jse
from self6dpp_tpu.engine.optim import build_optimizer
from self6dpp_tpu.engine.train_state import create_train_state
from self6dpp_tpu.models.lpips import LPIPS
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import (gdrn_flax_to_state_dict,
                                        lpips_flax_to_state_dict)
from self6dpp_tpu_torch.data.meshes import make_icosphere
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine import self_engine as tse
from self6dpp_tpu_torch.models import lpips as TL
from test_torch_gdrn import port_to_flax

RTOL, ATOL = 1e-4, 1e-6
STEPS = 2
RENDER_LOSSES = ("mask_lw", "lab_lw", "perceptual_lw", "ms_ssim_lw",
                 "depth_chamfer_lw")
_orig_pallas_call = pl.pallas_call


def _interp_pallas_call(*args, **kw):
    kw.setdefault("interpret", True)
    return _orig_pallas_call(*args, **kw)


def jax_cfg(t: tc.Config) -> jc.Config:
    """The JAX package's Config with the same values as the port's."""
    def conv(obj, cls):
        return cls(**{f.name: getattr(obj, f.name)
                      for f in dataclasses.fields(obj)})
    m = t.model
    return jc.Config(
        model=jc.PoseNetConfig(
            num_classes=m.num_classes, input_res=m.input_res,
            output_res=m.output_res,
            backbone=conv(m.backbone, jc.BackboneConfig),
            geo_head=conv(m.geo_head, jc.GeoHeadConfig),
            pnp_net=conv(m.pnp_net, jc.PnPNetConfig),
            loss=conv(m.loss, jc.LossConfig)),
        solver=conv(t.solver, jc.SolverConfig),
        renderer=jc.RendererConfig(tile_px=t.renderer.tile_px,
                                   faces_per_tile=t.renderer.faces_per_tile,
                                   impl="pallas"),
        self_sup=dataclasses.replace(jc.SelfSupConfig(), **{
            f.name: getattr(t.self_sup, f.name)
            for f in dataclasses.fields(t.self_sup)}),
        dist=jc.DistConfig(compute_dtype="float32"))


def aim(variables, z_rel):
    """Identity-biased rotation head, z bias z_rel, mask logit bias 10."""
    v = jax.tree_util.tree_map(lambda x: np.array(x, np.float32), variables)
    pn = v["params"]["pnp_net"]
    pn["fc_r"]["bias"] = np.array([1.0, 0, 0, 0, 1.0, 0], np.float32)
    pn["fc_t"]["bias"] = np.array([0.0, 0.0, z_rel], np.float32)
    v["params"]["geo_head"]["Conv_0"]["bias"][0] = 10.0
    return v


def noisy(params, seed=3, rel=0.05):
    rng = np.random.default_rng(seed)
    p = jax.tree_util.tree_map(
        lambda x: (x * (1 + rel * rng.standard_normal(x.shape))).astype(
            np.float32), params)
    p["pnp_net"]["fc_r"]["bias"] += np.array([0, 0.1, 0, -0.1, 0, 0.05],
                                             np.float32)
    return p


def cpu_run(fn):
    # one torch thread: the CPU build's oneDNN convolution backward has
    # crashed (SIGSEGV) with 4 or more threads on the GDRN backbone + head
    # backward; with one thread, or with torch.backends.mkldnn off, it runs
    mp = pytest.MonkeyPatch()
    mp.setattr(RP.pl, "pallas_call", _interp_pallas_call)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)
        mp.undo()


@pytest.fixture(scope="module")
def runs():
    return cpu_run(_runs)


@pytest.fixture(scope="module")
def split_run():
    return cpu_run(_split_run)


def setup():
    """Config, batches, the JAX model, the shared weights (student, teacher,
    LPIPS) and the port's LPIPS. The batch's image is the mesh rendered at
    the ground-truth pose, half mixed with the batch's noise: against a
    noise image some MS-SSIM level's contrast-structure term is negative,
    where MS-SSIM is 0 and JAX's gradient NaN (test_torch_ssim.py)."""
    tcfg = tc.stage2_pose_tiny()
    tcfg = dataclasses.replace(tcfg, solver=dataclasses.replace(
        tcfg.solver, ema_warmup_iters=1))
    jcfg = jax_cfg(tcfg)
    tb = tse.stage2_batch(tcfg, 2, "cpu", mesh=make_icosphere(0.06, 2))
    with torch.no_grad():
        gt = tse.render_student_pose(tcfg, tb, tb["gt_rot"], tb["gt_trans"])
    tb["roi_img"] = 0.5 * tb["roi_img"] + 0.5 * gt["color"]
    jb = {k: jnp.asarray(np.array(v.numpy())) for k, v in tb.items()}
    z_rel = float(np.median(tb["gt_trans"][:, 2].numpy()
                            / tb["resize_ratio"].numpy()))

    jmodel = jge.build_gdrn(jcfg)
    # the port's seeded weights in the JAX model's variables (whose shapes
    # are traced, not computed) and the optimizer of jge.init_state
    shapes = jax.eval_shape(
        lambda k, *a: jmodel.init(k, *a, train=False), jax.random.PRNGKey(0),
        *jge.model_inputs(jb))
    variables = aim(port_to_flax(tge.build_gdrn(tcfg, device="cpu", seed=0),
                                 shapes), z_rel)
    teacher = {"params": noisy(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    lp = jax.jit(LPIPS().init)(jax.random.PRNGKey(1), jb["roi_img"],
                               jb["roi_img"])["params"]
    tlpips = TL.LPIPS()
    tlpips.load_state_dict(lpips_flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, lp), tlpips))
    return dict(tcfg=tcfg, jcfg=jcfg, tb=tb, jb=jb, jmodel=jmodel,
                variables=variables, teacher=teacher, lp=lp,
                tlpips=tlpips.eval().requires_grad_(False))


def jax_state(s):
    tx, _ = build_optimizer(s["jcfg"].solver,
                            flatten=s["jcfg"].dist.mesh_shape[-1] == 1)
    jstate = create_train_state(
        jax.tree_util.tree_map(jnp.asarray, s["variables"]["params"]),
        s["variables"]["batch_stats"], tx)
    return jstate.replace(ema_params=jax.tree_util.tree_map(
        jnp.asarray, s["teacher"]["params"]))


def port_run(s, cfg, steps, split_lab=False, lab_linear=None):
    model = tge.build_gdrn(cfg, device="cpu")
    model.load_state_dict(gdrn_flax_to_state_dict(s["variables"], model))
    state = tge.init_state(cfg, model)
    state.teacher.load_state_dict(gdrn_flax_to_state_dict(s["teacher"], model))
    step = tse.make_self_train_step(cfg, model, s["tlpips"],
                                    split_lab=split_lab)
    metrics = []
    for _ in range(steps):
        state, m = step(state, s["tb"], lab_linear=lab_linear)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _runs():
    s = setup()
    jstate = jax_state(s)
    jstep = jax.jit(jse.make_self_train_step(s["jcfg"], s["jmodel"], LPIPS()))
    jmetrics = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, s["lp"], s["jb"], jax.random.PRNGKey(0))
        jmetrics.append({k: float(v) for k, v in m.items()})

    tcfg = s["tcfg"]
    tstate, tmetrics = port_run(s, tcfg, STEPS)
    # the control zeroes every loss that reads the render
    control = dataclasses.replace(tcfg, self_sup=dataclasses.replace(
        tcfg.self_sup, **{k: 0.0 for k in RENDER_LOSSES}))
    cstate, _ = port_run(s, control, STEPS)
    init = gdrn_flax_to_state_dict(s["variables"], tstate.model)
    return dict(jstate=jstate, jmetrics=jmetrics, tstate=tstate,
                tmetrics=tmetrics, cstate=cstate, init=init,
                variables=s["variables"])


def _split_run():
    """Two split_lab steps (LAB's weight 0 in the loss) fed lab_linear =
    (0.37, g), g seeded, on both sides. (Two: the schedule's first learning
    rate is 1e-6, its warm-up factor.)"""
    s = setup()
    g = (1e-2 * np.random.default_rng(5).standard_normal(
        tuple(s["tb"]["roi_img"].shape))).astype(np.float32)
    jstep = jax.jit(jse.make_self_train_step(s["jcfg"], s["jmodel"], LPIPS(),
                                             split_lab=True))
    jstate, jmetrics = jax_state(s), []
    for _ in range(STEPS):
        jstate, jm = jstep(jstate, s["lp"], s["jb"], jax.random.PRNGKey(0),
                           None, None, (jnp.float32(0.37), jnp.asarray(g)))
        jmetrics.append({k: float(v) for k, v in jm.items()})
    tstate, tm = port_run(s, s["tcfg"], STEPS, split_lab=True,
                          lab_linear=(0.37, torch.from_numpy(g)))
    return dict(jstate=jstate, jmetrics=jmetrics, tstate=tstate, tmetrics=tm,
                init=gdrn_flax_to_state_dict(s["variables"], tstate.model))


def _params(model):
    return {k: v.detach() for k, v in model.named_parameters()}


def test_metrics_match_jax(runs):
    for jm, tm in zip(runs["jmetrics"], runs["tmetrics"]):
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
            assert tm[k] > 0, k          # every term is live


@pytest.mark.parametrize("which", ["params", "ema_params"])
def test_params_match_jax(runs, which):
    j = runs["jstate"]
    tree = {"params": getattr(j, which), "batch_stats": j.batch_stats}
    ts = runs["tstate"]
    ref = gdrn_flax_to_state_dict(tree, ts.model)
    got = _params(ts.model if which == "params" else ts.teacher)
    init = runs["init"]
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    # the steps moved the parameters far past the tolerance
    moved = max(((got[k] - init[k]).abs() / (ATOL + RTOL * init[k].abs()))
                .max().item() for k in got)
    assert moved > 100, moved


def test_render_gradient_reaches_params(runs):
    """Without the losses that read the render (mask, LAB, LPIPS, MS-SSIM,
    chamfer) the update differs from the full step's by more than the
    tolerance: the render's gradient (through FineRaster's backward)
    reaches the network."""
    full = _params(runs["tstate"].model)
    ctrl = _params(runs["cstate"].model)
    diff = max(((full[k] - ctrl[k]).abs()
                - (ATOL + RTOL * ctrl[k].abs())).max().item() for k in full)
    assert diff > 0, diff


def test_split_lab_step_matches_jax(split_run):
    """The split_lab step with a given lab_linear: every term (LAB's is the
    given value) and the updated parameters as the JAX step's."""
    for jm, tm in zip(split_run["jmetrics"], split_run["tmetrics"]):
        assert set(jm) == set(tm)
        assert tm["loss_color_ab_obj"] == np.float32(0.37)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    j = split_run["jstate"]
    ts = split_run["tstate"]
    ref = gdrn_flax_to_state_dict({"params": j.params,
                                   "batch_stats": j.batch_stats}, ts.model)
    got = _params(ts.model)
    for k, v in got.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    init = split_run["init"]
    moved = max(((got[k] - init[k]).abs() / (ATOL + RTOL * init[k].abs()))
                .max().item() for k in got)
    assert moved > 100, moved


def test_build_stage2_aims_the_render():
    """build_stage2 aims the heads before the teacher and Ranger's slow
    weights copy them: every ROI's first render shows the mesh, the
    teacher's pseudo mask covers the ROI, and teacher, slow weights and
    student start equal; its LPIPS is frozen, on the same device."""
    cfg = tc.stage2_pose_tiny()
    model, state, batch, lpips = tse.build_stage2(cfg, 2, "cpu", seed=1)
    assert not lpips.training and not any(
        p.requires_grad for p in lpips.parameters())
    assert next(lpips.parameters()).device == batch["roi_img"].device
    with torch.no_grad():
        out = model(*tge.model_inputs(batch))
        ren = tse.render_student_pose(cfg, batch, out["rot"], out["trans"])
        tout = state.teacher(*tge.model_inputs(batch))
    assert (ren["mask"].flatten(1).sum(1) > 0).all()
    assert (tout["mask_logits"][..., 0] > 0).all()
    for (name, p), t in zip(model.named_parameters(),
                            state.teacher.parameters()):
        assert torch.equal(p, t), name
        assert torch.equal(p, state.opt.state[p]["slow"]), name
