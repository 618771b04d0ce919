"""The port's solver against the JAX package's, in float32 on the CPU:
Ranger (nan_to_num, global-norm clip, RAdam, Lookahead) over 8 steps of
the same gradients, every other optimizer (radam, adam, adamw, adabelief,
sgd, sgd_gc, madgrad, adamp, sgdp), weight decay and MultiSteps
accumulation, the flat-and-anneal, warmup-multistep and constant
schedules, the EMA decay; gradient centralisation and the AdamP projection
alone, and on a DeepIM's weights laid out as the JAX package lays them.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.engine import optim as jopt
from self6dpp_tpu.engine import schedule as jsched
from self6dpp_tpu.engine import train_state as jts
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.engine import optim as topt
from self6dpp_tpu_torch.engine import schedule as tsched
from self6dpp_tpu_torch.engine import train_state as tts

# parameters are O(1): an element that the Lookahead interpolation brings
# near 0 keeps the absolute rounding of the O(1) terms it came from
RTOL, ATOL = 1e-5, 1e-6
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 3, 2)}


def gradients(steps, seed=0):
    """Per step, a gradient per leaf: a NaN on step 2 (nan_to_num), a global
    norm above 35 on step 3 (the clip), small ones elsewhere."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        scale = 30.0 if s == 2 else 0.5
        g = {k: (scale * rng.standard_normal(v)).astype(np.float32)
             for k, v in SHAPES.items()}
        if s == 1:
            g["a"][1, 2] = np.nan
        out.append(g)
    return out


SOLVER_CASES = {
    "adam": dict(optimizer="adam"),
    "radam": dict(optimizer="radam"),
    "adamw_wd": dict(optimizer="adamw", weight_decay=1e-2),
    "adabelief": dict(optimizer="adabelief"),
    "sgd": dict(optimizer="sgd"),
    "sgd_wd_accum2": dict(optimizer="sgd", weight_decay=1e-2,
                          ims_per_batch=2, reference_bs=4),
    "sgd_gc": dict(optimizer="sgd_gc"),
    "madgrad": dict(optimizer="madgrad"),
    "madgrad_wd": dict(optimizer="madgrad", weight_decay=1e-2),
    "adamp": dict(optimizer="adamp"),
    "sgdp": dict(optimizer="sgdp"),
    "adam_constant_lr": dict(optimizer="adam", lr_sched="constant"),
    "sgd_constant_lr_warmup": dict(optimizer="sgd", lr_sched="constant",
                                   warmup_iters=4),
    "adam_wd_accum2": dict(optimizer="adam", weight_decay=1e-2,
                           ims_per_batch=2, reference_bs=4),
    "ranger_wd_accum3_multistep": dict(
        optimizer="ranger", weight_decay=1e-2, ims_per_batch=2,
        reference_bs=6, lr_sched="warmup_multistep", warmup_iters=2,
        steps=(0.2, 0.4)),
}


def test_ranger_matches_jax_over_8_steps():
    """8 steps span RAdam's unrectified steps (rho < 5 for t < 6), its
    rectified ones, and the Lookahead sync at step 6."""
    solver_matches_jax_over_8_steps(dict(optimizer="ranger"))


@pytest.mark.parametrize("case", sorted(SOLVER_CASES))
def test_solver_matches_jax_over_8_steps(case):
    """adam, and with weight decay and accumulation 8 micro-batches (the
    parameters move at every k-th), the schedule's milestones inside."""
    solver_matches_jax_over_8_steps(SOLVER_CASES[case])


def solver_matches_jax_over_8_steps(kw):
    cfg = {**dict(warmup_iters=0, base_lr=1e-2, total_iters=10), **kw}
    tx, _ = jopt.build_optimizer(jc.SolverConfig(**cfg))
    rng = np.random.default_rng(1)
    p0 = {k: rng.standard_normal(v).astype(np.float32)
          for k, v in SHAPES.items()}
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = tx.init(jp)
    tparams = [torch.nn.Parameter(torch.from_numpy(p0[k].copy()))
               for k in sorted(SHAPES)]
    opt = topt.build_optimizer(tc.SolverConfig(**cfg), tparams)
    update = jax.jit(tx.update)
    norms = []
    for g in gradients(8):
        upd, jstate = update({k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for p, k in zip(tparams, sorted(SHAPES)):
            p.grad = torch.from_numpy(g[k])
        norms.append(np.sqrt(sum(float(np.nansum(v ** 2)) for v in g.values())))
        opt.step()
        for p, k in zip(tparams, sorted(SHAPES)):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {opt.count} {k}")
    assert max(norms) > 35 > min(norms)
    moved = max((p.detach().numpy() - p0[k]).__abs__().max()
                for p, k in zip(tparams, sorted(SHAPES)))
    assert moved > 100 * (ATOL + RTOL), moved
    accum = cfg.get("reference_bs", 24) // cfg.get("ims_per_batch", 24)
    assert opt.count == 8 // max(accum, 1)


def test_build_optimizer_names_what_is_not_ported():
    """Every optimizer of the JAX package builds (and matches JAX's,
    above), on every schedule name (a name other than flat_and_anneal and
    warmup_multistep gives base_lr throughout), with weight decay and
    accumulation; an unknown optimizer raises."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    for name in topt.CORES:
        for kw in (dict(), dict(lr_sched="warmup_multistep"),
                   dict(lr_sched="constant", base_lr=3e-3),
                   dict(weight_decay=1e-4, ims_per_batch=8, reference_bs=24)):
            cfg = tc.SolverConfig(optimizer=name, **kw)
            opt = topt.build_optimizer(cfg, p)
            assert opt.core == name
            assert opt.accum == (3 if "reference_bs" in kw else 1)
            if kw.get("lr_sched") == "constant":
                assert all(opt.lr_fn(k) == 3e-3 for k in (0, 1, 10**6))
    for name in ("lamb", "sgd_nesterov", ""):
        with pytest.raises(ValueError, match="unknown optimizer"):
            topt.build_optimizer(tc.SolverConfig(optimizer=name), p)


def _jax_leaf_op(transform, updates, params=None):
    out, _ = transform.update(updates, transform.init(params or updates),
                              params)
    return out


def test_centralize_and_projection_match_jax():
    """sgd_gc's centralisation and the AdamP projection on JAX-layout
    arrays: each leaf as JAX's transformations treat it, with updates
    orthogonal to the weight row by row (the channel view projects), to
    the whole weight only (the layer view projects), and at random (no
    projection)."""
    rng = np.random.default_rng(4)
    p = {k: rng.standard_normal(v).astype(np.float32)
         for k, v in dict(a=(4, 3), c=(2, 3, 2), d=(3, 3, 4, 5)).items()}
    u = {k: rng.standard_normal(v.shape).astype(np.float32)
         for k, v in p.items()}

    def ortho(x, w, rows):
        """x made orthogonal to w row by row, plus a radial part small
        enough that |cos| stays below the projection's threshold."""
        x2, w2 = x.reshape(rows, -1), w.reshape(rows, -1)
        n = w2 / np.linalg.norm(w2, axis=-1, keepdims=True)
        x2 = x2 - n * (n * x2).sum(-1, keepdims=True)
        radial = 0.3 * 0.1 / np.sqrt(x2.shape[1]) * np.linalg.norm(
            x2, axis=-1, keepdims=True)
        return (x2 + radial * n).astype(np.float32).reshape(x.shape)
    cases = {"random": u,
             "channel": {k: ortho(u[k], p[k], p[k].shape[0]) for k in p},
             "layer": {k: ortho(u[k], p[k], 1) for k in p}}
    # a layer-orthogonal update of a weight whose rows it does not leave
    # orthogonal: only the layer view projects it
    for k in p:
        x = cases["layer"][k].reshape(p[k].shape[0], -1)
        assert np.abs((x * p[k].reshape(x.shape)).sum(-1)).max() > 1e-2
    gc = jopt._gradient_centralization()
    proj = jopt._adamp_projection()
    for name, upd in cases.items():
        want_gc = _jax_leaf_op(gc, {k: jnp.asarray(v) for k, v in upd.items()})
        want_p = _jax_leaf_op(proj, {k: jnp.asarray(v) for k, v in upd.items()},
                              {k: jnp.asarray(v) for k, v in p.items()})
        for k in p:
            tu, tp = torch.from_numpy(upd[k]), torch.from_numpy(p[k])
            np.testing.assert_allclose(topt.centralize(tu).numpy(),
                                       np.asarray(want_gc[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"gc {name} {k}")
            got = topt.project(tp, tu).numpy()
            np.testing.assert_allclose(got, np.asarray(want_p[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=f"proj {name} {k}")
            if name != "random":
                assert np.abs(got - upd[k]).max() > 1e-3, (name, k)


@pytest.mark.parametrize("name", ["sgd_gc", "adamp", "sgdp"])
def test_layout_optimizers_on_deepim_match_jax(name):
    """sgd_gc, adamp and sgdp over 3 steps on a micro DeepIM's weights
    (convs, transposed convs, dense layers, biases) with the kinds of
    convert.param_kinds, against JAX's on the same weights in its layout
    (convert's own layout maps). The first gradient of the first conv is
    nearly orthogonal to its weight row by row in the JAX layout, so sgdp's
    first update there is projected in the channel view."""
    from self6dpp_tpu_torch.convert import (_from_torch_layout,
                                            _to_torch_layout, param_kinds)
    from self6dpp_tpu_torch.models.deepim import DeepIM
    cfg = dict(lr_sched="constant", base_lr=1e-2, optimizer=name)
    model = DeepIM(tc.DeepIMConfig(input_h=64, input_w=64, pose_feat_dim=8),
                   widths=(4, 6, 8, 8, 8, 12))
    model.reset_parameters(torch.Generator().manual_seed(0))
    kinds = param_kinds(model)
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.default_rng(5)
    jax_of = lambda n, a: np.ascontiguousarray(
        _from_torch_layout(a, kinds[n], model.feat_hwc))
    torch_of = lambda n, a: np.ascontiguousarray(
        _to_torch_layout(np.asarray(a), kinds[n], model.feat_hwc))
    p0 = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    grads = [{n: (0.5 * rng.standard_normal(p0[n].shape)).astype(np.float32)
              for n in names} for _ in range(3)]
    first = "backbone.conv1.0.weight"
    w = jax_of(first, p0[first])
    g2 = jax_of(first, grads[0][first]).reshape(w.shape[0], -1)
    nrm = w.reshape(w.shape[0], -1)
    nrm = nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)
    g2 = g2 - nrm * (nrm * g2).sum(-1, keepdims=True)
    # a radial part in the first row alone, which the channel view's
    # projection removes from that row (|cos| stays under its cutoff); a
    # projection in another layout would spread it over the weight
    g2[0] += 0.9 * 0.1 / np.sqrt(g2.shape[1]) * np.linalg.norm(g2[0]) * nrm[0]
    grads[0][first] = torch_of(first, g2.astype(np.float32).reshape(w.shape))

    tx, _ = jopt.build_optimizer(jc.SolverConfig(**cfg))
    jp = {n: jnp.asarray(jax_of(n, p0[n])) for n in names}
    jstate = tx.init(jp)
    opt = topt.build_optimizer(tc.SolverConfig(**cfg), model.parameters(),
                               kinds=list(kinds.values()))
    update = jax.jit(tx.update)
    for step, g in enumerate(grads):
        upd, jstate = update({n: jnp.asarray(jax_of(n, g[n]))
                                 for n in names}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(g[n])
        opt.step()
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), torch_of(n, jp[n]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {step} {n}")
    moved = max(np.abs(p.detach().numpy() - p0[n]).max()
                for n, p in model.named_parameters())
    assert moved > 100 * (ATOL + RTOL), moved


@pytest.mark.parametrize("kw", [dict(), dict(warmup_iters=10, steps=(0.3,)),
                                dict(step_gamma=0.5, warmup_factor=0.1)])
def test_warmup_multistep_matches_jax(kw):
    jf = jsched.warmup_multistep(jc.SolverConfig(**kw))
    tf = tsched.warmup_multistep(tc.SolverConfig(**kw))
    for step in (0, 1, 9, 10, 500, 999, 1000, 29_999, 30_000, 50_000,
                 74_999, 75_000, 99_999, 120_000):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                   rtol=1e-6, atol=0, err_msg=str(step))


@pytest.mark.parametrize("kw", [
    dict(),                                         # the flagship's
    dict(warmup_method="constant", anneal_method="linear"),
    dict(anneal_method="step", warmup_iters=10),
    dict(anneal_method="poly", poly_power=0.9, warmup_method="none")])
def test_flat_and_anneal_matches_jax(kw):
    jf = jsched.flat_and_anneal(jc.SolverConfig(**kw))
    tf = tsched.flat_and_anneal(tc.SolverConfig(**kw))
    for step in (0, 1, 9, 10, 500, 999, 1000, 50_000, 72_000, 72_001, 80_000,
                 99_999, 100_000, 120_000):
        np.testing.assert_allclose(float(tf(step)), float(jf(step)),
                                   rtol=1e-6, atol=0, err_msg=str(step))


def test_ema_decay_and_update_match_jax():
    jd = jts.ema_decay_schedule(0.999, 2000)
    td = tts.ema_decay_schedule(0.999, 2000)
    for step in (1, 2, 3, 100, 2000, 10_000):
        np.testing.assert_allclose(float(td(step)), float(jd(jnp.int32(step))),
                                   rtol=1e-6, atol=0, err_msg=str(step))
    # step 1: d = 0.999 (1 - e^(-1/2000)), about 5e-4
    assert abs(float(td(1)) - 0.999 * -np.expm1(-1 / 2000)) < 6e-8

    rng = np.random.default_rng(2)
    student = torch.nn.Linear(3, 2)
    teacher = torch.nn.Linear(3, 2)
    for m in (student, teacher):
        for p in m.parameters():
            p.data = torch.from_numpy(rng.standard_normal(p.shape).astype(
                np.float32))
    state = tts.TrainState(step=5, model=student, teacher=teacher, opt=None)
    ref = {k: v.detach().numpy().copy() for k, v in teacher.named_parameters()}
    src = {k: v.detach().numpy() for k, v in student.named_parameters()}
    jstate = jts.TrainState(step=jnp.int32(5), params=src, batch_stats={},
                            opt_state=None, ema_params=ref, tx=optax.identity())
    want = jstate.update_ema(jd).ema_params
    state.update_ema(td)
    for k, v in teacher.named_parameters():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_create_train_state_teacher_is_a_frozen_copy():
    """The teacher starts as a copy of the student that takes no gradient;
    without a teacher the EMA update does nothing."""
    student = torch.nn.Linear(3, 2)
    state = tts.create_train_state(student, opt=None)
    for (k, s), (_, t) in zip(student.named_parameters(),
                              state.teacher.named_parameters()):
        assert torch.equal(s, t) and s is not t and not t.requires_grad, k
    assert state.step == 0
    bare = tts.create_train_state(student, opt=None, with_ema=False)
    bare.update_ema(tts.ema_decay_schedule(0.999, 2000))
    assert bare.teacher is None


def test_flagship_config_matches_bench_stage2():
    """stage2_pose_flagship() is bench.py's build_stage2(8, dense=False)
    configuration, its whole loss suite included."""
    from __graft_entry__ import _flagship_cfg
    j = _flagship_cfg()
    t = tc.stage2_pose_flagship()
    def within(port, ref, path):
        # every field the port has, with the JAX package's value
        for k, v in port.items():
            assert k in ref, f"{path}.{k}"
            if isinstance(v, dict):
                within(v, ref[k], f"{path}.{k}")
            else:
                assert v == ref[k], (f"{path}.{k}", v, ref[k])

    for name in ("model", "solver"):
        within(dataclasses.asdict(getattr(t, name)),
               dataclasses.asdict(getattr(j, name)), name)
    js = jc.SelfSupConfig(enabled=True, mask_lw=1.0, ms_ssim_lw=1.0, lab_lw=0.2,
                          depth_chamfer_lw=1.0, perceptual_lw=0.15,
                          pseudo_pm_lw=10.0, pseudo_trans_lw=1.0)
    within(dataclasses.asdict(t.self_sup), dataclasses.asdict(js), "self_sup")
    assert (t.renderer.tile_px, t.renderer.faces_per_tile) == (32, 128)
    assert j.dist.compute_dtype == t.dist.compute_dtype == "bfloat16"
