"""The port's solver against the JAX package's, in float32 on the CPU:
Ranger (nan_to_num, global-norm clip, RAdam, Lookahead) over 8 steps of
the same gradients, adam, weight decay and MultiSteps accumulation, the
flat-and-anneal and warmup-multistep schedules and the EMA decay.
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
    """adam, warmup_multistep, weight decay and accumulation, once of a
    later slice, now build (and match JAX's, above); the other optimizers
    and an unknown schedule raise."""
    p = [torch.nn.Parameter(torch.zeros(2))]
    for kw in (dict(optimizer="adam"), dict(lr_sched="warmup_multistep"),
               dict(weight_decay=1e-4), dict(ims_per_batch=8, reference_bs=24)):
        opt = topt.build_optimizer(tc.SolverConfig(**kw), p)
        assert opt.core == tc.SolverConfig(**kw).optimizer
        assert opt.accum == (3 if "reference_bs" in kw else 1)
    for kw in (dict(optimizer="sgd"), dict(optimizer="radam"),
               dict(optimizer="adamw"), dict(lr_sched="constant")):
        with pytest.raises(ValueError):
            topt.build_optimizer(tc.SolverConfig(**kw), p)


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
