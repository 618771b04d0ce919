"""The port's stage-I GDR-Net train and eval steps against the JAX
package's, in float32 on the CPU, at test size (micro backbone, 64² ROI,
16² output, 2 classes) with the MaskNormVF heads (visib + full masks,
4-point vector fields, normals, ConvPnPNetMaskNormVF) and their supervised
vf/norm terms: two updates of jit_train_step with batch norm in train mode
(Flax's statistics and running update) against two of the port's, once
with Ranger (two steps) and once with adam, weight decay, accumulation to
twice the batch and the MTL weighting (four micro-batch steps); losses, parameters, EMA teacher and BN
running statistics within 1e-4. The two micro-batches differ (seeds 0 and
1), so accumulation has a mean to take; the EMA ramps over 1 step (decay
0.63, then 0.86), so a wrong decay argument shows. Also: the GDRN forward
with the MaskNormVF heads, Flax's batch norm alone, the eval step with
the EMA teacher (which reads the student's running statistics), the
state_dict -> variables converter and the stage-I configurations.
"""

import dataclasses
import importlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine.optim import build_optimizer
from self6dpp_tpu.engine.train_state import create_train_state
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import (gdrn_flax_to_state_dict,
                                        gdrn_state_dict_to_flax)
from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine.deepim_engine import to_device
from self6dpp_tpu_torch.losses.gdrn_loss import MTL_TERMS
from self6dpp_tpu_torch.models.layers import FlaxBatchNorm2d

RTOL, ATOL = 1e-4, 1e-6
# (solver settings, micro-batch steps): two updates each, so the second
# runs at base_lr (the first at base_lr * warmup_factor, the schedule's
# step 0)
SOLVERS = {
    "ranger": (dict(optimizer="ranger"), 2),
    "ranger_wd_accum2_mtl": (dict(optimizer="ranger", weight_decay=1e-2,
                                  reference_bs=4), 4),
    "adam_wd_accum2": (dict(optimizer="adam", weight_decay=1e-2,
                            reference_bs=4), 4),
}
# adam divides each element's update by that element's own gradient scale,
# so the update carries the gradient's relative error; at this size the
# train-mode BN backbone's float32 gradients differ between the packages
# far beyond 1e-4 on elements much smaller than their layer's largest, and
# single parameters end a fraction of base_lr apart. The adam run is held
# on the parameter updates instead: their difference within ADAM_P99 x
# base_lr at the 99th percentile and ADAM_MAX x base_lr everywhere
# (test_adam_update_check_can_fail: without the weight decay or the
# accumulation the 99th percentile passes ADAM_P99).
ADAM_P99, ADAM_MAX = 1e-2, 0.5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the CPU build's oneDNN convolution backward has
    crashed with 4 or more threads on the GDRN backward."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_jax(obj):
    """The JAX package's dataclass with the port's field values (the
    JAX-only fields at their defaults)."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(jc, type(obj).__name__)
        return cls(**{f.name: to_jax(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    return obj


def stage1_cfg(solver: str) -> tc.Config:
    t = tc.masknormvf_tiny()
    kw = SOLVERS[solver][0]
    return dataclasses.replace(
        t, model=dataclasses.replace(t.model, use_mtl="mtl" in solver),
        solver=dataclasses.replace(t.solver, ema_warmup_iters=1, **kw))


def batches(cfg):
    return [make_gdrn_batch(cfg, 2, seed=s) for s in (0, 1)]


def jax_tree(x):
    return jax.tree_util.tree_map(jnp.asarray, x)


def jax_stage1(cfg, variables, nps, steps):
    jcfg = to_jax(cfg)
    jmodel = jge.build_gdrn(jcfg)
    tx, _ = build_optimizer(jcfg.solver, flatten=True)
    state = create_train_state(jax_tree(variables["params"]),
                               jax_tree(variables["batch_stats"]), tx)
    step = jge.jit_train_step(jcfg, jmodel)
    metrics = []
    for i in range(steps):
        state, m = step(state, jax_tree(nps[i % 2]), jax.random.PRNGKey(0))
        metrics.append({k: float(v) for k, v in m.items()})
    ev = jax.jit(jge.make_eval_step(jcfg, jmodel, use_ema=True))(
        state, jax_tree(nps[0]))
    return state, metrics, {k: np.asarray(v) for k, v in ev.items()}


def port_stage1(cfg, variables, nps, steps):
    model = tge.build_gdrn(cfg, device="cpu")
    model.load_state_dict(gdrn_flax_to_state_dict(variables, model))
    state = tge.init_state(cfg, model)
    step = tge.make_train_step(cfg, model)
    tbs = [to_device(b, "cpu") for b in nps]
    metrics = []
    for i in range(steps):
        state, m = step(state, tbs[i % 2])
        metrics.append({k: float(v) for k, v in m.items()})
    ev = tge.make_eval_step(cfg, model, use_ema=True)(state, tbs[0])
    return state, metrics, {k: v.numpy() for k, v in ev.items()}


@pytest.fixture(scope="module", params=sorted(SOLVERS))
def runs(request):
    cfg = stage1_cfg(request.param)
    model = tge.build_gdrn(cfg, device="cpu", seed=0)
    variables = gdrn_state_dict_to_flax(model)
    nps = batches(cfg)
    steps = SOLVERS[request.param][1]
    jstate, jm, jev = jax_stage1(cfg, variables, nps, steps)
    tstate, tm, tev = port_stage1(cfg, variables, nps, steps)
    return dict(name=request.param, cfg=cfg, variables=variables,
                jstate=jstate, jm=jm, jev=jev, tstate=tstate, tm=tm, tev=tev)


def test_stage1_losses_match_jax(runs):
    for jm, tm in zip(runs["jm"], runs["tm"]):
        assert set(jm) == set(tm)
        assert {"loss_vf_vis", "loss_vf_full", "loss_norm",
                "loss_mask_full"} <= set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    assert runs["tm"][0]["total_loss"] != runs["tm"][1]["total_loss"]


@pytest.mark.parametrize("which", ["params", "ema_params"])
def test_stage1_params_match_jax(runs, which):
    j, ts = runs["jstate"], runs["tstate"]
    ref = gdrn_flax_to_state_dict(
        {"params": getattr(j, which), "batch_stats": j.batch_stats}, ts.model)
    net = ts.model if which == "params" else ts.teacher
    init = gdrn_flax_to_state_dict(runs["variables"], ts.model)
    lr = runs["cfg"].solver.base_lr
    moved = 0.0
    for k, v in net.named_parameters():
        v = v.detach()
        if runs["cfg"].solver.optimizer != "adam":
            np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        moved = max(moved, ((v - init[k]).abs()
                            / (ATOL + RTOL * init[k].abs())).max().item())
    # past 10x the tolerance (the adam run's teacher moves least)
    assert moved > 10, moved
    if runs["cfg"].solver.optimizer == "adam":
        p99, top = update_gap(net, ref, init, lr)
        assert p99 <= ADAM_P99 and top <= ADAM_MAX, (p99, top)


def update_gap(net, ref, init, lr):
    """(99th percentile, largest) of |(p - p0) - (p_ref - p0)| / lr."""
    d = torch.cat([((v.detach() - init[k]) - (ref[k] - init[k])).abs()
                   .flatten() for k, v in net.named_parameters()]) / lr
    return d.quantile(0.99).item(), d.max().item()


@pytest.mark.parametrize("change", [dict(weight_decay=0.0),
                                    dict(reference_bs=2)])
@pytest.mark.parametrize("runs", ["adam_wd_accum2"], indirect=True)
def test_adam_update_check_can_fail(runs, change):
    """The adam run's check sees a solver that leaves out the weight decay
    or the accumulation: its 99th percentile passes ADAM_P99."""
    cfg = dataclasses.replace(runs["cfg"], solver=dataclasses.replace(
        runs["cfg"].solver, **change))
    steps = SOLVERS["adam_wd_accum2"][1] // (2 if "reference_bs" in change
                                             else 1)
    ts, _, _ = port_stage1(cfg, runs["variables"], batches(cfg), steps)
    j = runs["jstate"]
    ref = gdrn_flax_to_state_dict({"params": j.params,
                                   "batch_stats": j.batch_stats}, ts.model)
    init = gdrn_flax_to_state_dict(runs["variables"], ts.model)
    p99, _ = update_gap(ts.model, ref, init, cfg.solver.base_lr)
    assert p99 > ADAM_P99, p99
    if "mtl" in runs["name"]:
        assert set(dict(ts.model.mtl.named_parameters())) == set(MTL_TERMS)
        assert ts.model.mtl["z"].abs().item() > 0.1 * lr


def test_stage1_batch_stats_match_jax(runs):
    """The running statistics after two train-mode steps: Flax's update
    (momentum 0.9, biased variance) on both sides; the teacher reads the
    very same tensors."""
    j, ts = runs["jstate"], runs["tstate"]
    ref = gdrn_flax_to_state_dict({"params": j.params,
                                   "batch_stats": j.batch_stats}, ts.model)
    sd, tsd = ts.model.state_dict(), ts.teacher.state_dict()
    keys = [k for k in sd if k.endswith(("running_mean", "running_var"))]
    assert keys
    moved = 0.0
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), ref[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert tsd[k].data_ptr() == sd[k].data_ptr(), k
        start = 0.0 if k.endswith("mean") else 1.0
        moved = max(moved, (sd[k] - start).abs().max().item())
    assert moved > 1e-2, moved


@pytest.mark.parametrize("runs", ["ranger", "ranger_wd_accum2_mtl"],
                         indirect=True)
def test_eval_with_ema_teacher_matches_jax(runs):
    """make_eval_step(use_ema=True): the teacher's weights on the student's
    running statistics, as the JAX eval step runs ema_params with the
    state's batch_stats. A teacher with its own (initial) statistics, as
    the parent TrainState kept, gives another pose."""
    for k in ("rot", "trans"):
        np.testing.assert_allclose(runs["tev"][k], runs["jev"][k], rtol=0,
                                   atol=1e-4, err_msg=k)


def test_teacher_shares_the_student_batch_norm_buffers():
    """create_train_state's teacher reads the student's BN buffers: a
    train-mode forward of the student moves the teacher's statistics too,
    and the teacher stays in eval mode."""
    cfg = stage1_cfg("ranger")
    model = tge.build_gdrn(cfg, device="cpu", seed=0)
    state = tge.init_state(cfg, model)
    b = to_device(batches(cfg)[0], "cpu")
    model.train()
    with torch.no_grad():
        model(*tge.model_inputs(b))
    bn_s, bn_t = model.backbone.bn1, state.teacher.backbone.bn1
    assert not state.teacher.training
    assert bn_s.running_var.sub(1).abs().max() > 1e-3
    for key in ("running_mean", "running_var", "num_batches_tracked"):
        assert torch.equal(getattr(bn_t, key), getattr(bn_s, key)), key


@pytest.mark.parametrize("n,hw,shift", [(2, 2, 0.0), (3, 5, 4.0)])
def test_flax_batch_norm_matches_flax(n, hw, shift):
    """Train mode: output, gradient and running statistics as
    flax.linen.BatchNorm(momentum=0.9); eval mode on the statistics."""
    rng = np.random.default_rng(n)
    c = 6
    x = (rng.standard_normal((n, hw, hw, c)) + shift).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.normal(0, 0.1, c).astype(np.float32)
    mean0 = rng.normal(0, 0.1, c).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, c).astype(np.float32)
    ct = rng.standard_normal(x.shape).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9)
    v = {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}}

    def f(v, x):
        y, upd = bn.apply(v, x, mutable=["batch_stats"])
        return (y * ct).sum(), (y, upd["batch_stats"])
    (_, (jy, jst)), jg = jax.jit(jax.value_and_grad(f, argnums=1,
                                                    has_aux=True))(v, x)
    t = FlaxBatchNorm2d(c, eps=1e-5)
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(scale))
        t.bias.copy_(torch.from_numpy(bias))
        t.running_mean.copy_(torch.from_numpy(mean0))
        t.running_var.copy_(torch.from_numpy(var0))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = t.train()(xt)
    (y * torch.from_numpy(ct).permute(0, 3, 1, 2)).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), **tol)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(jg), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(t.running_mean.numpy(), np.asarray(jst["mean"]),
                               **tol)
    np.testing.assert_allclose(t.running_var.numpy(), np.asarray(jst["var"]),
                               **tol)
    # eval mode normalises with the running statistics
    je = fnn.BatchNorm(use_running_average=True).apply(
        {"params": v["params"], "batch_stats": jst}, x)
    with torch.no_grad():
        te = t.eval()(xt)
    np.testing.assert_allclose(te.permute(0, 2, 3, 1).numpy(), np.asarray(je),
                               **tol)


def test_masknormvf_forward_matches_jax():
    """The GDRN forward with visib + full masks, vf and norm heads and
    ConvPnPNetMaskNormVF (the vf/norm maps in the PnP input), class-aware
    xyz (so vf and norm are gathered by class), on perturbed weights."""
    from test_torch_gdrn import perturbed
    cfg = tc.masknormvf_tiny()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, geo_head=dataclasses.replace(cfg.model.geo_head,
                                                xyz_class_aware=True)))
    model = tge.build_gdrn(cfg, device="cpu", seed=2)
    variables = perturbed(gdrn_state_dict_to_flax(model))
    nb = make_gdrn_batch(cfg, 4)
    assert len(set(nb["roi_cls"].tolist())) == 2
    jm = jge.build_gdrn(to_jax(cfg))
    jout = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *jge.model_inputs(jax_tree(nb)))
    model.load_state_dict(gdrn_flax_to_state_dict(variables, model))
    with torch.no_grad():
        out = model(*tge.model_inputs(to_device(nb, "cpu")))
    assert out["vf"].shape[-1] == 16 and out["norm"].shape[-1] == 3
    assert out["mask_logits"].shape[-1] == 2
    for k in ("rot", "trans", "coor", "mask_logits", "region_logits", "vf",
              "norm"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=1e-4, err_msg=k)


def test_state_dict_to_flax_inverts_the_converter():
    """gdrn_state_dict_to_flax gives the JAX model's variable tree (every
    leaf, its shape) and gdrn_flax_to_state_dict brings it back exactly."""
    from test_torch_gdrn import port_to_flax
    cfg = tc.masknormvf_tiny()
    model = tge.build_gdrn(cfg, device="cpu", seed=3)
    tree = gdrn_state_dict_to_flax(model)
    jm = jge.build_gdrn(to_jax(cfg))
    shapes = jax.eval_shape(
        lambda k, *a: jm.init(k, *a, train=False), jax.random.PRNGKey(0),
        *jge.model_inputs(jax_tree(make_gdrn_batch(cfg, 2))))
    ref = port_to_flax(model, shapes)
    jax.tree_util.tree_map(np.testing.assert_array_equal, tree, ref)
    back = gdrn_flax_to_state_dict(tree, model)
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


def _load_config_module(name):
    """configs/gdrn/<name>.py's get_config (the file imports its base as
    configs.gdrn.lm_base from the repository root)."""
    import os
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module(f"configs.gdrn.{name}").get_config()


def _within(port, ref, path):
    """Every field the port has, with the JAX package's value."""
    for k, v in port.items():
        assert k in ref, f"{path}.{k}"
        if isinstance(v, dict):
            _within(v, ref[k], f"{path}.{k}")
        else:
            assert v == ref[k], (f"{path}.{k}", v, ref[k])


@pytest.mark.parametrize("name", ["gdrn_flagship", "gdrn_lm_masknormvf",
                                  "stage2_masknormvf"])
def test_stage1_configs_match_the_jax_package(name):
    t = getattr(tc, name)()
    if name == "gdrn_flagship":
        from __graft_entry__ import _flagship_cfg
        j = _flagship_cfg()
        assert (t.model.backbone.name, t.model.geo_head.xyz_bin,
                t.solver.ims_per_batch) == ("resnest50d", 64, 24)
    elif name == "gdrn_lm_masknormvf":
        j = _load_config_module("lm_masknormvf")
        assert t.model.pnp_net.name == "ConvPnPNetMaskNormVF"
    else:
        f = tc.stage2_pose_flagship()
        assert t.model.loss == f.model.loss and t.solver == f.solver
        assert (t.self_sup.vf_lw, t.self_sup.norm_lw) == (1.0, 1.0)
        j = _load_config_module("lm_masknormvf")
        _within(dataclasses.asdict(t.model.geo_head),
                dataclasses.asdict(j.model.geo_head), "geo_head")
        _within(dataclasses.asdict(t.model.pnp_net),
                dataclasses.asdict(j.model.pnp_net), "pnp_net")
        return
    for part in ("model", "solver"):
        _within(dataclasses.asdict(getattr(t, part)),
                dataclasses.asdict(getattr(j, part)), part)
    assert j.dist.compute_dtype == t.dist.compute_dtype == "bfloat16"
