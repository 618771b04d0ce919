"""The whole GDR-Net in every architecture the JAX GDRN builds, in the
port against the JAX package, in float32 on the CPU at test size (micro
widths, 64² input, 16² output, batch 2):
  * each configuration of tests/test_gdrn_model.py's variant tests plus
    the three variants chip_smoke.py runs at full width (V1
    darknet53_topdown, V2 pvnet_conv_point, V3 resnet34_fpn) at these
    widths: forward within 1e-4, and the weight conversion Flax -> torch ->
    Flax bit for bit (and leftover or missing leaves refused);
  * two stage-I train steps (adam, weight decay, batch norm in train mode)
    on the PVNet and FPN variants, DropBlock in the FPN variant's PnP head
    fed JAX's draws: losses within 1e-4, parameters as
    tests/test_torch_gdrn_train.py holds its adam run (on their updates),
    BN statistics within 1e-4;
  * no DropBlock generator without DropBlock.
"""

import dataclasses

import numpy as np
import jax
import pytest
import torch

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu.engine.optim import build_optimizer
from self6dpp_tpu.engine.train_state import create_train_state
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch import convert as C
from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.engine.deepim_engine import to_device
from self6dpp_tpu_torch.models import layers as tlayers

from test_torch_gdrn import perturbed
from test_torch_gdrn_train import ADAM_MAX, ADAM_P99, jax_tree, update_gap
from test_torch_gdrn_variants import close, one_thread  # noqa: F401

TOL_GDRN = 1e-4
RTOL, ATOL = 1e-4, 1e-6


# ---- the whole GDRN -------------------------------------------------------

def tiny_model(m):
    """tests/test_gdrn_model.py::tiny_cfg's model in package m."""
    return m.PoseNetConfig(
        num_classes=3, input_res=64, output_res=16,
        backbone=m.BackboneConfig(name="resnet18"),
        geo_head=m.GeoHeadConfig(feat_dim=32, num_gn_groups=8, num_regions=8,
                                 xyz_bin=1),
        pnp_net=m.PnPNetConfig(featdim=32, num_gn_groups=8),
        loss=m.LossConfig(pm_loss_sym=True, pm_r_only=False,
                          pm_disentangle_z=True))


def variant(m, name):
    """The variant `name` of tiny_model in package m: the configurations of
    tests/test_gdrn_model.py's variant tests, and chip_smoke.py's V1-V3 at
    its widths."""
    t = tiny_model(m)
    r = dataclasses.replace
    gh, pn = t.geo_head, t.pnp_net
    return {
        "darknet53": r(t, backbone=r(t.backbone, name="darknet53")),
        "simple_point": r(t, pnp_net=r(pn, name="SimplePointPnPNet")),
        "extent_feat": r(t, pnp_net=r(pn, with_extent_feat=True)),
        "pvnet_conv_head": r(
            t, backbone=m.BackboneConfig(name="pvnet_micro_8s"),
            geo_head=r(gh, name="ConvMaskXyzRegionHead", num_feat_layers=1)),
        "fpn_neck_head": r(
            t, backbone=m.BackboneConfig(name="micro", out_indices=(1, 2, 3, 4)),
            neck="fpn", neck_out_channels=32,
            geo_head=r(gh, name="FPNMaskXyzRegionHead")),
        "conv_head_on_fpn": r(
            t, backbone=m.BackboneConfig(name="micro", out_indices=(1, 2, 3, 4)),
            neck="fpn", neck_out_channels=32,
            geo_head=r(gh, name="ConvMaskXyzRegionHead", num_feat_layers=1)),
        "V1_darknet53_topdown": r(
            t, backbone=r(t.backbone, name="darknet53"),
            geo_head=r(gh, deconv_kernel_size=4, out_layer_shared=False),
            pnp_net=r(pn, mask_attention="concat", with_extent_feat=True,
                      drop_prob=0.2, trans_type="centroid_z_abs")),
        "V2_pvnet_conv_point": r(
            t, backbone=m.BackboneConfig(name="pvnet_micro_8s"),
            geo_head=r(gh, name="ConvMaskXyzRegionHead", num_feat_layers=2),
            pnp_net=r(pn, name="SimplePointPnPNet", mask_attention="mul",
                      trans_type="trans")),
        "V3_resnet34_fpn": r(
            t, backbone=m.BackboneConfig(name="micro", out_indices=(1, 2, 3, 4)),
            neck="fpn", neck_out_channels=32,
            geo_head=r(gh, name="FPNMaskXyzRegionHead")),
    }[name]


VARIANTS = ["darknet53", "simple_point", "extent_feat", "pvnet_conv_head",
            "fpn_neck_head", "conv_head_on_fpn", "V1_darknet53_topdown",
            "V2_pvnet_conv_point", "V3_resnet34_fpn"]


def configs(name, **solver):
    out = []
    for m in (jc, tc):
        out.append(m.Config(model=variant(m, name),
                            solver=m.SolverConfig(**solver),
                            dist=m.DistConfig(compute_dtype="float32")))
    return out


@pytest.mark.parametrize("name", VARIANTS)
def test_gdrn_variant_forward_matches_jax(name):
    jcfg, tcfg = configs(name)
    model = tge.build_gdrn(tcfg, device="cpu", seed=0)
    variables = perturbed(C.gdrn_state_dict_to_flax(model))
    back = C.gdrn_state_dict_to_flax(model, C.gdrn_flax_to_state_dict(
        variables, model))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(variables)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_array_equal(a, b, err_msg=str(path))
    model.load_state_dict(C.gdrn_flax_to_state_dict(variables, model))
    batch = make_gdrn_batch(tcfg, 2, seed=1)
    jm = jge.build_gdrn(jcfg)
    jout = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *jge.model_inputs(jax_tree(batch)))
    with torch.no_grad():
        out = model(*tge.model_inputs(
            {k: torch.from_numpy(v) for k, v in batch.items()}))
    for k in ("rot", "trans", "coor", "mask_logits", "region_logits",
              "pred_t_net"):
        close(out[k].numpy(), jout[k], TOL_GDRN, k)


def test_convert_rejects_leftovers_of_variants():
    _, tcfg = configs("V1_darknet53_topdown")
    model = tge.build_gdrn(tcfg, device="cpu", seed=0)
    v = C.gdrn_state_dict_to_flax(model)
    extra = {"params": dict(v["params"], neck={"lateral0": {"bias": 0}}),
             "batch_stats": v["batch_stats"]}
    with pytest.raises(KeyError, match="left unused"):
        C.gdrn_flax_to_state_dict(extra, model)
    pn = dict(v["params"]["pnp_net"])
    del pn["fc_extent2"]
    with pytest.raises(KeyError, match="lack"):
        C.gdrn_flax_to_state_dict(
            {"params": dict(v["params"], pnp_net=pn),
             "batch_stats": v["batch_stats"]}, model)


def test_port_refuses_unknown_heads():
    _, tcfg = configs("darknet53")
    bad = dataclasses.replace(tcfg.model, pnp_net=dataclasses.replace(
        tcfg.model.pnp_net, name="NoSuchPnPNet"))
    with pytest.raises(KeyError):
        tge.build_gdrn(dataclasses.replace(tcfg, model=bad), device="cpu")
    bad = dataclasses.replace(tcfg.model, neck="bifpn")
    with pytest.raises(ValueError, match="neck"):
        tge.build_gdrn(dataclasses.replace(tcfg, model=bad), device="cpu")


# ---- stage-I train steps ---------------------------------------------------

SOLVER = dict(optimizer="adam", base_lr=1e-4, total_iters=10, warmup_iters=0,
              ims_per_batch=2, reference_bs=2, weight_decay=1e-2,
              ema_warmup_iters=1)
TRAIN_VARIANTS = {
    "V2_pvnet_conv_point": {},
    # DropBlock on: the JAX step's draws fed to the port
    "V3_resnet34_fpn": dict(drop_prob=0.2),
}


@pytest.fixture(scope="module", params=sorted(TRAIN_VARIANTS))
def train_runs(request):
    name = request.param
    jcfg, tcfg = configs(name, **SOLVER)
    pn_kw = TRAIN_VARIANTS[name]
    if pn_kw:
        jcfg, tcfg = [dataclasses.replace(c, model=dataclasses.replace(
            c.model, pnp_net=dataclasses.replace(c.model.pnp_net, **pn_kw)))
            for c in (jcfg, tcfg)]
    model = tge.build_gdrn(tcfg, device="cpu", seed=0)
    variables = C.gdrn_state_dict_to_flax(model)
    nps = [make_gdrn_batch(tcfg, 2, seed=s) for s in (0, 1)]

    draws = []
    bern = jax.random.bernoulli

    def record(key, p, shape):
        out = bern(key, p, shape)
        jax.debug.callback(lambda a: draws.append(np.asarray(a)), out)
        return out
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.random, "bernoulli", record)
    try:
        jm = jge.build_gdrn(jcfg)
        tx, _ = build_optimizer(jcfg.solver, flatten=True)
        js = create_train_state(jax_tree(variables["params"]),
                                jax_tree(variables["batch_stats"]), tx)
        step = jge.jit_train_step(jcfg, jm)
        jmetrics = []
        for i in range(2):
            js, m = step(js, jax_tree(nps[i]), jax.random.PRNGKey(i))
            jmetrics.append({k: float(v) for k, v in m.items()})
            jax.block_until_ready(js.params)
    finally:
        mp.undo()
    assert len(draws) == (2 if pn_kw else 0)

    fed = list(draws)
    mp = pytest.MonkeyPatch()
    mp.setattr(tlayers, "dropblock_seed",
               lambda *a: torch.from_numpy(fed.pop(0).astype(np.float32)))
    try:
        model.load_state_dict(C.gdrn_flax_to_state_dict(variables, model))
        state = tge.init_state(tcfg, model)
        tstep = tge.make_train_step(tcfg, model)
        tmetrics = []
        for i in range(2):
            state, m = tstep(state, to_device(nps[i], "cpu"))
            tmetrics.append({k: float(v) for k, v in m.items()})
    finally:
        mp.undo()
    assert not fed
    return dict(cfg=tcfg, variables=variables, jstate=js, jm=jmetrics,
                tstate=state, tm=tmetrics, draws=draws)


def test_variant_train_losses_match_jax(train_runs):
    for jm, tm in zip(train_runs["jm"], train_runs["tm"]):
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL, err_msg=k)
    for d in train_runs["draws"]:
        assert 0 < d.sum() < d.size


def test_variant_train_params_match_jax(train_runs):
    j, ts = train_runs["jstate"], train_runs["tstate"]
    ref = C.gdrn_flax_to_state_dict(
        {"params": j.params, "batch_stats": j.batch_stats}, ts.model)
    init = C.gdrn_flax_to_state_dict(train_runs["variables"], ts.model)
    p99, top = update_gap(ts.model, ref, init, SOLVER["base_lr"])
    assert p99 <= ADAM_P99 and top <= ADAM_MAX, (p99, top)
    # adam moves a parameter by about base_lr a step: the gaps above are
    # small against the updates
    moved = max(((v.detach() - init[k]).abs().max().item()
                 for k, v in ts.model.named_parameters()))
    assert moved > 0.9 * SOLVER["base_lr"], moved
    stats = {k: v for k, v in ts.model.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert stats
    for k, v in stats.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
        assert not torch.equal(v, init[k]), k


def test_no_generator_without_dropblock():
    """drop_prob 0: no step makes a generator, so every earlier
    configuration draws as before."""
    _, tcfg = configs("V2_pvnet_conv_point")
    assert tge.dropout_generator(tcfg, 3, "cpu") is None
    on = dataclasses.replace(tcfg, model=dataclasses.replace(
        tcfg.model, pnp_net=dataclasses.replace(tcfg.model.pnp_net,
                                                drop_prob=0.1)))
    a, b = (tge.dropout_generator(on, 3, "cpu") for _ in range(2))
    assert torch.equal(torch.rand(4, generator=a), torch.rand(4, generator=b))
    c = tge.dropout_generator(on, 4, "cpu")
    assert not torch.equal(torch.rand(4, generator=c),
                           torch.rand(4, generator=tge.dropout_generator(
                               on, 3, "cpu")))


