"""The port's DeepIM training pieces against the JAX package's, in float32
on the CPU: the flow label from two depth maps (ops/flow.py), the flow EPE
losses, FlowNetS with batch norm (eval, running statistics carried over)
and with every flow level, the DeepIM_Shared and DeepIM_Unshared variants
(forward and a 2-iteration refine), deepim_loss term by term, two Ranger
train steps at tests/test_deepim.py::tiny_cfg's sizes (64² zoom,
pose_feat_dim 32, 2 refine iterations; FlowNetS at the micro widths of
test_torch_deepim.py), the refusal of a model with batch norm by both
packages' train steps, and the refine-count ramp.

The JAX side renders on its XLA path (its default on the CPU), the port on
its plain fine stage. Weights go across with convert.py.
"""

import dataclasses
import functools

import numpy as np
import flax
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

import self6dpp_tpu.models.deepim as JDM
from self6dpp_tpu.config import base as jcfg
from self6dpp_tpu.engine import deepim_engine as jde
from self6dpp_tpu.engine.optim import build_optimizer as jbuild_optimizer
from self6dpp_tpu.engine.train_state import create_train_state
from self6dpp_tpu.losses import flow_loss as jfl
from self6dpp_tpu.models.backbones.flownet import FlowNetS as JFlowNetS
from self6dpp_tpu.ops import flow as jflow
from self6dpp_tpu_torch import config as tcfg
from self6dpp_tpu_torch.convert import (flax_to_state_dict,
                                        flownet_flax_to_state_dict)
from self6dpp_tpu_torch.data.meshes import make_cube, make_icosphere
from self6dpp_tpu_torch.engine import deepim_engine as tde
from self6dpp_tpu_torch.losses import flow_loss as tfl
from self6dpp_tpu_torch.models.backbones.flownet import FlowNetS
from self6dpp_tpu_torch.models.deepim import DeepIM, deepim_loss
from self6dpp_tpu_torch.ops import flow as tflow
from self6dpp_tpu_torch.ops.rasterizer import rasterize_batch
from test_torch_deepim import MICRO, identity_heads, nhwc, random_params

RTOL, ATOL = 1e-4, 1e-6


def micro_patch():
    """The JAX DeepIM's FlowNetS at the micro widths (nothing in the JAX
    package changes)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(JDM, "FlowNetS", functools.partial(JFlowNetS, widths=MICRO))
    return mp


def one_thread(fn):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(threads)


# ---- flow label ----------------------------------------------------------

def depth_pair(seed=0, b=2, hw=64):
    """Depth maps of an icosphere rendered at two nearby poses (the port's
    plain renderer), their intrinsics and poses."""
    rng = np.random.default_rng(seed)
    verts, faces = make_icosphere(0.08, 2)
    K = np.array([[[90.0, 0, 31.5], [0, 92.0, 32.2], [0, 0, 1]]] * b,
                 np.float32)
    R_src = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    t_src = np.stack([rng.uniform(-0.03, 0.03, b), rng.uniform(-0.03, 0.03, b),
                      rng.uniform(0.45, 0.55, b)], 1).astype(np.float32)
    dR = Rotation.from_euler("xyz", rng.normal(0, 4, (b, 3)), degrees=True)
    R_tgt = (dR.as_matrix() @ R_src).astype(np.float32)
    t_tgt = (t_src + rng.normal(0, [0.004, 0.004, 0.01], (b, 3))).astype(
        np.float32)

    def depth(R, t):
        out = rasterize_batch(verts, faces, verts, K, R, t, height=hw,
                              width=hw, with_prob=False, impl="plain",
                              device="cpu")
        return out.depth.numpy()
    return depth(R_src, t_src), depth(R_tgt, t_tgt), K, R_src, t_src, R_tgt, t_tgt


def test_flow_from_depth_matches_jax():
    """KT/Kinv, the flow where both sides are valid (1e-5 px) and the valid
    masks: equal, with no pixel within 1e-5 of the 3 mm test or of a
    rounding half (such a pixel could flip on either side's rounding)."""
    ds, dt, K, Rs, ts, Rt, tt = depth_pair()
    jKT, jKinv = jflow.relative_pose_KT(*map(jnp.asarray, (K, Rs, ts, Rt, tt)))
    tKT, tKinv = tflow.relative_pose_KT(*map(torch.from_numpy, (K, Rs, ts, Rt, tt)))
    np.testing.assert_allclose(tKT.numpy(), np.asarray(jKT), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tKinv.numpy(), np.asarray(jKinv), rtol=1e-6,
                               atol=1e-8)
    jf, jv = jflow.flow_from_depth(jnp.asarray(ds), jnp.asarray(dt), jKT, jKinv)
    tf, tv = tflow.flow_from_depth(torch.from_numpy(ds), torch.from_numpy(dt),
                                   torch.from_numpy(np.array(jKT)),
                                   torch.from_numpy(np.array(jKinv)))
    jf, jv, tf, tv = (np.asarray(jf), np.asarray(jv), tf.numpy(), tv.numpy())

    # the borderline pixels, from float64 recomputation of the landing point
    H, W = ds.shape[1:]
    KT, Kinv = np.asarray(jKT, np.float64), np.asarray(jKinv, np.float64)
    hs, ws = np.mgrid[0:H, 0:W].astype(np.float64)
    pix = np.stack([ws, hs, np.ones_like(ws)], -1)
    cam = np.einsum("bij,hwj->bhwi", Kinv, pix) * ds[..., None]
    proj = np.einsum("bij,bhwj->bhwi", KT[:, :, :3], cam) + KT[None, None, :, :, 3].transpose(2, 0, 1, 3)
    wp, hp, zp = proj[..., 0] / proj[..., 2], proj[..., 1] / proj[..., 2], proj[..., 2]
    half = lambda x: np.abs(np.abs(x - np.floor(x)) - 0.5) < 1e-5
    wi = np.clip(np.rint(wp), 0, W - 1).astype(int)
    hi = np.clip(np.rint(hp), 0, H - 1).astype(int)
    d_t = np.take_along_axis(dt.reshape(len(dt), -1), (hi * W + wi).reshape(
        len(dt), -1), 1).reshape(dt.shape)
    near = (np.abs(np.abs(zp - d_t) - 3e-3) < 1e-5) | half(wp) | half(hp)
    borderline = int((near & (ds > 1e-3)).sum())
    print(f"borderline pixels: {borderline}")
    assert borderline == 0
    np.testing.assert_array_equal(tv, jv)
    both = (tv > 0) & (jv > 0)
    assert both.sum() > 200, both.sum()           # the label is not empty
    assert (tv == 0).sum() > 200                   # nor everywhere valid
    np.testing.assert_allclose(tf[both], jf[both], rtol=0, atol=1e-5)
    assert (tf[~both] == 0).all() and (jf[~both] == 0).all()
    assert np.abs(jf[both]).max() > 0.5           # the poses differ


def test_flow_rounds_half_to_even():
    """A landing point at x.5 rounds to the even neighbour on both sides
    (jnp.round and torch.round): depth 1, identity K, a shift by 0.5 px
    right, the target's odd columns 10 cm deeper. Every column lands on an
    even one (rounding half away from zero would land half of them on odd
    columns), so all but the last (out of the image) are valid."""
    d = np.ones((1, 4, 8), np.float32)
    K = np.eye(3, dtype=np.float32)[None]
    KT = np.concatenate([K[0], [[0.5], [0.0], [0.0]]], 1)[None].astype(np.float32)
    tgt = np.ones((1, 4, 8), np.float32)
    tgt[..., 1::2] = 1.1                       # odd columns disagree in depth
    jf, jv = jflow.flow_from_depth(jnp.asarray(d), jnp.asarray(tgt),
                                   jnp.asarray(KT), jnp.asarray(K))
    tf, tv = tflow.flow_from_depth(*map(torch.from_numpy, (d, tgt, KT, K)))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    want = np.zeros((1, 4, 8), np.float32)
    want[..., :7] = 1.0
    np.testing.assert_array_equal(tv.numpy(), want)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=0)


# ---- flow losses ---------------------------------------------------------

def flow_inputs(seed=1):
    rng = np.random.default_rng(seed)
    gt = rng.normal(0, 2, (2, 64, 64, 2)).astype(np.float32)
    valid = (rng.uniform(size=(2, 64, 64)) > 0.4).astype(np.float32)
    preds = [rng.normal(0, 1, (2, 64 // f, 64 // f, 2)).astype(np.float32)
             for f in (4, 8, 16, 32, 64)]
    return preds, gt, valid


@pytest.mark.parametrize("which", ["one_scale", "multiscale"])
def test_epe_value_and_gradient_match_jax(which):
    preds, gt, valid = flow_inputs()
    if which == "one_scale":
        jfn = lambda p: jfl.one_scale_epe(p[2], jnp.asarray(gt),
                                          jnp.asarray(valid), div_flow=1.5)
        tfn = lambda p: tfl.one_scale_epe(p[2], torch.from_numpy(gt),
                                          torch.from_numpy(valid), div_flow=1.5)
    else:
        jfn = lambda p: jfl.multiscale_epe(p, jnp.asarray(gt),
                                           jnp.asarray(valid))
        tfn = lambda p: tfl.multiscale_epe(p, torch.from_numpy(gt),
                                           torch.from_numpy(valid))
    jv, jg = jax.value_and_grad(jfn)([jnp.asarray(p) for p in preds])
    tp = [torch.from_numpy(p).requires_grad_(True) for p in preds]
    tv = tfn(tp)
    tv.backward()
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-5)
    for i, (t, j) in enumerate(zip(tp, jg)):
        g = np.zeros(preds[i].shape, np.float32) if t.grad is None \
            else t.grad.numpy()
        np.testing.assert_allclose(g, np.asarray(j), rtol=1e-5, atol=1e-8,
                                   err_msg=str(i))
    assert np.abs(np.asarray(jg[2])).max() > 0


def test_epe_gradient_at_zero_error_differs_from_jax():
    """Where the prediction equals the pooled ground truth exactly the
    endpoint error's gradient is 0 in the port and NaN in the JAX package
    (jnp.linalg.norm's gradient at 0); elsewhere they agree. A kept
    difference (ROADMAP C)."""
    _, _, valid = flow_inputs()
    # integer flows: the pooled means (sums over 256, then / 16) are exact
    # on both sides
    gt = np.random.default_rng(3).integers(-4, 5, (2, 64, 64, 2)).astype(
        np.float32)
    gt4 = np.asarray(jfl._downscale(jnp.asarray(gt), 16)) / 16
    pred = gt4 + np.random.default_rng(2).normal(0, 1, gt4.shape).astype(np.float32)
    pred[0, 1, 2] = gt4[0, 1, 2]
    jg = np.asarray(jax.grad(lambda p: jfl.one_scale_epe(
        p, jnp.asarray(gt), jnp.asarray(valid)))(jnp.asarray(pred)))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tfl.one_scale_epe(tp, torch.from_numpy(gt), torch.from_numpy(valid)).backward()
    tg = tp.grad.numpy()
    assert np.isnan(jg[0, 1, 2]).all() and (tg[0, 1, 2] == 0).all()
    keep = np.ones(pred.shape[:3], bool)
    keep[0, 1, 2] = False
    np.testing.assert_allclose(tg[keep], jg[keep], rtol=1e-5, atol=1e-8)


# ---- FlowNetS with batch norm and every flow level ------------------------

def random_variables(variables, seed):
    """Unit-gain params (random_params) and seeded running statistics."""
    rng = np.random.default_rng(seed + 100)
    out = {"params": random_params(variables["params"], seed, 0.05)
           if "pose_head" in variables["params"] else
           _unit_gain(variables["params"], seed)}
    if "batch_stats" in variables:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: (rng.normal(0, 0.1, a.shape) if path[-1].key == "mean"
                             else rng.uniform(0.5, 1.5, a.shape)).astype(np.float32),
            variables["batch_stats"])
    return out


def _unit_gain(params, seed):
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.01, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        return rng.normal(0, np.prod(leaf.shape[:-1]) ** -0.5,
                          leaf.shape).astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, params)


@pytest.mark.parametrize("use_bn,level", [(True, "all"), (True, "flow4"),
                                          (False, "all")])
def test_flownet_bn_and_levels_match_jax(use_bn, level):
    x = np.random.default_rng(3).uniform(0, 1, (2, 64, 64, 6)).astype(np.float32)
    jnet = JFlowNetS(use_bn=use_bn, out_flow_level=level, widths=MICRO)
    v = jax.jit(jnet.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    v = random_variables(jax.tree_util.tree_map(np.asarray, dict(v)), 0)
    assert ("batch_stats" in v) == use_bn
    jo = jax.jit(lambda v, x: jnet.apply(v, x, train=False))(v, jnp.asarray(x))
    net = FlowNetS(use_bn=use_bn, out_flow_level=level, widths=MICRO).eval()
    net.load_state_dict(flownet_flax_to_state_dict(v, net), strict=True)
    with torch.no_grad():
        to = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(nhwc(to[0]), np.asarray(jo[0]), atol=1e-4)
    np.testing.assert_allclose(nhwc(to[1]), np.asarray(jo[1]), atol=1e-4)
    tf = to[2] if level == "all" else [to[2]]
    jf = jo[2] if level == "all" else [jo[2]]
    assert len(tf) == (5 if level == "all" else 1)
    for i, (a, b) in enumerate(zip(tf, jf)):
        assert a.shape[1:] == (2, *b.shape[1:3]), i
        np.testing.assert_allclose(nhwc(a), np.asarray(b), atol=1e-4,
                                   err_msg=f"flow {i}")


# ---- DeepIM_Shared / DeepIM_Unshared ---------------------------------------

def dicfg(**kw):
    return dict(num_classes=2, input_h=64, input_w=64, pose_feat_dim=32,
                n_iter_train=2, n_iter_test=2, **kw)


def configs(solver=None, **kw):
    dist = dict(compute_dtype="float32")
    solver = solver or {}
    j = jcfg.Config(deepim=jcfg.DeepIMConfig(**dicfg(**kw)),
                    solver=jcfg.SolverConfig(**solver),
                    dist=jcfg.DistConfig(**dist))
    t = tcfg.Config(deepim=tcfg.DeepIMConfig(**dicfg(**kw)),
                    solver=tcfg.SolverConfig(**solver),
                    dist=tcfg.DistConfig(**dist))
    return j, t


def make_batch(b=2, seed=0, in_ch=6):
    """tests/test_deepim.py's batch (cube, 64² frames, focal 64, GT poses,
    the init 3 cm off in x and 5 cm in z), the observation the cube
    rendered at the GT pose half mixed with noise, PM points, extents and
    symmetries."""
    rng = np.random.default_rng(seed)
    verts, faces = make_cube(size=0.3)
    colors = ((verts - verts.min(0)) / (verts.max(0) - verts.min(0))
              ).astype(np.float32)
    K = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], dtype=np.float32)
    gt_rot = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    gt_trans = np.stack([rng.uniform(-0.05, 0.05, b), rng.uniform(-0.05, 0.05, b),
                         rng.uniform(0.9, 1.1, b)], 1).astype(np.float32)
    obs = rasterize_batch(verts, faces, colors, np.broadcast_to(K, (b, 3, 3)),
                          gt_rot, gt_trans, with_prob=False, impl="plain",
                          device="cpu")
    batch = {
        "obs_img": (0.5 * obs.attr.numpy() + 0.5 * rng.uniform(
            0, 1, (b, 64, 64, 3))).astype(np.float32),
        "obs_box": np.array([[8, 8, 56, 56]] * b, dtype=np.float32),
        "K": np.broadcast_to(K, (b, 3, 3)).copy(),
        "verts": verts, "faces": faces, "colors": colors,
        "roi_cls": np.array([0, 1], np.int32)[:b],
        "gt_rot": gt_rot, "gt_trans": gt_trans,
        "gt_points": np.repeat(verts[None], b, 0).astype(np.float32),
        "roi_extent": np.full((b, 3), 0.3, dtype=np.float32),
        "sym_rots": np.broadcast_to(np.eye(3, dtype=np.float32),
                                    (b, 4, 3, 3)).copy(),
        "sym_valid": np.eye(4, dtype=bool)[0][None].repeat(b, 0),
        "init_rot": gt_rot.copy(),
        "init_trans": gt_trans + np.array([0.03, 0.0, 0.05], np.float32),
    }
    if in_ch == 8:
        batch["obs_mask"] = obs.mask.numpy()
    return batch


def build_pair(seed=0, **kw):
    """The JAX DeepIM and its seeded variables, and the port's with them."""
    jc, tc = configs(**kw)
    jm = jde.build_deepim(jc)
    b = make_batch(in_ch=jc.deepim.in_channels)
    x = jnp.zeros((2, 64, 64, jc.deepim.in_channels))
    v = jax.jit(lambda k, *a: jm.init(k, *a, obj_class=jnp.asarray(
        b["roi_cls"])))(jax.random.PRNGKey(0), x, jnp.asarray(b["init_rot"]),
                        jnp.asarray(b["init_trans"]), jnp.asarray(b["K"]))
    v = random_variables(jax.tree_util.tree_map(np.asarray, dict(v)), seed)
    v["params"] = identity_heads(v["params"])
    tm = DeepIM(tc.deepim, widths=MICRO).eval()
    tm.load_state_dict(flax_to_state_dict(v, tm), strict=True)
    return jc, tc, jm, v, tm, b


VARIANTS = [("DeepIM_Shared", 6), ("DeepIM_Shared", 8),
            ("DeepIM_Unshared", 6), ("DeepIM_Unshared", 8)]


@pytest.mark.parametrize("name,in_ch", VARIANTS,
                         ids=[f"{n[7:]}-{c}" for n, c in VARIANTS])
def test_shared_unshared_forward_and_refine_match_jax(name, in_ch):
    """The ResNet (micro) variants with their running statistics: the
    forward on seeded inputs, and 2 render-and-compare iterations."""
    kw = dict(name=name, backbone="micro", in_channels=in_ch,
              with_flow=False, flow_lw=0.0)
    jc, tc, jm, v, tm, b = build_pair(**kw)
    assert "batch_stats" in v
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 64, in_ch)).astype(np.float32)
    K = np.array([[[300.0, 0, 32], [0, 310.0, 30], [0, 0, 1]]] * 2, np.float32)
    args = (x, b["init_rot"], b["init_trans"], K)
    jo = jm.apply(v, *map(jnp.asarray, args))
    with torch.no_grad():
        to = tm(*map(torch.from_numpy, args))
    assert "flow" not in to
    for k in ("rot", "trans", "mask_logits"):
        np.testing.assert_allclose(to[k].numpy(), np.asarray(jo[k]),
                                   atol=1e-4, err_msg=k)
    assert np.abs(np.asarray(jo["rot"]) - b["init_rot"]).max() > 1e-3

    jb = {k: jnp.asarray(a) for k, a in b.items()}
    jr, jt = jax.jit(lambda v, b: jde.make_refine_fn(jc, jm, 2)(
        v, b, b["init_rot"], b["init_trans"]))(v, jb)
    out = tde.make_eval_step(tc, tm, device="cpu")(b)
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(out["trans"].numpy(), np.asarray(jt), atol=1e-4)
    assert np.abs(np.asarray(jt) - b["init_trans"]).max() > 1e-3


def test_variant_errors():
    _, tc = configs(name="DeepIM_Shared", backbone="micro")
    with pytest.raises(ValueError, match="FlowNet-only"):
        DeepIM(tc.deepim)
    _, tc = configs(name="DeepIM_Unshared", backbone="micro", in_channels=7,
                    with_flow=False)
    with pytest.raises(ValueError, match="in half"):
        DeepIM(tc.deepim)
    _, tc = configs(name="DeepIM_Other")
    with pytest.raises(ValueError, match="unknown DeepIM variant"):
        DeepIM(tc.deepim)


# ---- deepim_loss -----------------------------------------------------------

def test_deepim_loss_terms_match_jax():
    """Every term on given outputs and labels (flow4 and a 5-level flow
    list), with the rotation term on."""
    rng = np.random.default_rng(6)
    b = make_batch()
    R = Rotation.from_euler("xyz", rng.normal(0, 10, (2, 3)), degrees=True)
    outs = {"rot": (R.as_matrix() @ b["gt_rot"]).astype(np.float32),
            "trans": (b["gt_trans"] + rng.normal(0, 0.02, (2, 3))).astype(np.float32),
            "mask_logits": rng.normal(0, 2, (2, 64, 64, 1)).astype(np.float32),
            "flow": rng.normal(0, 1, (2, 4, 4, 2)).astype(np.float32)}
    labels = {"gt_flow": rng.normal(0, 2, (2, 64, 64, 2)).astype(np.float32),
              "gt_flow_valid": (rng.uniform(size=(2, 64, 64)) > 0.5).astype(np.float32),
              "gt_mask_visib": (rng.uniform(size=(2, 64, 64)) > 0.5).astype(np.float32)}
    batch = {**{k: b[k] for k in ("gt_rot", "gt_trans", "gt_points",
                                  "roi_extent", "sym_rots", "sym_valid")},
             **labels}
    kw = dict(rot_lw=0.5)
    jc, tc = configs(**kw)
    for flow in ("flow4", "all"):
        o = dict(outs)
        if flow == "all":
            o["flow"] = [rng.normal(0, 1, (2, 64 // f, 64 // f, 2)).astype(
                np.float32) for f in (4, 8, 16, 32, 64)]
        jl = JDM.deepim_loss(jc.deepim, jax.tree_util.tree_map(jnp.asarray, o),
                             {k: jnp.asarray(v) for k, v in batch.items()})
        tl = deepim_loss(tc.deepim, jax.tree_util.tree_map(torch.from_numpy, o),
                         {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(tl) == set(jl) == {"loss_PM_R", "loss_PM_xy", "loss_PM_z",
                                      "loss_flow", "loss_mask",
                                      "loss_trans_xy", "loss_trans_z",
                                      "loss_rot"}
        for k in jl:
            np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                       err_msg=f"{flow} {k}")
            assert tl[k].item() > 0, k


# ---- the train step --------------------------------------------------------

SOLVER = dict(optimizer="ranger", base_lr=1e-3, warmup_method="none",
              total_iters=100, ims_per_batch=2, reference_bs=2)
STEPS = 2


def _train_runs():
    mp = micro_patch()
    try:
        jc, tc = configs(solver=SOLVER)
        jm = jde.build_deepim(jc)
        b = make_batch()
        x = jnp.zeros((2, 64, 64, 6))
        v = jax.jit(lambda k, *a: jm.init(k, *a))(
            jax.random.PRNGKey(0), x, jnp.asarray(b["init_rot"]),
            jnp.asarray(b["init_trans"]), jnp.asarray(b["K"]))
        params = identity_heads(random_params(
            jax.tree_util.tree_map(np.asarray, v["params"]), 0, 0.05))
        tx, _ = jbuild_optimizer(jc.solver)
        jstate = create_train_state(jax.tree_util.tree_map(jnp.asarray, params),
                                    {}, tx)
        jstep = jax.jit(jde.make_train_step(jc, jm))
        jb = {k: jnp.asarray(a) for k, a in b.items()}
        jloss = []
        for _ in range(STEPS):
            jstate, m = jstep(jstate, jb, jax.random.PRNGKey(0))
            jloss.append(float(m["total_loss"]))
    finally:
        mp.undo()

    tm = DeepIM(tc.deepim, widths=MICRO)
    tm.load_state_dict(flax_to_state_dict(params, tm), strict=True)
    init = {k: p.detach().clone() for k, p in tm.named_parameters()}
    state = tde.init_state(tc, tm)
    step = tde.make_train_step(tc, tm, device="cpu")
    tmetrics = []
    for _ in range(STEPS):
        state, m = step(state, b)
        tmetrics.append({k: float(x) for k, x in m.items()})
    return dict(jstate=jstate, jloss=jloss, tstate=state, tmetrics=tmetrics,
                init=init)


@pytest.fixture(scope="module")
def train_runs():
    return one_thread(_train_runs)


def test_train_step_losses_match_jax(train_runs):
    for j, t in zip(train_runs["jloss"], train_runs["tmetrics"]):
        np.testing.assert_allclose(t["total_loss"], j, rtol=RTOL)
    m = train_runs["tmetrics"][0]
    assert {"loss_PM_R", "loss_PM_xy", "loss_PM_z", "loss_flow", "loss_mask",
            "loss_trans_xy", "loss_trans_z"} == set(m) - {"total_loss"}
    assert all(v > 0 for v in m.values()), m


@pytest.mark.parametrize("which", ["params", "ema_params"])
def test_train_step_params_match_jax(train_runs, which):
    ts = train_runs["tstate"]
    net = ts.model if which == "params" else ts.teacher
    ref = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, getattr(train_runs["jstate"], which)), ts.model)
    init = train_runs["init"]
    moved = 0.0
    for k, p in net.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[k].numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
        moved = max(moved, ((p.detach() - init[k]).abs()
                            / (ATOL + RTOL * init[k].abs())).max().item())
    if which == "params":
        assert moved > 100, moved
    assert ts.step == STEPS


def test_train_step_refuses_batch_norm():
    """Finding: the JAX package's DeepIM train step applies the model in
    train mode without a mutable batch_stats collection, so Flax refuses
    the running-statistics update of FlowNetS with batch norm and of the
    ResNet trunks (DeepIM_Shared, as DeepIM_Unshared); the port's step
    refuses the same models before it runs."""
    b = make_batch()
    jb = {k: jnp.asarray(a) for k, a in b.items()}
    for kw in (dict(use_bn=True),
               dict(name="DeepIM_Shared", backbone="micro", with_flow=False,
                    flow_lw=0.0)):
        mp = micro_patch()
        try:
            jc, tc = configs(solver=SOLVER, **kw)
            jm = jde.build_deepim(jc)
            jstate = jde.init_state(jc, jm, jb)
            assert jstate.batch_stats
            with pytest.raises(flax.errors.ModifyScopeVariableError,
                               match="batch_stats"):
                jde.make_train_step(jc, jm)(jstate, jb, jax.random.PRNGKey(0))
        finally:
            mp.undo()
        tm = tde.build_deepim(tc, device="cpu", train=True)
        with pytest.raises(ValueError, match="batch norm"):
            tde.make_train_step(tc, tm, device="cpu")


def test_build_deepim_for_training():
    """train=True keeps float32 parameters in train mode whatever the
    compute dtype; the entry points need CUDA unless asked for the CPU."""
    _, tc = configs()
    bf = dataclasses.replace(tc, dist=tcfg.DistConfig(compute_dtype="bfloat16"))
    m = tde.build_deepim(bf, device="cpu", train=True)
    assert m.training and next(m.parameters()).dtype == torch.float32
    assert not tde.build_deepim(bf, device="cpu").training


def test_warm_n_iter_ramp():
    d = tcfg.DeepIMConfig(n_iter_train=4, n_iter_train_warm_iters=100)
    jd = jcfg.DeepIMConfig(n_iter_train=4, n_iter_train_warm_iters=100)
    table = {0: 1, 24: 1, 25: 1, 49: 2, 99: 4, 5000: 4}
    for it, n in table.items():
        assert tde.warm_n_iter(d, it) == jde.warm_n_iter(jd, it) == n, it
    for it in range(0, 130, 7):
        assert tde.warm_n_iter(d, it) == jde.warm_n_iter(jd, it), it
    d0 = dataclasses.replace(d, n_iter_train_warm_iters=0)
    assert tde.warm_n_iter(d0, 0) == 4
