"""The port's DeepIM eval path against the JAX package's: FlowNetS on the
committed golden fixture, the DeepIM module forward on converted weights,
and the 2-iteration render-and-compare refine, all in float32 on the CPU.

Both sides use micro FlowNetS widths (the JAX module's FlowNetS is swapped
for a micro-width partial in the test; nothing in the JAX package changes)
and identity-biased pose heads (init_identity_heads_), so that refining
keeps the object in view.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as Fnn
from jax.experimental import pallas as pl
from scipy.spatial.transform import Rotation

import self6dpp_tpu.models.deepim as JDM
import self6dpp_tpu.ops.raster_pallas as RP
from self6dpp_tpu.config import base as jcfg
from self6dpp_tpu.engine import deepim_engine as jde
from self6dpp_tpu.models.backbones.flownet import FlowNetS as JFlowNetS
from self6dpp_tpu_torch import config as tcfg
from self6dpp_tpu_torch.convert import flax_to_state_dict
from self6dpp_tpu_torch.data.meshes import make_cube
from self6dpp_tpu_torch.engine import deepim_engine as tde
from self6dpp_tpu_torch.models.backbones.flownet import FlowNetS
from self6dpp_tpu_torch.models.deepim import DeepIM
from self6dpp_tpu_torch.utils import profiling

MICRO = (8, 12, 16, 16, 16, 24)
_FLOWNET = os.path.join(os.path.dirname(__file__), "fixtures",
                        "golden_micro_flownet.npz")
_orig_pallas_call = pl.pallas_call


def _interp_pallas_call(*args, **kw):
    kw.setdefault("interpret", True)
    return _orig_pallas_call(*args, **kw)


@pytest.fixture
def micro_jax(monkeypatch):
    monkeypatch.setattr(JDM, "FlowNetS",
                        functools.partial(JFlowNetS, widths=MICRO))


def nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def test_flownet_golden_fixture():
    """The reference torch state dict loads as it is (same module names)
    and reproduces the committed activations."""
    fx = np.load(_FLOWNET)
    net = FlowNetS(widths=MICRO, out_flow_level="flow4").eval()
    sd = {k[len("raw."):]: torch.from_numpy(fx[k]) for k in fx.files
          if k.startswith("raw.")}
    net.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out6, concat4, flow4 = net(torch.from_numpy(fx["input"]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(nhwc(out6), fx["expected_out6"], atol=1e-4)
    np.testing.assert_allclose(nhwc(concat4), fx["expected_concat4"], atol=1e-4)
    np.testing.assert_allclose(nhwc(flow4), fx["expected_flow4"], atol=1e-4)


def dicfg(**kw):
    return dict(num_classes=2, input_h=64, input_w=64, pose_feat_dim=32,
                n_iter_train=2, n_iter_test=2, **kw)


def configs(**kw):
    dist = dict(compute_dtype="float32")
    j = jcfg.Config(deepim=jcfg.DeepIMConfig(**dicfg(**kw)),
                    dist=jcfg.DistConfig(**dist))
    t = tcfg.Config(deepim=tcfg.DeepIMConfig(**dicfg(**kw)),
                    dist=tcfg.DistConfig(**dist))
    return j, t


def identity_heads(params):
    params = jax.tree_util.tree_map(np.array, params)
    ph = params["pose_head"]
    ph["fc_r"]["bias"] = np.array([1.0, 0, 0, 0, 1.0, 0], np.float32)
    ph["fc_t"]["bias"] = np.array([0.0, 0, 1.0], np.float32)
    return params


def random_params(params, seed, head_std):
    """Fresh numpy weights of unit-gain scale (pose outputs at head_std), so
    the outputs depend on the features; identity-biased heads."""
    rng = np.random.default_rng(seed)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]

    def draw(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if names[-1] == "bias":
            return rng.normal(0, 0.01, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        std = head_std if names[-2] in ("fc_r", "fc_t") else fan_in ** -0.5
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    leaves = [draw(p, l) for p, l in flat]
    tree = jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(params), leaves)
    return identity_heads(tree)


def make_batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    verts, faces = make_cube(size=0.3)
    colors = ((verts - verts.min(0)) / (verts.max(0) - verts.min(0))
              ).astype(np.float32)
    K = np.array([[64.0, 0, 32], [0, 64.0, 32], [0, 0, 1]], dtype=np.float32)
    gt_rot = Rotation.random(b, random_state=seed).as_matrix().astype(np.float32)
    gt_trans = np.stack([rng.uniform(-0.05, 0.05, b),
                         rng.uniform(-0.05, 0.05, b),
                         rng.uniform(0.9, 1.1, b)], 1).astype(np.float32)
    return {
        "obs_img": rng.uniform(0, 1, (b, 64, 64, 3)).astype(np.float32),
        "obs_box": np.array([[8, 8, 56, 56]] * b, dtype=np.float32),
        "K": np.broadcast_to(K, (b, 3, 3)).copy(),
        "verts": verts, "faces": faces, "colors": colors,
        "roi_cls": np.array([0, 1], np.int32)[:b],
        "init_rot": gt_rot,
        "init_trans": gt_trans + np.array([0.03, 0.0, 0.05], np.float32),
    }


def build_pair(seed=0, head_std=0.05, **kw):
    jc, tc = configs(**kw)
    jm = jde.build_deepim(jc)
    b = make_batch()
    x = jnp.zeros((2, 64, 64, 6))
    params = jm.init(jax.random.PRNGKey(0), x, jnp.asarray(b["init_rot"]),
                     jnp.asarray(b["init_trans"]), jnp.asarray(b["K"]),
                     obj_class=jnp.asarray(b["roi_cls"]))["params"]
    params = random_params(params, seed, head_std)
    tm = DeepIM(tc.deepim, widths=MICRO).eval()
    tm.load_state_dict(flax_to_state_dict(params, tm), strict=True)
    return jc, tc, jm, params, tm, b


@pytest.mark.parametrize("kw", [dict(), dict(flat_op="flatten"),
                                dict(mask_class_aware=True,
                                     flat_op="avg-max-min")],
                         ids=["avg", "flatten", "class_aware"])
def test_deepim_forward_matches_jax(micro_jax, kw):
    jc, tc, jm, params, tm, b = build_pair(**kw)
    rng = np.random.default_rng(1)
    x = rng.uniform(0, 1, (2, 64, 64, 6)).astype(np.float32)
    K = np.array([[[300.0, 0, 32], [0, 310.0, 30], [0, 0, 1]]] * 2, np.float32)
    args = (x, b["init_rot"], b["init_trans"], K)
    jo = jm.apply({"params": params}, *map(jnp.asarray, args),
                  obj_class=jnp.asarray(b["roi_cls"]))
    with torch.no_grad():
        to = tm(*map(torch.from_numpy, args),
                obj_class=torch.from_numpy(b["roi_cls"]))
    for name in ("rot", "trans", "mask_logits", "flow"):
        np.testing.assert_allclose(to[name].numpy(), np.asarray(jo[name]),
                                   atol=1e-4, err_msg=name)
    # the pose moved: the comparison is not of two identities
    assert np.abs(np.asarray(jo["rot"]) - b["init_rot"]).max() > 1e-3


@pytest.mark.parametrize("raster", ["default", "pallas"])
def test_refine_matches_jax(micro_jax, monkeypatch, raster):
    """2 render-and-compare iterations: the JAX refine with its default
    renderer (XLA on the CPU) or the Pallas kernel in interpret mode, the
    port's with its plain fine stage."""
    jc, tc, jm, params, tm, b = build_pair(head_std=0.3)
    rkw = None
    if raster == "pallas":
        monkeypatch.setattr(RP.pl, "pallas_call", _interp_pallas_call)
        rkw = {"impl": "pallas"}
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jrefine = jde.make_refine_fn(jc, jm, n_iter=2, raster_kw=rkw)
    jr, jt = jrefine({"params": params}, jb, jb["init_rot"], jb["init_trans"])
    step = tde.make_eval_step(tc, tm, device="cpu")
    names = []
    with profiling.recording() as rec:
        out = step(b, names.append)
    # the request's phases reach the mark hook; its spans nest under one
    # root
    assert names == ["render", "network_fwd"] * 2
    assert [s.name for s in rec.spans if s.parent < 0] == ["eval_step"]
    assert {s.name for s in rec.spans} == {
        "eval_step", "render", "network_fwd", "refine.boxes", "refine.crop",
        "render.project", "render.bin", "render.pack", "render.fine"}
    np.testing.assert_allclose(out["rot"].numpy(), np.asarray(jr), atol=1e-4)
    np.testing.assert_allclose(out["trans"].numpy(), np.asarray(jt), atol=1e-4)
    assert np.abs(np.asarray(jt) - b["init_trans"]).max() > 1e-3
    assert np.abs(np.asarray(jr) - b["init_rot"]).max() > 1e-2


def test_mask_upsample_matches_jax_resize(rng):
    m = rng.normal(size=(2, 5, 7, 3)).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(m), (2, 20, 28, 3), "bilinear")
    got = Fnn.interpolate(torch.from_numpy(m).permute(0, 3, 1, 2),
                          size=(20, 28), mode="bilinear", align_corners=False)
    np.testing.assert_allclose(nhwc(got), np.asarray(ref), atol=1e-5)


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.build_deepim(tc)
    model = tde.build_deepim(tc, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.make_eval_step(tc, model)
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.build_deepim(tc, train=True)
    trained = tde.build_deepim(tc, device="cpu", train=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tde.make_train_step(tc, trained)


def test_build_deepim_seeded_and_dtype():
    _, tc = configs()
    g = lambda: torch.Generator().manual_seed(3)
    a = tde.build_deepim(tc, device="cpu", generator=g())
    b = tde.build_deepim(tc, device="cpu", generator=g())
    for (ka, va), (kb, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert ka == kb and torch.equal(va, vb)
    bf = tde.build_deepim(dataclasses.replace(
        tc, dist=tcfg.DistConfig(compute_dtype="bfloat16")), device="cpu")
    assert next(bf.parameters()).dtype == torch.bfloat16


def test_build_deepim_same_weights_in_every_dtype():
    """One seed gives the same draws in float32 and bfloat16 builds (the
    bfloat16 weights are the float32 ones rounded)."""
    _, tc = configs()
    g = lambda: torch.Generator().manual_seed(5)
    a = tde.build_deepim(tc, device="cpu", generator=g())
    bf = tde.build_deepim(dataclasses.replace(
        tc, dist=tcfg.DistConfig(compute_dtype="bfloat16")), device="cpu",
        generator=g())
    for (ka, va), (kb, vb) in zip(a.state_dict().items(),
                                  bf.state_dict().items()):
        assert ka == kb and torch.equal(va.to(torch.bfloat16), vb)


def test_convert_rejects_unused_and_missing(micro_jax):
    jc, tc, jm, params, tm, b = build_pair()
    extra = jax.tree_util.tree_map(lambda a: a, params)
    extra["pose_head"]["Dense_9"] = {"kernel": np.zeros((2, 2), np.float32)}
    with pytest.raises(KeyError, match="unused"):
        flax_to_state_dict(extra, tm)
    missing = jax.tree_util.tree_map(lambda a: a, params)
    del missing["pose_head"]["fc_t"]
    with pytest.raises(KeyError, match="fc_t"):
        flax_to_state_dict(missing, tm)


def test_lm_flownet_matches_jax_config():
    import importlib.util
    path = os.path.join(os.path.dirname(__file__), "..", "configs", "deepim",
                        "lm_flownet.py")
    spec = importlib.util.spec_from_file_location("_lm_flownet", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    ref = mod.get_config()
    cfg = tcfg.lm_flownet()
    assert dataclasses.asdict(cfg.deepim) == dataclasses.asdict(ref.deepim)
    assert dataclasses.asdict(cfg.dist) == dataclasses.asdict(ref.dist)
    # the port has no impl field: the fine stage is the kernel on the card
    # (rasterize_batch(impl="plain") is the control run's only other route)
    rr = dataclasses.asdict(ref.renderer)
    assert rr.pop("impl") == "auto"
    assert dataclasses.asdict(cfg.renderer) == rr
    assert cfg.solver.ims_per_batch == ref.solver.ims_per_batch == 8
    # the train step's solver (Ranger, cosine anneal, no accumulation)
    assert dataclasses.asdict(cfg.solver) == dataclasses.asdict(ref.solver)
