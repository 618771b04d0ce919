"""The modules of every GDR-Net architecture the JAX GDRN builds, in the
port against the JAX package, in float32 on the CPU at test size (micro
widths, 64² input, 16² output, batch 2); the whole GDRN and its train step
are in test_torch_gdrn_variants_model.py:
  * each new module against its Flax counterpart, forward within 1e-5
    after the weights are carried across by convert.py: ConvTranspose2x
    at k = 2, 3, 4; DropBlock fed JAX's Bernoulli draw; the two other
    translation decodings; the geo heads' shared and split out layers;
    ConvGeoHead and FPNGeoHead; ConvPnPNet with each mask attention and the
    extent embedding; SimplePointPnPNet; DarknetBackbone (reduced through
    depths and base_width); PVNetResNet8s at out_stride 1, 4 and 8; FPN;
  * the config trees: every JAX field path is the port's, with the JAX
    default.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import flax.linen as fnn
import pytest
import torch

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.models import layers as jlayers
from self6dpp_tpu.models import necks as jnecks
from self6dpp_tpu.models.backbones import darknet as jdark
from self6dpp_tpu.models.backbones import pvnet as jpv
from self6dpp_tpu.models.heads import conv_pnp_net as jpnp
from self6dpp_tpu.models.heads import top_down_head as jhead
from self6dpp_tpu.ops import pose_decode as jpd
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch import convert as C
from self6dpp_tpu_torch.models import layers as tlayers
from self6dpp_tpu_torch.models.backbones.darknet import DarknetBackbone
from self6dpp_tpu_torch.models.backbones.pvnet import PVNetResNet8s
from self6dpp_tpu_torch.models.heads.conv_pnp_net import (ConvPnPNet,
                                                          SimplePointPnPNet)
from self6dpp_tpu_torch.models.heads.top_down_head import (ConvGeoHead,
                                                           FPNGeoHead,
                                                           TopDownGeoHead)
from self6dpp_tpu_torch.models.necks import FPN
from self6dpp_tpu_torch.ops import pose_decode as tpd

from test_torch_gdrn import perturbed
from test_torch_gdrn_train import to_jax

TOL_MODULE = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the CPU build's oneDNN convolution backward has
    crashed with 4 or more threads on the GDRN backward."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def nchw(x):
    return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def flax_init(module, *args, seed=0, **kw):
    """Variables of `module` (statistics and scales perturbed, so that every
    converted leaf matters)."""
    v = jax.jit(lambda k, *a: module.init(k, *a, **kw))(
        jax.random.PRNGKey(seed), *args)
    return perturbed(jax.tree_util.tree_map(np.asarray, v), seed + 1)


def flax_apply(module, variables, *args, **kw):
    return np.asarray(jax.jit(lambda v, *a: module.apply(v, *a, **kw))(
        variables, *args))


def carry(module, variables, key_map, flat_hwc=None):
    """module (eval mode) with the Flax variables carried across."""
    module.load_state_dict(C._convert(module, C._variables(variables),
                                      key_map, flat_hwc), strict=True)
    return module.eval()


def close(got, ref, tol=TOL_MODULE, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=0,
                               atol=tol, err_msg=what)


def rand(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


# ---- modules ------------------------------------------------------------

@pytest.mark.parametrize("k", [2, 3, 4])
def test_conv_transpose_2x_matches_flax(k):
    x = rand((2, 5, 6, 8))
    jm = jlayers.ConvTranspose2x(4, k)
    v = flax_init(jm, x)
    ref = flax_apply(jm, v, x)
    assert ref.shape == (2, 10, 12, 4)
    tm = tlayers.ConvTranspose2x(8, 4, k)
    w = C._to_torch_layout(np.asarray(v["params"]["ConvTranspose_0"]["kernel"]),
                           "deconv", None)
    tm.weight.data.copy_(torch.from_numpy(np.ascontiguousarray(w)))
    with torch.no_grad():
        close(nhwc(tm(nchw(x))), ref)


def test_dropblock_matches_flax(monkeypatch):
    """DropBlock fed JAX's Bernoulli draw: the same seed rate, the dilated
    keep mask bit for bit, the output within 1e-6; no draw when off."""
    x = rand((2, 16, 16, 13)) + 2.0
    draws = []
    bern = jax.random.bernoulli

    def record(key, p, shape):
        out = bern(key, p, shape)
        draws.append((float(p), np.asarray(out)))
        return out
    monkeypatch.setattr(jax.random, "bernoulli", record)
    jm = jlayers.DropBlock(drop_prob=0.3)
    ref = np.asarray(jm.apply({}, x, train=True,
                              rngs={"dropout": jax.random.PRNGKey(3)}))
    (gamma, seed_b), = draws
    assert gamma == tlayers.dropblock_gamma(0.3, 5, 16, 16)
    seed = seed_b.astype(np.float32)
    keep_ref = 1.0 - np.asarray(fnn.max_pool(jnp.asarray(seed), (5, 5),
                                              strides=(1, 1), padding="SAME"))
    y = tlayers.dropblock_apply(torch.from_numpy(x), torch.from_numpy(seed))
    keep = 1.0 - torch.nn.functional.max_pool2d(
        torch.from_numpy(seed).permute(0, 3, 1, 2), 5, 1, 2).permute(0, 2, 3, 1)
    assert 0 < seed.sum() and keep_ref.min() == 0.0
    np.testing.assert_array_equal(keep.numpy(), keep_ref)
    close(y.numpy(), ref, 1e-6)

    tm = tlayers.DropBlock(0.3).train()
    monkeypatch.setattr(tlayers, "dropblock_seed",
                        lambda *a: torch.from_numpy(seed))
    close(tm(torch.from_numpy(x)).numpy(), ref, 1e-6)

    def no_draw(*a):
        raise AssertionError("drew with DropBlock off")
    monkeypatch.setattr(tlayers, "dropblock_seed", no_draw)
    xt = torch.from_numpy(x)
    assert tlayers.DropBlock(0.3).eval()(xt) is xt
    assert tlayers.DropBlock(0.0).train()(xt) is xt


@pytest.mark.parametrize("is_allo", [True, False])
def test_translation_decodings_match_jax(is_allo):
    rng = np.random.default_rng(1)
    rot = np.stack([np.linalg.qr(rng.normal(size=(3, 3)))[0]
                    for _ in range(4)]).astype(np.float32)
    cam = np.tile(np.array([[572.4, 0, 325.3], [0, 573.6, 242.0],
                            [0, 0, 1]], np.float32), (4, 1, 1))
    cen = rng.uniform(200, 400, (4, 2)).astype(np.float32)
    z = rng.uniform(0.5, 1.5, (4, 1)).astype(np.float32)
    t = np.concatenate([rng.normal(0, 0.1, (4, 2)), z], 1).astype(np.float32)
    T = torch.from_numpy
    for jf, tf, args in (
            (jpd.pose_from_centroid_z_abs, tpd.pose_from_centroid_z_abs,
             (rot, cen, z, cam)),
            (jpd.pose_from_trans, tpd.pose_from_trans, (rot, t))):
        jr, jt = jf(*map(jnp.asarray, args), is_allo=is_allo)
        r, tt = tf(*map(T, args), is_allo=is_allo)
        close(r.numpy(), jr, 1e-6)
        close(tt.numpy(), jt, 1e-6)


def head_cfg(name="TopDownMaskXyzRegionHead", **kw):
    return [m.GeoHeadConfig(name=name, feat_dim=16, num_gn_groups=4,
                            num_regions=4, xyz_bin=1, **kw) for m in (jc, tc)]


def compare_maps(got, ref):
    assert set(got) == set(ref)
    for k in ref:
        close(got[k].detach().numpy(), ref[k], what=k)


@pytest.mark.parametrize("case", [
    dict(name="TopDownMaskXyzRegionHead", deconv_kernel_size=4,
         out_layer_shared=False),
    dict(name="TopDownMaskXyzRegionHead", deconv_kernel_size=2,
         up_types=("deconv", "deconv", "nearest"), with_norm=True),
    dict(name="ConvMaskXyzRegionHead", num_feat_layers=2),
    dict(name="ConvMaskXyzRegionHead", num_feat_layers=1,
         out_layer_shared=False, num_masks=2, with_vf=True, num_vf_points=2),
])
def test_geo_heads_match_flax(case):
    """The TopDown and conv heads with shared and split out layers."""
    jg, tg = head_cfg(**case)
    top = case["name"].startswith("TopDown")
    x = rand((2, 2, 2, 12) if top else (2, 16, 16, 12), seed=2)
    jm = (jhead.TopDownGeoHead if top else jhead.ConvGeoHead)(cfg=jg,
                                                              num_classes=3)
    v = flax_init(jm, x)
    ref = jax.jit(lambda v, a: jm.apply(v, a))(v, x)
    tm = (TopDownGeoHead if top else ConvGeoHead)(tg, 12, 3)
    carry(tm, v, C.geo_head_key_map(tg))
    with torch.no_grad():
        compare_maps(tm(nchw(x)), ref)


def test_fpn_geo_head_matches_flax():
    jg, tg = head_cfg("FPNMaskXyzRegionHead")
    strides = (4, 8, 16, 32)
    xs = [rand((2, 64 // s, 64 // s, 12), seed=i) for i, s in enumerate(strides)]
    jm = jhead.FPNGeoHead(cfg=jg, num_classes=2, feature_strides=strides)
    v = flax_init(jm, xs)
    ref = jax.jit(lambda v, a: jm.apply(v, a))(v, xs)
    tm = FPNGeoHead(tg, [12] * 4, strides, 2)
    carry(tm, v, C.geo_head_key_map(tg, [len(h) for h in tm.scale_heads]))
    with torch.no_grad():
        compare_maps(tm([nchw(x) for x in xs]), ref)


def pnp_inputs(seed=3, extra=0):
    rng = np.random.default_rng(seed)
    coor = rng.uniform(0, 1, (2, 16, 16, 5)).astype(np.float32)
    region = rng.dirichlet(np.ones(4), (2, 16, 16)).astype(np.float32)
    ext = rng.uniform(0.05, 0.2, (2, 3)).astype(np.float32)
    mask = rng.uniform(0, 1, (2, 16, 16, 1)).astype(np.float32)
    ex = rng.normal(size=(2, 16, 16, extra)).astype(np.float32) if extra \
        else None
    return coor, region, ext, mask, ex


@pytest.mark.parametrize("name,kw", [
    ("ConvPnPNet", dict(mask_attention="none")),
    ("ConvPnPNet", dict(mask_attention="mul", with_extent_feat=True)),
    ("ConvPnPNet", dict(mask_attention="concat", with_extent_feat=True,
                        flat_op="avg-max")),
    ("ConvPnPNet", dict(mask_attention="concat", num_extra_layers=1)),
    ("SimplePointPnPNet", dict(mask_attention="none")),
    ("SimplePointPnPNet", dict(mask_attention="concat")),
    ("SimplePointPnPNet", dict(mask_attention="mul")),
])
def test_pnp_heads_match_flax(name, kw):
    jp, tp = [m.PnPNetConfig(name=name, featdim=16, num_gn_groups=4, **kw)
              for m in (jc, tc)]
    extra = 3 if kw.get("num_extra_layers") else 0
    coor, region, ext, mask, ex = pnp_inputs(extra=extra)
    nin = 5 + 4 + (1 if kw["mask_attention"] == "concat" else 0) + extra
    jm = (jpnp.ConvPnPNet if name == "ConvPnPNet"
          else jpnp.SimplePointPnPNet)(cfg=jp, rot_dim=6)
    args = (coor, region, ext, mask, ex)
    v = flax_init(jm, *args)
    ref = jax.jit(lambda v, *a: jm.apply(v, *a))(v, *args)
    tm = (ConvPnPNet(tp, nin, 16, 6) if name == "ConvPnPNet"
          else SimplePointPnPNet(tp, nin, 6))
    carry(tm, v, C.pnp_key_map(tp), getattr(tm, "flat_hwc", None))
    with torch.no_grad():
        got = tm(*[None if a is None else torch.from_numpy(a) for a in args])
    for g, r in zip(got, ref):
        close(g.numpy(), r)


@pytest.mark.parametrize("out_indices", [(5,), (3, 4, 5)])
def test_darknet_matches_flax(out_indices):
    depths = (1, 2, 1, 1, 1)
    x = rand((2, 64, 64, 3), seed=4)
    jm = jdark.DarknetBackbone(depths=depths, base_width=8,
                               out_indices=out_indices)
    v = flax_init(jm, x)
    ref = jax.jit(lambda v, a: jm.apply(v, a))(v, x)
    tm = carry(DarknetBackbone(3, depths, 8, out_indices), v,
               C.darknet_key_map(depths))
    with torch.no_grad():
        got = tm(nchw(x))
    if len(out_indices) == 1:
        got, ref = [got], [ref]
    assert [g.shape[1] for g in got] == tm.feature_channels
    for g, r in zip(got, ref):
        close(nhwc(g), r)


@pytest.mark.parametrize("out_stride,concat", [(1, True), (4, False),
                                               (8, False)])
def test_pvnet_matches_flax(out_stride, concat):
    x = rand((2, 64, 64, 3), seed=5)
    jm = jpv.PVNetResNet8s(arch="micro", out_stride=out_stride,
                           concat_input=concat)
    v = flax_init(jm, x)
    ref = flax_apply(jm, v, x)
    tm = PVNetResNet8s("micro", 3, out_stride=out_stride, concat_input=concat)
    dec = tuple(n for n in ("conv8s", "conv4s", "conv2s", "convraw")
                if hasattr(tm, n))
    carry(tm, v, C.pvnet_key_map("micro", dec))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == ref.shape == (2, 64 // out_stride, 64 // out_stride,
                                      tm.feature_channels[0])
    close(got, ref)


def test_fpn_neck_matches_flax():
    xs = [rand((2, 64 // s, 64 // s, c), seed=i)
          for i, (s, c) in enumerate(((8, 8), (16, 16), (32, 32)))]
    jm = jnecks.FPN(out_channels=16)
    v = flax_init(jm, xs)
    ref = jax.jit(lambda v, a: jm.apply(v, a))(v, xs)
    tm = carry(FPN([8, 16, 32], 16), v,
               {f"{p}{i}": ("conv", f"{p}{i}") for i in range(3)
                for p in ("lateral", "smooth")})
    with torch.no_grad():
        got = tm([nchw(x) for x in xs])
    for g, r in zip(got, ref):
        close(nhwc(g), r)


# ---- config parity --------------------------------------------------------

# the one field the port leaves out: the JAX renderer picks its fine stage
# by name ('pallas' | 'xla'); the port picks the CUDA kernel or the plain
# version by the tensor's device (and impl='plain' on the call)
KEPT_OUT = {"renderer.impl"}


def field_tree(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(field_tree(v, f"{prefix}{f.name}."))
        else:
            out[f"{prefix}{f.name}"] = v
    return out


def test_config_trees_match_jax():
    j, t = field_tree(jc.Config()), field_tree(tc.Config())
    assert set(j) - set(t) == KEPT_OUT
    assert set(t) <= set(j)
    for k in set(j) & set(t):
        assert j[k] == t[k], (k, j[k], t[k])
    # every JAX key takes an --opts override in the port
    cfg = tc.apply_overrides(tc.Config(), [
        "model.backbone.freeze=true", "model.backbone.pretrained=x.npz",
        "model.geo_head.freeze=true", "model.geo_head.num_feat_layers=3",
        "model.pnp_net.freeze=true", "model.pnp_net.coord_2d_type=rel",
        "model.neck_out_channels=128"])
    assert cfg.model.geo_head.num_feat_layers == 3
    assert cfg.model.neck_out_channels == 128
    assert to_jax(cfg).model.pnp_net.coord_2d_type == "rel"
