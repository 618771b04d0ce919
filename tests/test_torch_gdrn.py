"""The port's GDRN against the JAX package's, in float32 on the CPU: the
whole forward on the same weights (micro, resnet18 and resnest50d
backbones: the port's seeded weights placed in the JAX model's variables,
perturbed there, and brought back by the port's convert.py), and the
committed golden fixtures (reference torch state dicts
with their recorded activations) loaded straight into the port's modules.
"""

import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from self6dpp_tpu.config import base as jc
from self6dpp_tpu.data.synthetic import make_gdrn_batch as jax_batch
from self6dpp_tpu.engine import gdrn_engine as jge
from self6dpp_tpu_torch import config as tc
from self6dpp_tpu_torch.convert import gdrn_flax_to_state_dict
from self6dpp_tpu_torch.data.synthetic import make_gdrn_batch
from self6dpp_tpu_torch.engine import gdrn_engine as tge
from self6dpp_tpu_torch.models.backbones.resnet import ResNetBackbone
from self6dpp_tpu_torch.models.heads.conv_pnp_net import ConvPnPNet
from self6dpp_tpu_torch.models.heads.top_down_head import TopDownGeoHead

_FIX = os.path.join(os.path.dirname(__file__), "fixtures")
TOL = 1e-4

ARCHS = {
    # backbone: (classes, geo head, pnp net)
    "micro": (2, dict(feat_dim=16, num_gn_groups=4, num_regions=4),
              dict(featdim=16, num_gn_groups=4)),
    "resnet18": (2, dict(feat_dim=32, num_gn_groups=8, num_regions=8),
                 dict(featdim=32, num_gn_groups=8)),
    "resnest50d": (13, {}, {}),          # flagship widths at input 64 / 16
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, as tests/test_torch_self_engine.py runs: next to
    other test processes on the same cores, a thread per core makes the
    resnest50d init and forward many times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def configs(arch):
    nc, gh, pn = ARCHS[arch]
    out = []
    for m in (jc, tc):
        model = m.PoseNetConfig(
            num_classes=nc, input_res=64, output_res=16,
            backbone=m.BackboneConfig(name=arch),
            geo_head=m.GeoHeadConfig(**gh), pnp_net=m.PnPNetConfig(**pn))
        out.append(m.Config(model=model,
                            dist=m.DistConfig(compute_dtype="float32")))
    return out


def perturbed(variables, seed=1):
    """Norm scales, biases and BN statistics off their initial values, so
    that every converted leaf matters."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        name = getattr(path[-1], "key", "")
        if name in ("scale", "var"):
            return (x * rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (x + rng.normal(0, 0.1, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(f, variables)


def port_to_flax(model, shapes):
    """The port's weights as a Flax variables tree of the given shapes:
    element ids sent through gdrn_flax_to_state_dict show where each torch
    element comes from (two float32-exact halves of a global id)."""
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    sizes = [int(np.prod(x.shape)) for x in leaves]
    starts = np.cumsum([0] + sizes)
    split = 1 << 20
    halves = []
    for part in (lambda i: i // split, lambda i: i % split):
        ids = [part(np.arange(a, a + n)).astype(np.float32).reshape(x.shape)
               for a, n, x in zip(starts, sizes, leaves)]
        halves.append(gdrn_flax_to_state_dict(
            jax.tree_util.tree_unflatten(treedef, ids), model))
    flat = np.zeros(starts[-1], np.float32)
    for k, v in model.state_dict().items():
        if k.endswith("num_batches_tracked"):
            continue
        gid = (halves[0][k].numpy().astype(np.int64) * split
               + halves[1][k].numpy().astype(np.int64))
        flat[gid.ravel()] = v.numpy().ravel()
    return jax.tree_util.tree_unflatten(treedef, [
        flat[a:a + n].reshape(x.shape)
        for a, n, x in zip(starts, sizes, leaves)])


@functools.cache
def jax_init(arch):
    """(JAX model, variables holding the port's seeded initial weights, the
    numpy batch). The variables' shapes come from the JAX model's init,
    traced but not run: cheaper on the CPU than compiling it."""
    jcfg, tcfg = configs(arch)
    batch = jax_batch(jcfg, 2)
    jm = jge.build_gdrn(jcfg)
    shapes = jax.eval_shape(
        lambda k, *a: jm.init(k, *a, train=False), jax.random.PRNGKey(0),
        *jge.model_inputs({k: jnp.asarray(v) for k, v in batch.items()}))
    variables = port_to_flax(tge.build_gdrn(tcfg, device="cpu", seed=0),
                             shapes)
    return jm, variables, batch


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_gdrn_forward_matches_jax(arch):
    jcfg, tcfg = configs(arch)
    jm, variables, ref = jax_init(arch)
    batch = make_gdrn_batch(tcfg, 2)
    for k in ref:                        # the numpy copy draws the same batch
        np.testing.assert_array_equal(batch[k], ref[k], err_msg=k)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = perturbed(variables)
    jout = jax.jit(lambda v, *a: jm.apply(v, *a, train=False))(
        variables, *jge.model_inputs(jb))

    model = tge.build_gdrn(tcfg, device="cpu")
    model.load_state_dict(gdrn_flax_to_state_dict(variables, model),
                          strict=True)
    with torch.no_grad():
        out = model(*tge.model_inputs(
            {k: torch.from_numpy(v) for k, v in batch.items()}))
    for k in ("rot", "trans", "coor", "mask_logits", "region_logits"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                   rtol=0, atol=TOL, err_msg=k)


def test_convert_rejects_leftovers():
    _, tcfg = configs("micro")
    _, variables, _ = jax_init("micro")
    model = tge.build_gdrn(tcfg, device="cpu")
    extra = {"params": dict(variables["params"], mtl={"w": np.zeros(3)}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="left unused"):
        gdrn_flax_to_state_dict(extra, model)
    missing = {"params": {k: v for k, v in variables["params"].items()
                          if k != "pnp_net"},
               "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="lack"):
        gdrn_flax_to_state_dict(missing, model)


def _raw(fx, prefix):
    pre = f"raw.{prefix}"
    return {k[len(pre):]: torch.from_numpy(fx[k]) for k in fx.files
            if k.startswith(pre)}


def test_golden_micro_resnet_fixture():
    """The reference torch state dict loads as it is (timm names) and
    reproduces the recorded activations."""
    fx = np.load(os.path.join(_FIX, "golden_micro_resnet.npz"))
    net = ResNetBackbone("micro").eval()
    net.load_state_dict(_raw(fx, ""), strict=True)
    with torch.no_grad():
        y = net(torch.from_numpy(fx["input"]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), fx["expected"],
                               atol=1e-4)


def test_golden_geo_pnp_fixture():
    """The reference GDRN head state dicts (geo_head_net, pnp_net with its
    C-major flatten) load as they are and reproduce the activations."""
    fx = np.load(os.path.join(_FIX, "golden_geo_pnp.npz"))
    geo = TopDownGeoHead(tc.GeoHeadConfig(feat_dim=16, num_gn_groups=4,
                                          num_regions=4, xyz_bin=1),
                         in_channels=24).eval()
    pnp = ConvPnPNet(tc.PnPNetConfig(featdim=16, num_gn_groups=4,
                                     denormalize_by_extent=False),
                     in_channels=8, in_res=16).eval()
    geo.load_state_dict(_raw(fx, "geo_head_net."), strict=True)
    pnp.load_state_dict(_raw(fx, "pnp_net."), strict=True)
    xp = torch.from_numpy(fx["input_pnp"])
    with torch.no_grad():
        maps = geo(torch.from_numpy(fx["input_geo"]).permute(0, 3, 1, 2))
        rot, t = pnp(xp[..., :3], xp[..., 3:])
    got = torch.cat([maps[k] for k in ("mask", "xyz", "region")], -1)
    np.testing.assert_allclose(got.numpy(), fx["expected_geo"], atol=1e-4)
    np.testing.assert_allclose(rot.numpy(), fx["expected_rot"], atol=1e-4)
    np.testing.assert_allclose(t.numpy(), fx["expected_t"], atol=1e-4)
