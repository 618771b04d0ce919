"""The port's checkpoint converter (self6dpp_tpu_torch/tools/
convert_torch_weights.py) against the JAX package's
tools/convert_torch_weights.py: fed the same reference state dict, both
write the same arrays (keys, dtypes and .npy bytes) for every --kind and
for convert_deepim; the port's models loaded from the port tool's output
reproduce the golden fixtures' reference activations; a missing key
raises, naming it, in both."""

import io
import os
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import convert_torch_weights as jtool  # noqa: E402

from self6dpp_tpu_torch import config as tc  # noqa: E402
from self6dpp_tpu_torch.engine.checkpoint import load_params_npz  # noqa: E402
from self6dpp_tpu_torch.models.backbones.flownet import FlowNetS  # noqa: E402
from self6dpp_tpu_torch.models.backbones.resnet import ResNetBackbone  # noqa: E402
from self6dpp_tpu_torch.models.deepim import DeepIM  # noqa: E402
from self6dpp_tpu_torch.models.heads.conv_pnp_net import ConvPnPNet  # noqa: E402
from self6dpp_tpu_torch.models.heads.top_down_head import TopDownGeoHead  # noqa: E402
from self6dpp_tpu_torch.tools import convert_torch_weights as ttool  # noqa: E402

_FIX = Path(__file__).resolve().parent / "fixtures"
MICRO_FLOWNET = (8, 12, 16, 16, 16, 24)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def raw(name, scope=""):
    fx = np.load(_FIX / f"golden_{name}.npz")
    return {scope + k[4:]: torch.from_numpy(fx[k]) for k in fx.files
            if k.startswith("raw.")}


def seeded(sd, seed=0):
    """The state dict's float tensors redrawn from a seed (BN variances
    positive); integer buffers as they are."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for k, v in sd.items():
        if v.is_floating_point():
            v = torch.randn(v.shape, generator=g) * 0.1
            if k.endswith("running_var"):
                v = v.abs() + 0.5
        out[k] = v.clone()
    return out


def lpips_reference():
    g = torch.Generator().manual_seed(3)
    shapes = {"net.slice1.0": (64, 3, 11, 11), "net.slice2.3": (192, 64, 5, 5),
              "net.slice3.6": (384, 192, 3, 3), "net.slice4.8": (256, 384, 3, 3),
              "net.slice5.10": (256, 256, 3, 3)}
    sd = {}
    for k, s in shapes.items():
        sd[f"{k}.weight"] = torch.randn(s, generator=g)
        sd[f"{k}.bias"] = torch.randn(s[0], generator=g)
    for i, c in enumerate((64, 192, 384, 256, 256)):
        sd[f"lin{i}.model.1.weight"] = torch.rand((1, c, 1, 1), generator=g)
    return sd


def gdrn_reference():
    """A whole reference GDRN: the micro ResNet fixture as its backbone,
    the geo/PnP fixture as its heads."""
    return {**raw("micro_resnet", "backbone."), **raw("geo_pnp")}


def npy_members(path):
    """{array name: its .npy bytes} of an .npz (the zip's own timestamps
    left out)."""
    with zipfile.ZipFile(path) as z:
        return {n[:-4]: z.read(n) for n in z.namelist()}


def npy_bytes(arrays):
    out = {}
    for k, a in arrays.items():
        buf = io.BytesIO()
        np.save(buf, a)
        out[k] = buf.getvalue()
    return out


def run_both(tmp_path, sd, argv, monkeypatch):
    src = tmp_path / "src.pth"
    torch.save({"state_dict": sd}, src)
    outs = []
    for name, tool in (("jax", jtool), ("port", ttool)):
        out = tmp_path / f"{name}.npz"
        args = ["--src", str(src), "--out", str(out), *argv]
        if tool is jtool:
            monkeypatch.setattr(sys, "argv", ["convert_torch_weights", *args])
            tool.main()
        else:
            assert tool.main(args) == 0
        outs.append(out)
    return outs


CASES = {
    "raw": (lambda: raw("micro_resnet"), []),
    "lpips": (lpips_reference, ["--kind", "lpips"]),
    "resnet_micro": (lambda: raw("micro_resnet"),
                     ["--kind", "resnet", "--arch", "micro"]),
    "resnet_micro_prefix": (lambda: raw("micro_resnet"),
                            ["--kind", "resnet", "--arch", "micro",
                             "--prefix", "backbone"]),
    "resnet18": (lambda: seeded(ResNetBackbone("resnet18").state_dict(), 1),
                 ["--kind", "resnet", "--arch", "resnet18"]),
    "resnet50d": (lambda: seeded(ResNetBackbone("resnet50d").state_dict(), 2),
                  ["--kind", "resnet", "--arch", "resnet50d"]),
    "resnest50d": (lambda: seeded(ResNetBackbone("resnest50d").state_dict(), 3),
                   ["--kind", "resnet", "--arch", "resnest50d"]),
    "gdrn": (gdrn_reference, ["--kind", "gdrn", "--arch", "micro"]),
    "flownet": (lambda: raw("micro_flownet"), ["--kind", "flownet"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_same_npz_as_the_jax_tool(case, tmp_path, monkeypatch):
    make, argv = CASES[case]
    jout, tout = run_both(tmp_path, make(), argv, monkeypatch)
    j, t = npy_members(jout), npy_members(tout)
    assert sorted(j) == sorted(t)
    assert j
    for k in j:
        assert j[k] == t[k], k


def deepim_reference(flat_op):
    """A reference DeepIM_FlowNet state dict: the port's DeepIM (micro
    FlowNetS, reference names) redrawn from a seed, with a mask head of
    one ConvModule; for flat_op 'flatten' a first pose Linear over a
    1024-channel 2x2 map."""
    cfg = tc.DeepIMConfig(num_classes=2, input_h=64, input_w=64,
                          pose_feat_dim=32)
    sd = seeded(DeepIM(cfg, widths=MICRO_FLOWNET).state_dict(), 4)
    g = torch.Generator().manual_seed(5)
    sd["mask_head.features.0.conv.weight"] = torch.randn((8, 24, 3, 3), generator=g)
    sd["mask_head.features.0.gn.weight"] = torch.randn(8, generator=g)
    sd["mask_head.features.0.gn.bias"] = torch.randn(8, generator=g)
    if flat_op == "flatten":
        sd["pose_head.linears.0.weight"] = torch.randn((32, 4096), generator=g)
    return sd


@pytest.mark.parametrize("flat_op", ["avg", "flatten"])
def test_convert_deepim_same_arrays(flat_op):
    sd = deepim_reference(flat_op)
    kw = dict(mask_feat_layers=1, flat_op=flat_op)
    j = jtool.convert_deepim(jtool.torch_state_to_numpy(sd), **kw)
    t = ttool.convert_deepim(ttool.torch_state_to_numpy(sd), **kw)
    assert sorted(j) == sorted(t)
    jb, tb = npy_bytes(j), npy_bytes(t)
    for k in jb:
        assert jb[k] == tb[k], k


def test_port_models_reproduce_the_golden_fixtures(tmp_path):
    """Converted by the port's tool, loaded by load_params_npz, run in
    float32: the fixtures' recorded reference outputs within 1e-5."""
    def convert(sd, *argv):
        src, out = tmp_path / "src.pth", tmp_path / f"{len(os.listdir(tmp_path))}.npz"
        torch.save(sd, src)
        assert ttool.main(["--src", str(src), "--out", str(out), *argv]) == 0
        return str(out)

    def nhwc(t):
        return t.permute(0, 2, 3, 1).numpy()

    fx = np.load(_FIX / "golden_micro_resnet.npz")
    net = load_params_npz(convert(raw("micro_resnet"), "--kind", "resnet",
                                  "--arch", "micro"),
                          ResNetBackbone("micro").eval())
    with torch.no_grad():
        y = net(torch.from_numpy(fx["input"]).permute(0, 3, 1, 2))
    np.testing.assert_allclose(nhwc(y), fx["expected"], atol=TOL)

    fx = np.load(_FIX / "golden_micro_flownet.npz")
    net = load_params_npz(convert(raw("micro_flownet"), "--kind", "flownet"),
                          FlowNetS(widths=MICRO_FLOWNET,
                                   out_flow_level="flow4").eval())
    with torch.no_grad():
        outs = net(torch.from_numpy(fx["input"]).permute(0, 3, 1, 2))
    for key, got in zip(("expected_out6", "expected_concat4",
                         "expected_flow4"), outs):
        np.testing.assert_allclose(nhwc(got), fx[key], atol=TOL)

    fx = np.load(_FIX / "golden_geo_pnp.npz")
    path = convert(gdrn_reference(), "--kind", "gdrn", "--arch", "micro")
    geo = TopDownGeoHead(tc.GeoHeadConfig(feat_dim=16, num_gn_groups=4,
                                          num_regions=4, xyz_bin=1),
                         in_channels=24).eval()
    pnp = ConvPnPNet(tc.PnPNetConfig(featdim=16, num_gn_groups=4,
                                     denormalize_by_extent=False),
                     in_channels=8, in_res=16).eval()
    load_params_npz(path, geo, prefix="geo_head")
    load_params_npz(path, pnp, prefix="pnp_net")
    back = load_params_npz(path, ResNetBackbone("micro").eval(),
                           prefix="backbone")
    xp = torch.from_numpy(fx["input_pnp"])
    with torch.no_grad():
        maps = geo(torch.from_numpy(fx["input_geo"]).permute(0, 3, 1, 2))
        rot, t = pnp(xp[..., :3], xp[..., 3:])
        y = back(torch.from_numpy(np.load(_FIX / "golden_micro_resnet.npz")[
            "input"]).permute(0, 3, 1, 2))
    got = torch.cat([maps[k] for k in ("mask", "xyz", "region")], -1)
    np.testing.assert_allclose(got.numpy(), fx["expected_geo"], atol=TOL)
    np.testing.assert_allclose(rot.numpy(), fx["expected_rot"], atol=TOL)
    np.testing.assert_allclose(t.numpy(), fx["expected_t"], atol=TOL)
    np.testing.assert_allclose(
        nhwc(y), np.load(_FIX / "golden_micro_resnet.npz")["expected"],
        atol=TOL)


@pytest.mark.parametrize("kind,drop", [
    ("resnet", "layer2.0.bn1.running_var"),
    ("gdrn", "pnp_net.fc2.weight"),
    ("flownet", "predict_flow5.weight"),
])
def test_missing_key_raises_naming_it(kind, drop):
    srcs = {"resnet": lambda: raw("micro_resnet"), "gdrn": gdrn_reference,
            "flownet": lambda: raw("micro_flownet")}
    sd = srcs[kind]()
    del sd[drop]
    calls = {"resnet": lambda m, f: m.convert_resnet(f, "micro"),
             "gdrn": lambda m, f: m.convert_gdrn(f, "micro"),
             "flownet": lambda m, f: m.convert_flownet(f)}
    short = drop.split(".", 1)[1] if kind == "gdrn" else drop
    for mod in (jtool, ttool):
        with pytest.raises(KeyError, match=short.replace(".", r"\.")):
            calls[kind](mod, mod.torch_state_to_numpy(sd))
