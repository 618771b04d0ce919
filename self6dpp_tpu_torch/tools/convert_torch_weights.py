"""Convert the reference's PyTorch checkpoints into the flat .npz that the
training CLIs' --init-npz reads (port of tools/convert_torch_weights.py:
the same CLI, functions and output, array for array).

    python -m self6dpp_tpu_torch.tools.convert_torch_weights \\
        --src model_final.pth --out gdrn.npz --kind gdrn --arch resnest50d

The .npz holds the JAX package's variables flattened to dotted keys
('params.backbone.Conv_0.kernel', 'batch_stats.….mean', ...) in the JAX
layout, which engine/checkpoint.py::load_params_npz loads into the port's
models (strict=False for a part of a model). Kinds:
  raw      every array of the state dict with the generic layout change
           (conv OIHW -> HWIO, linear (out, in) -> (in, out)), names kept;
  lpips    the reference PerceptualSimilarity alexnet -> conv<i>/lin<i>;
  resnet   a timm ResNet / ResNet-D / ResNeSt (--arch; --prefix scopes
           it, e.g. 'backbone' for a GDRN);
  gdrn     a whole reference GDRN: timm backbone, geo_head_net, pnp_net;
  flownet  the reference FlowNetS (flow4 decoder).
convert_deepim converts a whole DeepIM_FlowNet (no CLI kind, as in the
JAX tool).

The module maps are convert.py's (resnet_key_map, flownet_key_map,
geo_head_key_map, pnp_key_map, the leaf names), and each array's layout
goes through convert.py's _from_torch_layout, so the port keeps one set
of tables for both directions. A missing source key raises, naming it.
"""

from __future__ import annotations

import argparse

import numpy as np

from .. import convert
from ..config import GeoHeadConfig, PnPNetConfig
from ..models.backbones.resnet import _STAGE_SPECS as ARCH_SPECS


def torch_state_to_numpy(state_dict) -> dict[str, np.ndarray]:
    """Every array of a state dict as numpy with the generic layout change:
    4-D (conv OIHW) -> HWIO, a 2-D weight (or a '.fc' array) transposed."""
    out = {}
    for k, v in state_dict.items():
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        if a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif a.ndim == 2 and (k.endswith("weight") or ".fc" in k):
            a = a.T
        out[k] = a
    return out


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """torch.load of a reference checkpoint (its 'state_dict', 'model' or
    'model_state' entry if it has one) through torch_state_to_numpy. The
    model zoo's files are pickled dicts, so this loads with
    weights_only=False: convert only files from a source you trust."""
    import torch
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    for key in ("state_dict", "model", "model_state"):
        if isinstance(ckpt, dict) and key in ckpt:
            ckpt = ckpt[key]
            break
    if not isinstance(ckpt, dict):
        raise TypeError(f"{path}: not a state dict ({type(ckpt).__name__})")
    return torch_state_to_numpy(ckpt)


def _torch_layout(a: np.ndarray) -> np.ndarray:
    """The inverse of torch_state_to_numpy's change for a weight."""
    if a.ndim == 4:
        return a.transpose(3, 2, 0, 1)
    return a.T if a.ndim == 2 else a


def _map_block(src: dict[str, np.ndarray], key_map, pre: str,
               out: dict[str, np.ndarray], used: set, flat_channels=None,
               what: str = "") -> None:
    """Apply a {torch module: (kind, flax module)} map of convert.py to the
    arrays of torch_state_to_numpy. flat_channels: the conv width feeding
    an 'fc_flat' Linear, whose input rows are permuted from torch's NCHW
    flatten order to NHWC."""
    for tpath, (kind, fpath) in key_map.items():
        leaves = convert._NORM_LEAVES if kind in ("bn", "gn") \
            else convert._LEAVES
        for leaf, (coll, fleaf) in leaves.items():
            if kind == "gn" and coll != "params":
                continue
            tk = f"{tpath}.{leaf}"
            if tk not in src:
                if leaf == "bias" and kind in ("conv", "deconv"):
                    continue                       # bias-free convs
                raise KeyError(f"{what}missing source key {tk}")
            a = src[tk]
            if leaf == "weight" and kind not in ("bn", "gn"):
                hwc = None
                if kind == "fc_flat":
                    s = int(round((a.shape[0] // flat_channels) ** 0.5))
                    hwc = (s, s, flat_channels)
                a = convert._from_torch_layout(_torch_layout(a), kind, hwc)
            out[f"{coll}.{pre}{fpath}.{fleaf}"] = a
            used.add(tk)


def convert_lpips(src: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The reference alexnet LPIPS -> {'conv<i>.weight' (HWIO), 'conv<i>.bias',
    'lin<i>.weight' (C,)}: the names of the JAX package's load_lpips_params
    (convert.LPIPS_REFERENCE_MAP without the port's 'alex.' scope)."""
    out = {}
    for tk, pk in convert.LPIPS_REFERENCE_MAP.items():
        ok = pk.removeprefix("alex.")
        if f"{tk}.weight" in src:
            w = src[f"{tk}.weight"]
            out[f"{ok}.weight"] = w.reshape(-1) if ok.startswith("lin") else w
        if f"{tk}.bias" in src:
            out[f"{ok}.bias"] = src[f"{tk}.bias"]
    return out


def resnet_key_map(arch: str) -> dict[str, tuple[str, str]]:
    return convert.resnet_key_map(arch)


def convert_resnet(src: dict[str, np.ndarray], arch: str,
                   prefix: str = "") -> dict[str, np.ndarray]:
    """A timm backbone's arrays -> 'params.<prefix.>Conv_0.kernel', ...
    ('batch_stats.….mean' / 'var' for the BN statistics; SplitAttn's 1x1
    fc convs as Dense (in, out) kernels)."""
    pre = f"{prefix}." if prefix else ""
    out: dict[str, np.ndarray] = {}
    used: set[str] = set()
    _map_block(src, resnet_key_map(arch), pre, out, used, what=f"{arch}: ")
    skipped = [k for k in src
               if k not in used and not k.endswith("num_batches_tracked")]
    if skipped:
        print(f"note: {len(skipped)} source arrays not mapped "
              f"(classifier head etc.): {skipped[:6]} ...")
    return out


def flownet_key_map(out_flow_level: str = "flow4", use_bn: bool = False
                    ) -> dict[str, tuple[str, str]]:
    return convert.flownet_key_map(out_flow_level != "none", out_flow_level,
                                   use_bn)


def convert_flownet(src: dict[str, np.ndarray], out_flow_level: str = "flow4",
                    use_bn: bool = False, prefix: str = ""
                    ) -> dict[str, np.ndarray]:
    """The reference FlowNetS -> flat flax names (flownet_key_map)."""
    out: dict[str, np.ndarray] = {}
    pre = f"{prefix}." if prefix else ""
    _map_block(src, flownet_key_map(out_flow_level, use_bn), pre, out, set())
    return out


def _scope(src: dict[str, np.ndarray], name: str) -> dict[str, np.ndarray]:
    return {k[len(name) + 1:]: v for k, v in src.items()
            if k.startswith(name + ".")}


def convert_deepim(src: dict[str, np.ndarray], out_flow_level: str = "flow4",
                   use_bn: bool = False, pose_num_layers: int = 2,
                   mask_feat_layers: int = 0, flat_op: str = "avg"
                   ) -> dict[str, np.ndarray]:
    """A whole reference DeepIM_FlowNet: backbone (FlowNetS), pose_head
    (linears.{3i}, fc_r, fc_t; with flat_op 'flatten' the first Linear's
    rows permuted from torch's C-major flatten to NHWC) and, when the file
    has one, mask_head (features.{i} ConvModules, out_layer)."""
    out: dict[str, np.ndarray] = {}
    _map_block(_scope(src, "backbone"),
               flownet_key_map(out_flow_level, use_bn), "backbone.", out,
               set())
    pm = {f"linears.{3 * i}": (
        "fc_flat" if (i == 0 and flat_op == "flatten") else "fc",
        f"Dense_{i}") for i in range(pose_num_layers)}
    pm.update({"fc_r": ("fc", "fc_r"), "fc_t": ("fc", "fc_t")})
    _map_block(_scope(src, "pose_head"), pm, "pose_head.", out, set(),
               flat_channels=1024 if flat_op == "flatten" else None)
    mh = _scope(src, "mask_head")
    if mh:
        mm: dict[str, tuple[str, str]] = {}
        for i in range(mask_feat_layers):
            mm.update(convert._conv_norm_act(f"features.{i}",
                                             f"ConvNormAct_{i}", "GN"))
        mm["out_layer"] = ("conv", "Conv_0")
        _map_block(mh, mm, "mask_head.", out, set())
    return out


def geo_head_key_map(up_types=("deconv", "bilinear", "bilinear"),
                     num_conv_per_block=2) -> dict[str, tuple[str, str]]:
    """The reference TopDown geo head (features.<i>, out_layer), GN."""
    return convert.geo_head_key_map(GeoHeadConfig(
        up_types=tuple(up_types), num_conv_per_block=num_conv_per_block))


def pnp_key_map(num_stride2_layers=3, num_extra_layers=0
                ) -> dict[str, tuple[str, str]]:
    """The reference ConvPnPNet (features.{3i} conv, .{3i+1} GN, fc1 with
    its flatten permutation, fc2, fc_r, fc_t)."""
    m = convert.pnp_key_map(PnPNetConfig(
        num_stride2_layers=num_stride2_layers,
        num_extra_layers=num_extra_layers))
    return {k: v for k, v in m.items() if not k.startswith("fc_extent")}


def convert_gdrn(src: dict[str, np.ndarray], arch: str = "resnest50d",
                 up_types=("deconv", "bilinear", "bilinear"),
                 num_conv_per_block=2, num_stride2_layers=3,
                 num_extra_layers=0) -> dict[str, np.ndarray]:
    """A whole reference GDRN: backbone (timm) -> backbone, geo_head_net ->
    geo_head, pnp_net -> pnp_net. Other arrays (the MTL log-variances)
    are left out: load the result with load_params_npz(..., strict=False)
    over a fresh model."""
    out = convert_resnet(_scope(src, "backbone"), arch, prefix="backbone")
    used: set[str] = set()
    _map_block(_scope(src, "geo_head_net"),
               geo_head_key_map(up_types, num_conv_per_block), "geo_head.",
               out, used)
    pn = _scope(src, "pnp_net")
    if "features.1.weight" not in pn:
        raise KeyError("missing source key pnp_net.features.1.weight")
    _map_block(pn, pnp_key_map(num_stride2_layers, num_extra_layers),
               "pnp_net.", out, used,
               flat_channels=pn["features.1.weight"].shape[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Convert a reference PyTorch checkpoint into the flat "
                    ".npz that --init-npz loads. The file is read with "
                    "torch.load(weights_only=False), which runs the "
                    "checkpoint's pickle: convert only trusted files.")
    p.add_argument("--src", required=True, help="torch .pth checkpoint")
    p.add_argument("--out", required=True, help="output .npz")
    p.add_argument("--kind", default="raw",
                   choices=["raw", "lpips", "resnet", "gdrn", "flownet"])
    p.add_argument("--arch", default="resnest50d", choices=sorted(ARCH_SPECS),
                   help="backbone architecture (for --kind resnet, gdrn)")
    p.add_argument("--prefix", default="",
                   help="submodule scope, e.g. 'backbone' for a GDRN")
    args = p.parse_args(argv)
    flat = load_torch_checkpoint(args.src)
    convs = {"lpips": convert_lpips,
             "resnet": lambda f: convert_resnet(f, args.arch, args.prefix),
             "gdrn": lambda f: convert_gdrn(f, args.arch),
             "flownet": lambda f: convert_flownet(f, prefix=args.prefix)}
    if args.kind in convs:
        flat = convs[args.kind](flat)
    np.savez(args.out, **flat)
    print(f"wrote {len(flat)} arrays -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

