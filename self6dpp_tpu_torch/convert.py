"""JAX-package variables (nested dicts of numpy arrays) -> the port's
state_dicts, for DeepIM (its three variants), FlowNetS, GDRN, YOLOv4 and
LPIPS, and the GDRN's, DeepIM's and YOLOv4's state_dicts back to
JAX-package variables (gdrn_state_dict_to_flax, state_dict_to_flax,
yolo_state_dict_to_flax).

Inverts the key maps and layout changes of tools/convert_torch_weights.py
(flownet_key_map, convert_deepim, resnet_key_map, geo_head_key_map,
pnp_key_map, _map_block), with its own copy of the maps:
  conv    flax (kh,kw,in,out)            -> torch (out,in,kh,kw)
  deconv  flax (kh,kw,in,out), applied by lax.conv_transpose without a
          spatial flip                   -> torch (in,out,kh,kw), flipped
  fc      flax (in,out)                  -> torch (out,in)
  fc_flat as fc, with the input dim permuted from NHWC flatten order to the
          NCHW order the port (like the reference) flattens in
  dense   flax Dense (in,out)            -> torch 1x1 conv (out,in,1,1)
  bn      scale, bias (params), mean, var (batch_stats) -> weight, bias,
          running_mean, running_var
  gn      scale, bias                    -> weight, bias
  mtl     params['mtl'][term] (1,)       -> mtl.<term> (use_mtl)
The GDRN's geo-head out layer and first PnP conv take whatever width the
configuration gives them (the vf/norm channels of the MaskNormVF variant
widen both). Raises on any flax leaf left unused and any torch key left
unfilled.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .models.deepim import DeepIM

_FLOWNET_CONVS = ("conv1", "conv2", "conv3", "conv3_1", "conv4", "conv4_1",
                  "conv5", "conv5_1", "conv6", "conv6_1")
_LEAVES = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_NORM_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
                "running_mean": ("batch_stats", "mean"),
                "running_var": ("batch_stats", "var")}


def flownet_key_map(with_decoder: bool, out_flow_level: str = "flow4",
                    use_bn: bool = False) -> dict[str, tuple[str, str]]:
    """{torch module path: (kind, flax module path)} for FlowNetS."""
    m = {f"{n}.0": ("conv", f"_Conv_{i}.Conv_0")
         for i, n in enumerate(_FLOWNET_CONVS)}
    if use_bn:
        m.update({f"{n}.1": ("bn", f"_Conv_{i}.BatchNorm_0")
                  for i, n in enumerate(_FLOWNET_CONVS)})
    if with_decoder:
        # decoder modules in call order
        m["predict_flow6"] = ("conv", "_PredictFlow_0.Conv_0")
        m["upsampled_flow6_to_5"] = ("deconv", "_UpFlow_0.ConvTranspose_0")
        m["deconv5.0"] = ("deconv", "_Deconv_0.ConvTranspose_0")
        m["predict_flow5"] = ("conv", "_PredictFlow_1.Conv_0")
        m["upsampled_flow5_to_4"] = ("deconv", "_UpFlow_1.ConvTranspose_0")
        m["deconv4.0"] = ("deconv", "_Deconv_1.ConvTranspose_0")
    if out_flow_level != "none":
        m["predict_flow4"] = ("conv", "_PredictFlow_2.Conv_0")
    if out_flow_level == "all":
        m["upsampled_flow4_to_3"] = ("deconv", "_UpFlow_2.ConvTranspose_0")
        m["deconv3.0"] = ("deconv", "_Deconv_2.ConvTranspose_0")
        m["predict_flow3"] = ("conv", "_PredictFlow_3.Conv_0")
        m["upsampled_flow3_to_2"] = ("deconv", "_UpFlow_3.ConvTranspose_0")
        m["deconv2.0"] = ("deconv", "_Deconv_3.ConvTranspose_0")
        m["predict_flow2"] = ("conv", "_PredictFlow_4.Conv_0")
    return m


def deepim_key_map(model: DeepIM) -> dict[str, tuple[str, str]]:
    """The DeepIM's trunk (FlowNetS; or the ResNet of DeepIM_Shared, the
    observation's `backbone` and the render's `backbone_ren` of
    DeepIM_Unshared), pose head and mask head."""
    c = model.cfg
    if c.name == "DeepIM_FlowNet":
        nets = {"backbone": flownet_key_map(
            model.backbone.has_decoder,
            "flow4" if c.with_flow else "none", c.use_bn)}
    else:
        arch = c.backbone if c.backbone != "flownets" else "resnet18"
        names = ("backbone",) if c.name == "DeepIM_Shared" \
            else ("backbone", "backbone_ren")
        nets = {n: resnet_key_map(arch) for n in names}
    m = {f"{n}.{k}": (kind, f"{n}.{v}") for n, km in nets.items()
         for k, (kind, v) in km.items()}
    for i in range(c.pose_num_layers):
        kind = "fc_flat" if (i == 0 and c.flat_op == "flatten") else "fc"
        m[f"pose_head.linears.{3 * i}"] = (kind, f"pose_head.Dense_{i}")
    m["pose_head.fc_r"] = ("fc", "pose_head.fc_r")
    m["pose_head.fc_t"] = ("fc", "pose_head.fc_t")
    if c.with_mask_head:
        m["mask_head.out_layer"] = ("conv", "mask_head.Conv_0")
    return m


def resnet_key_map(arch: str) -> dict[str, tuple[str, str]]:
    """{timm module path: (kind, flax module path)} for ResNetBackbone: the
    stem Conv_i/BatchNorm_i, then BasicBlock_i / Bottleneck_i over all
    stages with their inner modules in call order."""
    from .models.backbones.resnet import _STAGE_SPECS
    kind, depths = _STAGE_SPECS[arch]
    deep = arch.endswith("d")
    if deep:
        m = {"conv1.0": ("conv", "Conv_0"), "conv1.1": ("bn", "BatchNorm_0"),
             "conv1.3": ("conv", "Conv_1"), "conv1.4": ("bn", "BatchNorm_1"),
             "conv1.6": ("conv", "Conv_2"), "bn1": ("bn", "BatchNorm_2")}
    else:
        m = {"conv1": ("conv", "Conv_0"), "bn1": ("bn", "BatchNorm_0")}
    flax_block = "BasicBlock" if kind == "basic" else "Bottleneck"
    widths = (8, 16, 32, 64) if arch == "micro" else (64, 128, 256, 512)
    i, cin = 0, 64
    for stage, (w, d) in enumerate(zip(widths, depths), start=1):
        cout = w if kind == "basic" else w * 4
        for b in range(d):
            t, f = f"layer{stage}.{b}", f"{flax_block}_{i}"
            i += 1
            stride = 2 if (b == 0 and stage > 1) else 1
            has_down = stride != 1 or cin != cout
            cin = cout
            if kind == "basic":
                m[f"{t}.conv1"] = ("conv", f"{f}.Conv_0")
                m[f"{t}.bn1"] = ("bn", f"{f}.BatchNorm_0")
                m[f"{t}.conv2"] = ("conv", f"{f}.Conv_1")
                m[f"{t}.bn2"] = ("bn", f"{f}.BatchNorm_1")
                dn = (f"{f}.Conv_2", f"{f}.BatchNorm_2")
            elif kind == "bottleneck":
                for j in (1, 2, 3):
                    m[f"{t}.conv{j}"] = ("conv", f"{f}.Conv_{j - 1}")
                    m[f"{t}.bn{j}"] = ("bn", f"{f}.BatchNorm_{j - 1}")
                dn = (f"{f}.Conv_3", f"{f}.BatchNorm_3")
            else:  # splat (ResNeSt)
                sa = f"{f}.SplitAttention_0"
                m[f"{t}.conv1"] = ("conv", f"{f}.Conv_0")
                m[f"{t}.bn1"] = ("bn", f"{f}.BatchNorm_0")
                m[f"{t}.conv2.conv"] = ("conv", f"{sa}.Conv_0")
                m[f"{t}.conv2.bn0"] = ("bn", f"{sa}.BatchNorm_0")
                m[f"{t}.conv2.fc1"] = ("dense", f"{sa}.Dense_0")
                m[f"{t}.conv2.bn1"] = ("bn", f"{sa}.BatchNorm_1")
                m[f"{t}.conv2.fc2"] = ("dense", f"{sa}.Dense_1")
                m[f"{t}.conv3"] = ("conv", f"{f}.Conv_1")
                m[f"{t}.bn3"] = ("bn", f"{f}.BatchNorm_1")
                dn = (f"{f}.Conv_2", f"{f}.BatchNorm_2")
            if has_down:
                j = 1 if deep else 0        # avg-down puts the pool at 0
                m[f"{t}.downsample.{j}"] = ("conv", dn[0])
                m[f"{t}.downsample.{j + 1}"] = ("bn", dn[1])
    return m


def geo_head_key_map(up_types=("deconv", "bilinear", "bilinear"),
                     num_conv_per_block=2) -> dict[str, tuple[str, str]]:
    """{'features.<i>' path: (kind, flax path)} for TopDownGeoHead."""
    m: dict[str, tuple[str, str]] = {}
    idx = nd = ncna = 0
    for up in up_types:
        if up == "deconv":
            m[f"features.{idx}"] = ("deconv", f"ConvTranspose2x_{nd}.ConvTranspose_0")
            m[f"features.{idx + 1}"] = ("gn", f"Norm_{nd}.GroupNorm_0")
            nd += 1
            idx += 3                              # deconv, norm, act
        else:
            idx += 1                              # parameter-free upsample
        for _ in range(num_conv_per_block):
            m[f"features.{idx}.conv"] = ("conv", f"ConvNormAct_{ncna}.Conv_0")
            m[f"features.{idx}.gn"] = ("gn", f"ConvNormAct_{ncna}.Norm_0.GroupNorm_0")
            ncna += 1
            idx += 1
    m["out_layer"] = ("conv", "Conv_0")           # shared mask|xyz|region conv
    return m


def pnp_key_map(num_layers: int) -> dict[str, tuple[str, str]]:
    """{pnp_net path: (kind, flax path)} for ConvPnPNet."""
    m: dict[str, tuple[str, str]] = {}
    for i in range(num_layers):
        m[f"features.{3 * i}"] = ("conv", f"Conv_{i}")
        m[f"features.{3 * i + 1}"] = ("gn", f"Norm_{i}.GroupNorm_0")
    m.update({"fc1": ("fc_flat", "Dense_0"), "fc2": ("fc", "Dense_1"),
              "fc_r": ("fc", "fc_r"), "fc_t": ("fc", "fc_t")})
    return m


def gdrn_key_map(model) -> dict[str, tuple[str, str]]:
    c = model.cfg
    m = {f"backbone.{k}": (kind, f"backbone.{v}")
         for k, (kind, v) in resnet_key_map(c.backbone.name).items()}
    m.update({f"geo_head_net.{k}": (kind, f"geo_head.{v}") for k, (kind, v) in
              geo_head_key_map(c.geo_head.up_types,
                               c.geo_head.num_conv_per_block).items()})
    n = c.pnp_net.num_stride2_layers + c.pnp_net.num_extra_layers
    m.update({f"pnp_net.{k}": (kind, f"pnp_net.{v}")
              for k, (kind, v) in pnp_key_map(n).items()})
    if c.use_mtl:
        m["mtl"] = ("mtl", "mtl")
    return m


def _flatten(tree: Mapping, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = np.asarray(v)
    return out


def _to_torch_layout(a: np.ndarray, kind: str,
                     flat_hwc: tuple[int, int, int] | None) -> np.ndarray:
    if a.ndim == 1:
        return a                                   # bias, norm vectors
    if kind == "conv":
        return a.transpose(3, 2, 0, 1)
    if kind == "deconv":
        return a[::-1, ::-1].transpose(2, 3, 0, 1)
    if kind == "dense":
        return a.T[:, :, None, None]
    if kind == "fc_flat":
        h, w, ch = flat_hwc
        cout = a.shape[1]
        a = a.reshape(h, w, ch, cout).transpose(2, 0, 1, 3).reshape(-1, cout)
    return a.T


def _from_torch_layout(t: np.ndarray, kind: str,
                       flat_hwc: tuple[int, int, int] | None) -> np.ndarray:
    """The inverse of _to_torch_layout."""
    if t.ndim == 1:
        return t
    if kind == "conv":
        return t.transpose(2, 3, 1, 0)
    if kind == "deconv":
        return t.transpose(2, 3, 0, 1)[::-1, ::-1]
    if kind == "dense":
        return t[:, :, 0, 0].T
    a = t.T
    if kind == "fc_flat":
        h, w, ch = flat_hwc
        cout = a.shape[1]
        a = a.reshape(ch, h, w, cout).transpose(1, 2, 0, 3).reshape(-1, cout)
    return a


def _flax_key(tk: str, key_map: dict[str, tuple[str, str]]
              ) -> tuple[str, str | None]:
    """(kind, 'collection.module.leaf') of a torch key; None for
    num_batches_tracked, which flax does not keep."""
    mod, leaf = tk.rsplit(".", 1)
    if mod not in key_map:
        raise KeyError(f"no flax source for torch key {tk}")
    kind, fmod = key_map[mod]
    if leaf == "num_batches_tracked":
        return kind, None
    if kind == "mtl":
        return kind, f"params.{fmod}.{leaf}"
    leaves = _NORM_LEAVES if kind in ("bn", "gn") else _LEAVES
    if leaf not in leaves:
        raise KeyError(f"no flax leaf for torch key {tk}")
    coll, fleaf = leaves[leaf]
    return kind, f"{coll}.{fmod}.{fleaf}"


def _convert(model: nn.Module, flat: dict[str, np.ndarray],
             key_map: dict[str, tuple[str, str]],
             flat_hwc: tuple[int, int, int] | None) -> dict[str, torch.Tensor]:
    out, used = {}, set()
    for tk, target in model.state_dict().items():
        kind, fk = _flax_key(tk, key_map)
        if fk is None:
            out[tk] = torch.zeros_like(target)
            continue
        if fk not in flat:
            raise KeyError(f"flax variables lack {fk} (for {tk})")
        a = np.ascontiguousarray(_to_torch_layout(flat[fk], kind, flat_hwc))
        if tuple(a.shape) != tuple(target.shape):
            raise ValueError(f"{fk} -> {tk}: shape {a.shape} != "
                             f"{tuple(target.shape)}")
        out[tk] = torch.from_numpy(a.astype(np.float32))
        used.add(fk)
    unused = sorted(set(flat) - used)
    if unused:
        raise KeyError(f"flax variables left unused: {unused}")
    return out


def _variables(tree: Mapping) -> dict[str, np.ndarray]:
    """Flax variables ({'params': ..., 'batch_stats': ...}), or a bare
    `params` collection, flattened to 'collection.module.leaf' keys."""
    if "params" not in tree:
        tree = {"params": tree}
    return _flatten({k: tree[k] for k in ("params", "batch_stats")
                     if k in tree})


def flax_to_state_dict(variables: Mapping, model: DeepIM
                       ) -> dict[str, torch.Tensor]:
    """variables: the JAX DeepIM's {'params': ..., 'batch_stats': ...}
    (batch_stats for FlowNetS with batch norm and the ResNet variants), or
    its bare `params` collection. Returns a state_dict that
    model.load_state_dict takes with strict=True."""
    return _convert(model, _variables(variables), deepim_key_map(model),
                    model.feat_hwc)


def flownet_flax_to_state_dict(variables: Mapping, net
                               ) -> dict[str, torch.Tensor]:
    """variables: a JAX FlowNetS's {'params': ..., 'batch_stats': ...} (or
    its bare params). Returns the state_dict of the port's FlowNetS `net`."""
    return _convert(net, _variables(variables), flownet_key_map(
        net.has_decoder, net.out_flow_level, net.use_bn), None)


def _key_map(model) -> dict[str, tuple[str, str]]:
    from .models.yolo import YOLOv4
    if isinstance(model, DeepIM):
        return deepim_key_map(model)
    if isinstance(model, YOLOv4):
        return yolo_key_map(model)
    return gdrn_key_map(model)


def param_kinds(model) -> dict[str, str]:
    """{parameter name: the kind of its JAX counterpart's layout ('conv',
    'deconv', 'fc', 'fc_flat', 'dense', 'bn', 'gn', 'mtl')} of a DeepIM, a
    GDRN or a YOLOv4: what the optimizers that reduce over a tensor's axes
    (sgd_gc, adamp, sgdp) need to reduce as the JAX package does."""
    key_map = _key_map(model)
    return {n: key_map[n.rsplit(".", 1)[0]][0]
            for n, _ in model.named_parameters()}


def gdrn_flax_to_state_dict(variables: Mapping, model) -> dict[str, torch.Tensor]:
    """variables: the JAX GDRN's {'params': ..., 'batch_stats': ...}.
    Returns a state_dict that the port's GDRN takes with strict=True."""
    flat = _variables(variables)
    pn = model.pnp_net
    flat_hwc = (pn.flat_res, pn.flat_res, model.cfg.pnp_net.featdim)
    return _convert(model, flat, gdrn_key_map(model), flat_hwc)


def _state_dict_to_flax(sd: Mapping, key_map: dict[str, tuple[str, str]],
                        flat_hwc: tuple[int, int, int] | None) -> dict:
    tree: dict = {}
    for tk, v in sd.items():
        kind, fk = _flax_key(tk, key_map)
        if fk is None:
            continue
        a = _from_torch_layout(v.detach().float().cpu().numpy(), kind,
                               flat_hwc)
        *path, leaf = fk.split(".")
        node = tree
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(a, dtype=np.float32)
    return tree


def gdrn_state_dict_to_flax(model, state_dict: Mapping | None = None) -> dict:
    """The port GDRN's state_dict (default: its own) as the JAX GDRN's
    variables {'params': ..., 'batch_stats': ...}, nested dicts of float32
    numpy arrays: the inverse of gdrn_flax_to_state_dict."""
    sd = model.state_dict() if state_dict is None else state_dict
    pn = model.pnp_net
    flat_hwc = (pn.flat_res, pn.flat_res, model.cfg.pnp_net.featdim)
    return _state_dict_to_flax(sd, gdrn_key_map(model), flat_hwc)


def state_dict_to_flax(model: DeepIM, state_dict: Mapping | None = None
                       ) -> dict:
    """The port DeepIM's state_dict (default: its own) as the JAX DeepIM's
    variables ({'params': ...[, 'batch_stats': ...]}): the inverse of
    flax_to_state_dict."""
    sd = model.state_dict() if state_dict is None else state_dict
    return _state_dict_to_flax(sd, deepim_key_map(model), model.feat_hwc)


# ---------------------------------------------------------------------------
# YOLOv4
# ---------------------------------------------------------------------------

# the port's top-level YOLOv4 modules in the JAX model's call order, which
# is the order of Flax's auto-names (ConvBnMish_i, CSPBlock_i, SPP_0)
_YOLO_TOP = ("stem", "down1", "csp1", "down2", "csp2", "down3", "csp3",
             "down4", "csp4", "down5", "csp5", "spp", "reduce5", "lat4",
             "td4", "reduce4", "lat3", "td3", "bu3", "pan4", "bu4", "pan5")


def _yolo_block_map(mod, tpath: str, fpath: str
                    ) -> dict[str, tuple[str, str]]:
    """The leaves of one YOLOv4 block: ConvBnMish (Conv_0, BatchNorm_0),
    Bottleneck and SPP (ConvBnMish_0, ConvBnMish_1), CSPBlock
    (ConvBnMish_0, Bottleneck_i, Conv_0 = cv3, Conv_1 = cv2, BatchNorm_0,
    ConvBnMish_1)."""
    from .models.yolo import Bottleneck, ConvBnMish, CSPBlock, SPP
    if isinstance(mod, ConvBnMish):
        return {f"{tpath}.conv": ("conv", f"{fpath}.Conv_0"),
                f"{tpath}.bn": ("bn", f"{fpath}.BatchNorm_0")}
    m: dict[str, tuple[str, str]] = {}
    if isinstance(mod, (Bottleneck, SPP)):
        children = [("cv1", "ConvBnMish_0"), ("cv2", "ConvBnMish_1")]
    elif isinstance(mod, CSPBlock):
        children = [("cv1", "ConvBnMish_0"), ("cv4", "ConvBnMish_1")] + [
            (f"m.{i}", f"Bottleneck_{i}") for i in range(len(mod.m))]
        m[f"{tpath}.cv3"] = ("conv", f"{fpath}.Conv_0")
        m[f"{tpath}.cv2"] = ("conv", f"{fpath}.Conv_1")
        m[f"{tpath}.bn"] = ("bn", f"{fpath}.BatchNorm_0")
    else:
        raise TypeError(f"not a YOLOv4 block: {type(mod).__name__}")
    for t, f in children:
        m.update(_yolo_block_map(mod.get_submodule(t), f"{tpath}.{t}",
                                 f"{fpath}.{f}"))
    return m


def yolo_key_map(model) -> dict[str, tuple[str, str]]:
    """{torch module path: (kind, flax module path)} for YOLOv4."""
    count: dict[str, int] = {}
    m: dict[str, tuple[str, str]] = {}
    for name in _YOLO_TOP:
        mod = getattr(model, name)
        cls = type(mod).__name__
        i = count.get(cls, 0)
        count[cls] = i + 1
        m.update(_yolo_block_map(mod, name, f"{cls}_{i}"))
    for i in range(len(model.heads)):
        m[f"heads.{i}"] = ("conv", f"Conv_{i}")
    return m


def yolo_flax_to_state_dict(variables: Mapping, model
                            ) -> dict[str, torch.Tensor]:
    """variables: the JAX YOLOv4's {'params': ..., 'batch_stats': ...}.
    Returns a state_dict that the port's YOLOv4 takes with strict=True."""
    return _convert(model, _variables(variables), yolo_key_map(model), None)


def yolo_state_dict_to_flax(model, state_dict: Mapping | None = None) -> dict:
    """The port YOLOv4's state_dict (default: its own) as the JAX YOLOv4's
    variables: the inverse of yolo_flax_to_state_dict."""
    sd = model.state_dict() if state_dict is None else state_dict
    return _state_dict_to_flax(sd, yolo_key_map(model), None)


# reference LPIPS (PerceptualSimilarity, alexnet) module names -> the port's
# LPIPS: the map of tools/convert_torch_weights.py::LPIPS_ALEX_MAP composed
# with the JAX package's load_lpips_params names
LPIPS_REFERENCE_MAP = {
    "net.slice1.0": "alex.conv1", "net.slice2.3": "alex.conv2",
    "net.slice3.6": "alex.conv3", "net.slice4.8": "alex.conv4",
    "net.slice5.10": "alex.conv5",
    "lin0.model.1": "lin0", "lin1.model.1": "lin1", "lin2.model.1": "lin2",
    "lin3.model.1": "lin3", "lin4.model.1": "lin4",
}


def _lpips_check(out: dict[str, torch.Tensor], model) -> dict[str, torch.Tensor]:
    want = model.state_dict()
    if set(out) != set(want):
        raise KeyError(f"LPIPS keys differ: missing {sorted(set(want) - set(out))}"
                       f", extra {sorted(set(out) - set(want))}")
    for k, v in out.items():
        if tuple(v.shape) != tuple(want[k].shape):
            raise ValueError(f"{k}: shape {tuple(v.shape)} != "
                             f"{tuple(want[k].shape)}")
    return out


def lpips_flax_to_state_dict(params: Mapping, model) -> dict[str, torch.Tensor]:
    """params: the JAX LPIPS's `params` ({'alex': {'conv<i>': {'kernel',
    'bias'}}, 'lin<i>': (C,)}). Returns a state_dict that the port's LPIPS
    takes with strict=True."""
    flat = _flatten(params)
    out = {}
    for k, a in flat.items():
        if k.startswith("alex."):
            mod, leaf = k.rsplit(".", 1)
            tk = f"{mod}.{'weight' if leaf == 'kernel' else 'bias'}"
            a = _to_torch_layout(a, "conv", None)
        else:
            tk = k
        out[tk] = torch.from_numpy(np.array(a, dtype=np.float32))
    return _lpips_check(out, model)


def lpips_reference_to_state_dict(src: Mapping, model) -> dict[str, torch.Tensor]:
    """src: a reference PerceptualSimilarity alexnet state dict (names
    'net.slice1.0.weight', 'lin0.model.1.weight' of shape (1, C, 1, 1), ...;
    tensors or arrays). Returns a state_dict that the port's LPIPS takes
    with strict=True."""
    out = {}
    for rk, tk in LPIPS_REFERENCE_MAP.items():
        w = torch.as_tensor(np.asarray(src[f"{rk}.weight"]), dtype=torch.float32)
        if tk.startswith("lin"):
            out[tk] = w.reshape(-1)
        else:
            out[f"{tk}.weight"] = w
            out[f"{tk}.bias"] = torch.as_tensor(np.asarray(src[f"{rk}.bias"]),
                                                dtype=torch.float32)
    return _lpips_check(out, model)
