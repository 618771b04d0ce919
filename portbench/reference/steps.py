"""The reference's steps: frozen copies of the port's stage-II pose step
(engine/self_engine.py: student_teacher, pseudo_visibility,
render_student_pose, forward_losses), its stage-I step
(engine/gdrn_engine.py: make_train_step, descend) and its DeepIM refine
loop (engine/deepim_engine.py: _render_inputs, make_refine_fn), on the
frozen models, losses, plain rasterizer and solver of this folder.

They run in float32 with TF32 off (`plain_float32`). What differs from the
port's paths, none of which changes the function computed: the LAB term is
autograd of lab_loss (the port's 'direct' mode) instead of kernel B3's
injected gradient; the fine raster stage is the plain version and its plain
backward; the student render runs in blocks of ROIs (each ROI's render is
its own); the student backbone may be checkpointed stage by stage
(batch norm is frozen in stage II, so the recompute is exact).
The control that the benchmark's limits are set against is the reference
one precision below the configured bfloat16: the networks in bfloat16
(`low=torch.bfloat16`: GDR-Net under autocast, DeepIM built in bfloat16,
as the port runs them) with every convolution and dense layer on float8
(e4m3) inputs (`fp8_matmuls`).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch
import torch.nn.functional as Fnn
from torch import Tensor
from torch.utils.checkpoint import checkpoint

from .config import Config
from .engine.optim import build_optimizer
from .engine.train_state import (TrainState, create_train_state,
                                 ema_decay_schedule, gated_ema_decay)
from .losses.gdrn_loss import gdrn_loss
from .losses.mask_losses import get_mask_prob
from .losses.self_loss import compute_self_loss_pose
from .models.deepim import DeepIM
from .models.gdrn import GDRN
from .models.lpips import LPIPS
from .ops.rasterizer import RasterOut, rasterize_batch
from .ops.zoom import (bboxes_from_pose, centers_2d_from_pose, crop_resize,
                       deepim_boxes, zoom_K)

MODEL_KEYS = ("roi_img", "roi_cls", "roi_cam", "roi_center", "roi_wh",
              "roi_extent", "resize_ratio", "roi_coord_2d")


@contextlib.contextmanager
def plain_float32():
    """float32 matrix products and convolutions without TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def to_fp8(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (its largest
    magnitude at e4m3's largest finite value, 448), back in x's dtype."""
    s = (x.detach().abs().amax().float() / 448.0).clamp_min(1e-30)
    return ((x / s).to(torch.float8_e4m3fn).to(x.dtype)) * s


class _RoundFp8(torch.autograd.Function):
    """to_fp8 forward, straight-through backward (the gradient of a float8
    training step's cast)."""

    @staticmethod
    def forward(ctx, x):
        return to_fp8(x)

    @staticmethod
    def backward(ctx, g):
        return g


@contextlib.contextmanager
def fp8_matmuls():
    """Every conv2d, conv_transpose2d and linear of the process computed on
    float8 (e4m3) inputs and weights, accumulated in float32: the reference
    one precision below bfloat16. Patches torch.nn.functional while active."""
    names = ("conv2d", "conv_transpose2d", "linear")
    saved = {n: getattr(Fnn, n) for n in names}

    def wrap(fn):
        def rounded(x, w, *args, **kw):
            return fn(_RoundFp8.apply(x), _RoundFp8.apply(w), *args, **kw)
        return rounded
    for n in names:
        setattr(Fnn, n, wrap(saved[n]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(Fnn, n, fn)


# -- GDR-Net --------------------------------------------------------------

def build_gdrn(cfg: Config, device) -> GDRN:
    with torch.device(device):
        return GDRN(cfg.model).eval()


def build_state(cfg: Config, model: torch.nn.Module) -> TrainState:
    return create_train_state(model, build_optimizer(cfg.solver,
                                                     model.parameters()),
                              with_ema=cfg.solver.ema_decay > 0)


def build_lpips(device) -> LPIPS:
    with torch.device(device):
        return LPIPS().eval().requires_grad_(False)


def _inputs(batch):
    return tuple(batch[k] for k in MODEL_KEYS)


def _checkpointed_backbone(backbone):
    """backbone.forward with each of its four stages checkpointed."""
    def forward(x):
        x = backbone.maxpool(Fnn.relu(backbone.bn1(backbone.conv1(x))))
        outs = []
        for s in range(1, 5):
            x = checkpoint(getattr(backbone, f"layer{s}"), x,
                           use_reentrant=False)
            if s in backbone.out_indices:
                outs.append(x)
        return outs if len(outs) > 1 else outs[0]
    return forward


def render_student_pose(cfg: Config, batch, rot, trans, block: int,
                        soft_sigma: float = 1.5) -> dict[str, Tensor]:
    """The port's render_student_pose (untextured) in blocks of `block`
    ROIs."""
    s = cfg.model.input_res
    cls = batch["roi_cls"].long()
    parts = []
    for i in range(0, rot.shape[0], block):
        sl = slice(i, i + block)
        parts.append(rasterize_batch(
            batch["mesh_verts"][cls[sl]], batch["mesh_faces"][cls[sl]],
            batch["mesh_colors"][cls[sl]], batch["roi_zoom_K"][sl], rot[sl],
            trans[sl], height=s, width=s, tile_px=cfg.renderer.tile_px,
            faces_per_tile=cfg.renderer.faces_per_tile, sigma_px=soft_sigma,
            impl="plain", device=rot.device))
    out = RasterOut(*(torch.cat(x) for x in zip(*parts)))
    return {"color": out.attr, "prob": out.prob, "mask": out.mask,
            "depth": out.depth}


def _descend(state: TrainState, ld: dict[str, Tensor], decay_fn):
    total = sum(ld[k] for k in sorted(ld))
    state.opt.zero_grad(set_to_none=True)
    total.backward()
    state.opt.step()
    state.step += 1
    state.update_ema(decay_fn)
    metrics = {k: v.detach() for k, v in ld.items()}
    metrics["total_loss"] = total.detach()
    return metrics


def _forward(net, batch, low):
    """The network's outputs in float32; its forward under `low`'s autocast
    when given (the control)."""
    dev = batch["roi_img"].device
    with torch.autocast(dev.type, dtype=low or torch.float32,
                        enabled=low is not None):
        out = net(*_inputs(batch))
    return {k: v.float() for k, v in out.items()}


def make_self_train_step(cfg: Config, lpips: LPIPS | None, block: int = 16,
                         checkpoint_backbone: bool = True, low=None):
    """step(state, batch) -> metrics: one stage-II pose step (the teacher's
    pseudo mask and pose, no loaded pseudo pose, no refiner, no vf/norm)
    in float32 on the reference's modules (the networks under `low`'s
    autocast when given). cfg must be float32 with self_sup.lab_impl
    'direct'."""
    ss = cfg.self_sup
    if cfg.dist.compute_dtype != "float32" or ss.lab_impl != "direct":
        raise ValueError("the reference step runs float32 with direct LAB")
    decay_fn = gated_ema_decay(ss.ema_decay, cfg.solver.ema_warmup_iters, 1)
    s, o = cfg.model.input_res, cfg.model.output_res

    def step(state: TrainState, batch: dict[str, Tensor]):
        net = state.model.eval()
        bb = net.backbone
        if checkpoint_backbone:
            bb.forward = _checkpointed_backbone(bb)
        try:
            out = _forward(net, batch, low)
        finally:
            bb.__dict__.pop("forward", None)
        with torch.no_grad():
            tout = _forward(state.teacher, batch, low)
        prob = get_mask_prob(tout["mask_logits"],
                             cfg.model.loss.mask_loss_type)[..., 0]
        vis_lr = (prob > 0.5).float()
        vis = vis_lr.repeat_interleave(s // o, 1).repeat_interleave(s // o, 2)
        pseudo = {"vis_mask": vis, "vis_mask_lr": vis_lr,
                  "coor": tout["coor"],
                  "region": torch.softmax(tout["region_logits"], dim=-1),
                  "rot": tout["rot"].detach(), "trans": tout["trans"].detach()}
        ren = render_student_pose(cfg, batch, out["rot"], out["trans"], block)
        ld = compute_self_loss_pose(ss, ren, out, pseudo, batch,
                                    lpips_fn=lpips, impl="plain")
        return _descend(state, ld, decay_fn)

    return step


def make_stage1_train_step(cfg: Config, low=None):
    """step(state, batch) -> metrics: one stage-I step (batch norm in train
    mode, the GDR-Net loss, no MTL weighting, no DropBlock) in float32 (the
    network under `low`'s autocast when given)."""
    if cfg.dist.compute_dtype != "float32":
        raise ValueError("the reference step runs float32")
    decay_fn = ema_decay_schedule(cfg.solver.ema_decay,
                                  cfg.solver.ema_warmup_iters)
    gh = cfg.model.geo_head

    def step(state: TrainState, batch: dict[str, Tensor]):
        out = _forward(state.model.train(), batch, low)
        ld = gdrn_loss(cfg.model.loss, cfg.model.pnp_net, out, batch,
                       num_regions=gh.num_regions, xyz_bin=gh.xyz_bin)
        return _descend(state, ld, decay_fn)

    return step


# -- DeepIM ---------------------------------------------------------------

def build_deepim(cfg: Config, device, dtype=torch.float32) -> DeepIM:
    with torch.device(device):
        return DeepIM(cfg.deepim, dtype=dtype).eval()


@torch.no_grad()
def refine(cfg: Config, model: DeepIM, batch: dict[str, Tensor]
           ) -> tuple[Tensor, Tensor]:
    """The port's make_eval_step: n_iter_test iterations of render (hard,
    plain fine stage), zoom and network from batch's init pose, float32."""
    d = cfg.deepim
    h, w = d.input_h, d.input_w
    rkw = dict(tile_px=cfg.renderer.tile_px,
               faces_per_tile=cfg.renderer.faces_per_tile, sigma_px=1.0,
               with_prob=False, impl="plain")
    rot, trans = batch["init_rot"], batch["init_trans"]
    K, verts = batch["K"], batch["verts"]
    for _ in range(d.n_iter_test):
        crop, _ = deepim_boxes(bboxes_from_pose(verts, K, rot, trans),
                               centers_2d_from_pose(K, rot, trans),
                               obs_boxes=batch.get("obs_box"),
                               lamb=d.zoom_lamb, out_hw=(h, w))
        Kz = zoom_K(K, crop, (h, w))
        ren = rasterize_batch(verts, batch["faces"], batch["colors"], Kz,
                              rot, trans, height=h, width=w,
                              device=rot.device, **rkw)
        x = torch.cat([ren.attr[..., :3],
                       crop_resize(batch["obs_img"], crop, h, w)], dim=-1)
        out = model(x, rot, trans, Kz, obj_class=batch.get("roi_cls"))
        rot, trans = out["rot"], out["trans"]
    return rot, trans


def render_observations(cfg: Config, batch: dict[str, Tensor],
                        frame_hw: tuple[int, int]) -> RasterOut:
    """The meshes rendered hard at their ground-truth poses in the full
    frame (the requests' observed images)."""
    return rasterize_batch(batch["verts"], batch["faces"], batch["colors"],
                           batch["K"], batch["gt_rot"], batch["gt_trans"],
                           height=frame_hw[0], width=frame_hw[1],
                           tile_px=cfg.renderer.tile_px,
                           faces_per_tile=cfg.renderer.faces_per_tile,
                           with_prob=False, impl="plain",
                           device=batch["K"].device)


def float32_config(cfg: Config) -> Config:
    """cfg computing in float32, with the LAB term by autograd."""
    return dataclasses.replace(
        cfg, dist=dataclasses.replace(cfg.dist, compute_dtype="float32"),
        self_sup=dataclasses.replace(cfg.self_sup, lab_impl="direct"))
