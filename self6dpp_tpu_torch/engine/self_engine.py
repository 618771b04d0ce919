"""Stage-II self-supervised pose-mode train step (port of
self6dpp_tpu/engine/self_engine.py: roi_zoom_K, render_student_pose,
select_pseudo_pose, make_self_train_step; and
bench.py::build_stage2, the configuration the step is measured at).

One step: student forward (BN frozen) and EMA-teacher forward (no grad),
in the configured compute dtype; the teacher's pseudo mask and pose;
differentiable render of the student pose in the ROI frame (fine stage B1
forward, B2 backward); the pose-mode loss suite (LAB through B3 or a given
lab_linear, LPIPS in float32, MS-SSIM, depth chamfer); backward; Ranger;
EMA update. The JAX package jits it into one XLA program; here it runs
eagerly.

Not ported here: the in-step DeepIM refiner, RepjRefiner, textured meshes
and the vf/norm pseudo labels (each raises when the configuration or the
batch asks for it); the JAX step's ema_update_every and emit_render
arguments and its extra_grads input (the teacher follows the student every
step); and the side programs that feed split_lab (make_lab_grad_fn,
make_lab_fwd_fn, make_lab_pixel_fn).
"""

from __future__ import annotations

import dataclasses
from collections.abc import Callable

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..config import Config, SelfSupConfig, stage2_pose_flagship
from ..data.meshes import make_icosphere
from ..data.synthetic import make_gdrn_batch
from ..losses.mask_losses import get_mask_prob
from ..losses.self_loss import check_supported, compute_self_loss_pose
from ..models.gdrn import GDRN
from ..models.lpips import LPIPS, build_lpips
from ..ops.rasterizer import rasterize_batch
from ..ops.zoom import zoom_K
from .deepim_engine import to_device
from .gdrn_engine import build_gdrn, init_state, model_inputs
from .train_state import TrainState, ema_decay_schedule

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def roi_zoom_K(batch: dict[str, Tensor], input_res: int,
               output_res: int = 64) -> Tensor:
    """Intrinsics of the ROI frame: the square crop of side output_res /
    resize_ratio around roi_center, resized to input_res."""
    side = output_res / batch["resize_ratio"]
    x1 = batch["roi_center"][:, 0] - side / 2
    y1 = batch["roi_center"][:, 1] - side / 2
    boxes = torch.stack([x1, y1, x1 + side, y1 + side], dim=1)
    return zoom_K(batch["roi_cam"], boxes, (input_res, input_res))


def render_student_pose(cfg: Config, batch: dict[str, Tensor], rot: Tensor,
                        trans: Tensor, soft_sigma: float = 1.5,
                        impl: str = "kernel") -> dict[str, Tensor]:
    """Differentiable ROI-frame render of the predicted pose with the soft
    silhouette. batch: mesh_verts (C,V,3), mesh_faces (C,F,3), mesh_colors
    (C,V,3) per class, gathered by roi_cls; roi_zoom_K (B,3,3)."""
    if "mesh_uv" in batch and "mesh_texture" in batch:
        raise ValueError("textured meshes belong to a later slice of the port")
    s = cfg.model.input_res
    cls = batch["roi_cls"].long()
    out = rasterize_batch(
        batch["mesh_verts"][cls], batch["mesh_faces"][cls],
        batch["mesh_colors"][cls], batch["roi_zoom_K"], rot, trans,
        height=s, width=s, tile_px=cfg.renderer.tile_px,
        faces_per_tile=cfg.renderer.faces_per_tile, sigma_px=soft_sigma,
        impl=impl, device=rot.device)
    return {"color": out.attr, "prob": out.prob, "mask": out.mask,
            "depth": out.depth}


def select_pseudo_pose(ss: SelfSupConfig, batch: dict[str, Tensor],
                       tout: dict[str, Tensor]) -> tuple[Tensor, Tensor]:
    """The loaded refined or estimated pose when present, else the
    teacher's predicted pose; never ground truth."""
    if ss.pseudo_pose_type == "pose_refine" and "pseudo_rot" in batch:
        return batch["pseudo_rot"], batch["pseudo_trans"]
    if ss.pseudo_pose_type == "pose_est" and "pose_est_rot" in batch:
        return batch["pose_est_rot"], batch["pose_est_trans"]
    if "rot" not in tout:
        raise ValueError("the teacher must run a pose forward when no pseudo "
                         "pose is loaded")
    return tout["rot"], tout["trans"]


def _no_mark(name: str) -> None:
    pass


def event_marker(marks: list) -> Callable[[str], None]:
    """mark(name) appends (name, a recorded CUDA event) to `marks`: the
    phases of a step on the card's clock, read after a synchronize."""
    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))
    return mark


def forward_losses(cfg: Config, state: TrainState, batch: dict[str, Tensor],
                   impl: str = "kernel", mark=_no_mark,
                   lpips: LPIPS | None = None, split_lab: bool = False,
                   lab_linear: tuple | None = None):
    """The forward half of the pose-mode step: student forward (with
    gradients), teacher forward (without), the teacher's pseudo mask and
    pose, the differentiable render of the student pose and the loss
    suite (LPIPS when given; with split_lab, LAB's weight at 0 and its term
    from lab_linear alone). Returns (losses, render, pseudo labels).
    mark(name) is called after each phase (see event_marker)."""
    ss = cfg.self_sup
    ss_loss = dataclasses.replace(ss, lab_lw=0.0) if split_lab else ss
    dtype = _DTYPES[cfg.dist.compute_dtype]
    s, o = cfg.model.input_res, cfg.model.output_res
    dev = next(state.model.parameters()).device
    inputs = model_inputs(batch)
    autocast = lambda: torch.autocast(dev.type, dtype=dtype,
                                      enabled=dtype != torch.float32)
    with autocast():
        out = state.model(*inputs)
    out = {k: v.float() for k, v in out.items()}
    mark("student_fwd")
    with autocast(), torch.no_grad():
        tout = state.teacher(*inputs)
    tout = {k: v.float() for k, v in tout.items()}
    mark("teacher_fwd")

    t_vis_prob = get_mask_prob(tout["mask_logits"],
                               cfg.model.loss.mask_loss_type)[..., 0]
    pseudo_vis_lr = (t_vis_prob > 0.5).float()
    # nearest upsampling at an integer factor is a plain repeat
    pseudo_vis = pseudo_vis_lr.repeat_interleave(s // o, 1) \
                              .repeat_interleave(s // o, 2)
    p_rot, p_trans = select_pseudo_pose(ss, batch, tout)
    pseudo = {"vis_mask": pseudo_vis, "vis_mask_lr": pseudo_vis_lr,
              "coor": tout["coor"],
              "region": torch.softmax(tout["region_logits"], dim=-1),
              "rot": p_rot.detach(), "trans": p_trans.detach()}

    ren = render_student_pose(cfg, batch, out["rot"], out["trans"],
                              impl=impl)
    mark("render_fwd")
    ld = compute_self_loss_pose(ss_loss, ren, out, pseudo, batch,
                                lpips_fn=lpips, lab_linear=lab_linear,
                                impl=impl)
    mark("losses")
    return ld, ren, pseudo


def make_self_train_step(cfg: Config, model: GDRN, lpips: LPIPS | None = None,
                         split_lab: bool = False, impl: str = "kernel"):
    """Returns train_step(state, batch, mark=None, lab_linear=None) ->
    (state, metrics): one pose-mode step, updating the state in place.
    lpips: a frozen LPIPS (build_lpips), or None to leave the perceptual
    term out, as the JAX step does without lpips_params. split_lab: LAB's
    weight at 0 in the loss; its value and image gradient come, if at all,
    as lab_linear = (value, g (B,S,S,3)), g added to the masked render's
    cotangent. impl 'kernel' runs B1-B3 on CUDA tensors (their plain
    versions on CPU tensors); 'plain' runs the plain versions on any device
    (the control runs of chip_smoke.py). metrics holds every loss term and
    total_loss, as 0-d tensors. mark, if given, is called after each phase
    of the step (see event_marker)."""
    ss = cfg.self_sup
    if ss.refine_with_deepim or ss.repj_refine:
        raise ValueError("refine_with_deepim and repj_refine belong to a "
                         "later slice of the port")
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl: {impl!r}")
    check_supported(ss)
    decay_fn = ema_decay_schedule(ss.ema_decay, cfg.solver.ema_warmup_iters)
    s, o = cfg.model.input_res, cfg.model.output_res
    if s % o:
        raise ValueError(f"input_res {s} is not a multiple of output_res {o}")

    def train_step(state: TrainState, batch: dict[str, Tensor], mark=None,
                   lab_linear=None):
        mark = mark or _no_mark
        ld, _, _ = forward_losses(cfg, state, batch, impl, mark, lpips,
                                  split_lab, lab_linear)
        total = sum(ld[k] for k in sorted(ld))     # jax.tree.leaves order
        state.opt.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        state.opt.step()
        state.step += 1
        state.update_ema(decay_fn)
        mark("ranger_ema")
        metrics = {k: v.detach() for k, v in ld.items()}
        metrics["total_loss"] = total.detach()
        return state, metrics

    return train_step


def stage2_batch(cfg: Config, batch_size: int, device, seed: int = 0,
                 mesh=None) -> dict[str, Tensor]:
    """The benchmark batch of bench.py::build_stage2: make_gdrn_batch, one
    mesh per class (default the 1280-face icosphere of radius 0.06 with
    colours from the normalised vertex positions), the ROI intrinsics and
    a constant depth map. No pseudo pose is loaded, so the step takes the
    teacher's."""
    batch = make_gdrn_batch(cfg, batch_size, seed=seed)
    verts, faces = mesh if mesh is not None else make_icosphere(0.06, 3)
    colors = (verts - verts.min(0)) / np.ptp(verts, 0)
    C = cfg.model.num_classes
    batch["mesh_verts"] = np.repeat(verts[None], C, 0)
    batch["mesh_faces"] = np.repeat(faces[None], C, 0)
    batch["mesh_colors"] = np.repeat(colors[None].astype(np.float32), C, 0)
    b = to_device(batch, device)
    b["roi_zoom_K"] = roi_zoom_K(b, cfg.model.input_res, cfg.model.output_res)
    b["roi_depth"] = torch.ones((batch_size, cfg.model.input_res,
                                 cfg.model.input_res), device=b["roi_img"].device
                                ) * b["gt_trans"][:, 2, None, None]
    return b


@torch.no_grad()
def aim_heads_(model: GDRN, batch: dict[str, Tensor]) -> None:
    """Bias the network's first outputs toward a usable stage-II start: an
    identity allocentric rotation, the batch's median relative depth (so
    the rendered mesh is in view) and a mask logit of 10 (the teacher's
    pseudo mask then covers the ROI). Under the JAX package's
    initialisation the predicted depth is about 0 and the render empty."""
    if model.cfg.pnp_net.rot_type != "allo_rot6d" or \
            model.cfg.pnp_net.z_type != "REL":
        raise ValueError("aim_heads_ takes allo_rot6d with a REL depth")
    pn = model.pnp_net
    pn.fc_r.bias.copy_(torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0]))
    z_rel = (batch["gt_trans"][:, 2] / batch["resize_ratio"]).median()
    pn.fc_t.bias.zero_()
    pn.fc_t.bias[2] = z_rel
    model.geo_head_net.out_layer.bias[0] = 10.0


def build_stage2(cfg: Config | None = None, batch_size: int = 8, device=None,
                 seed: int = 0
                 ) -> tuple[GDRN, TrainState, dict[str, Tensor], LPIPS]:
    """The stage-II configuration the step is measured at (mirrors
    bench.py::build_stage2 with dense=False): (model, state, batch, lpips)
    on `device` (CUDA by default), weights drawn from `seed` as the JAX
    package initialises them, then aimed by aim_heads_ before the teacher
    and the optimizer copy them, so that the measured step renders the
    mesh (bench.py's render is empty at its initialisation); the frozen
    LPIPS drawn from seed + 1 (bench.py's PRNGKey(1) beside the model's 0).
    cfg defaults to stage2_pose_flagship()."""
    cfg = cfg if cfg is not None else stage2_pose_flagship()
    dev = resolve_device(device)
    model = build_gdrn(cfg, device=dev, seed=seed)
    batch = stage2_batch(cfg, batch_size, dev, seed=seed)
    aim_heads_(model, batch)
    return model, init_state(cfg, model), batch, build_lpips(dev, seed + 1)
