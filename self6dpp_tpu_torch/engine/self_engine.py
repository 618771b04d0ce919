"""Stage-II self-supervised train steps (port of
self6dpp_tpu/engine/self_engine.py: roi_zoom_K, render_student_pose,
gated_ema_decay, make_mode_picker, select_pseudo_pose,
make_self_train_step, make_self_geo_train_step, make_synsup_train_step;
and bench.py::build_stage2, the configuration the pose step is measured
at).

The pose step: student forward (BN frozen) and EMA-teacher forward (no
grad), in the configured compute dtype; the teacher's pseudo mask and
pose; with vf/norm heads, the pseudo pose's keypoint vector field and its
camera-frame normals rendered at output resolution (kernel B1, no
silhouette); differentiable render of the student pose in the ROI frame
(fine stage B1 forward, B2 backward); the pose-mode loss suite (LAB
through B3 or a given lab_linear, LPIPS in float32, MS-SSIM, depth
chamfer, vf, norm); with refine_with_deepim the pseudo pose refined by a
DeepIM refiner (its renders through B1) before the labels, with
repj_refine the RepjRefiner weak loss on the student's pose (renders at
64² through B1 and B2); backward; the solver; EMA update. The geo step trains
the student's dense maps on a pose-variated warp of its input toward the
teacher's maps warped alike (no render, no kernel); the synsup step is the
stage-I loss on a synthetic batch with BN frozen. The JAX package jits
each into one XLA program; here they run eagerly and update the state in
place. The geo step's random draws (warp matrices, colour gain, shift and
noise) come from draw_geo_aug, a torch.Generator's, and the step takes
them as an argument.

Textured models (YCB-V) render their UVs and sample the class atlas
(render_student_pose). The LAB term runs in the mode cfg.self_sup.lab_impl
names, each routed by build_self_train_step as the JAX package's
jit_self_train_step routes it: 'pallas' (kernel B3), 'direct' (autograd
of lab_loss), 'surrogate' (ops/color.py::lab_loss_surrogate), 'split_grad'
(make_lab_grad_fn's parameter gradient, added to the step's through
extra_grads) and 'pixel_split' (make_lab_fwd_fn's render and mask,
make_lab_pixel_fn's value and image gradient, fed to the step as
lab_linear). All five give the value and gradient of 'direct'; the JAX
package keeps the three extra ones to dodge an XLA fusion cliff, which
eager PyTorch does not have: the port keeps them only so that a config
naming one runs as it does in JAX. Not ported: the JAX pose step's emit_render
argument and its refiner_vars input (the port's refiner is a module
whose weights the caller sets).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..config import Config, SelfSupConfig, stage2_pose_flagship
from ..data.meshes import make_icosphere
from ..data.synthetic import make_gdrn_batch
from ..losses.gdrn_loss import gdrn_loss
from ..losses.mask_losses import get_mask_prob
from ..losses.self_loss import (check_supported, compute_self_loss_geo,
                                compute_self_loss_pose)
from ..models.deepim import DeepIM
from ..models.gdrn import GDRN
from ..models.lpips import LPIPS, build_lpips
from ..models.repj_refiner import repj_weak_loss
from ..ops.color import lab_loss
from ..ops.fps import fps_points
from ..ops.geometry import compute_vf
from ..ops.rasterizer import (compute_vertex_normals, rasterize_batch,
                              sample_texture)
from ..ops.warp import affine_warp, sample_pose_variated_affines
from ..ops.zoom import zoom_K
from ..utils.profiling import span
from .deepim_engine import make_refine_fn, to_device
from .gdrn_engine import (autocast, build_gdrn, descend, dropout_generator,
                          init_state, model_inputs, no_mark)
from .train_state import TrainState, gated_ema_decay

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
    (C,V,3) per class, gathered by roi_cls; roi_zoom_K (B,3,3). Textured
    models (YCB-V: mesh_uv (C,V,2) and mesh_texture (C,Ht,Wt,3) in the
    batch) rasterise their UVs as the attributes (kernels B1/B2 at D = 2)
    and sample the class atlas at them, the colour masked ('uv' holds the
    rasterised UVs); its gradient flows through the sample into the UVs'
    cotangent."""
    s = cfg.model.input_res
    cls = batch["roi_cls"].long()
    textured = "mesh_uv" in batch and "mesh_texture" in batch
    attrs = batch["mesh_uv" if textured else "mesh_colors"][cls]
    out = rasterize_batch(
        batch["mesh_verts"][cls], batch["mesh_faces"][cls], attrs,
        batch["roi_zoom_K"], rot, trans,
        height=s, width=s, tile_px=cfg.renderer.tile_px,
        faces_per_tile=cfg.renderer.faces_per_tile, sigma_px=soft_sigma,
        impl=impl, device=rot.device)
    ren = {"color": out.attr, "prob": out.prob, "mask": out.mask,
           "depth": out.depth}
    if textured:
        ren["uv"] = out.attr
        ren["color"] = sample_texture(
            batch["mesh_texture"], out.attr[..., 0], out.attr[..., 1],
            cls) * out.mask[..., None]
    return ren


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


def student_teacher(cfg: Config, state: TrainState, batch: dict[str, Tensor],
                    mark=no_mark, forward_mode: str = "all",
                    student_batch: dict[str, Tensor] | None = None):
    """Student forward (BN frozen, with gradients; on student_batch if
    given) and teacher forward (without), in the compute dtype, outputs in
    float32."""
    dev = next(state.model.parameters()).device
    net = state.model.eval()
    with span("student_fwd"):
        with autocast(cfg, dev):
            out = net(*model_inputs(student_batch or batch),
                      forward_mode=forward_mode,
                      generator=dropout_generator(cfg, state.step, dev))
        out = {k: v.float() for k, v in out.items()}
    mark("student_fwd")
    with span("teacher_fwd"):
        with autocast(cfg, dev), torch.no_grad():
            tout = state.teacher(*model_inputs(batch),
                                 forward_mode=forward_mode)
        tout = {k: v.float() for k, v in tout.items()}
    mark("teacher_fwd")
    return out, tout


def pseudo_visibility(cfg: Config, tout: dict[str, Tensor]
                      ) -> tuple[Tensor, Tensor]:
    """The teacher's pseudo visibility mask, its mask probability above
    0.5: at output_res (B,o,o) and at input_res (B,S,S)."""
    s, o = cfg.model.input_res, cfg.model.output_res
    prob = get_mask_prob(tout["mask_logits"],
                         cfg.model.loss.mask_loss_type)[..., 0]
    vis_lr = (prob > 0.5).float()
    # nearest upsampling at an integer factor is a plain repeat
    return vis_lr, vis_lr.repeat_interleave(s // o, 1) \
                         .repeat_interleave(s // o, 2)


def normal_render_args(cfg: Config, batch: dict[str, Tensor], rot: Tensor,
                       trans: Tensor) -> tuple[tuple, dict]:
    """rasterize_batch's (args, kwargs) for the normal-map pseudo label at
    the pose (rot, trans): the camera-frame normals n_cam = R n of each
    ROI's mesh as the attributes, the ROI intrinsics scaled by output_res /
    input_res, an output_res² image in tiles of min(tile_px, output_res),
    no silhouette."""
    o, s = cfg.model.output_res, cfg.model.input_res
    cls = batch["roi_cls"].long()
    n_cam = torch.einsum("bij,bvj->bvi", rot, batch["mesh_normals"][cls])
    ratio = o / s
    S = torch.tensor([[ratio, 0, 0], [0, ratio, 0], [0, 0, 1.0]],
                     device=rot.device)
    Ko = torch.einsum("ij,bjk->bik", S, batch["roi_zoom_K"])
    args = (batch["mesh_verts"][cls], batch["mesh_faces"][cls], n_cam, Ko,
            rot, trans)
    kw = dict(height=o, width=o, tile_px=min(cfg.renderer.tile_px, o),
              faces_per_tile=cfg.renderer.faces_per_tile, with_prob=False)
    return args, kw


@torch.no_grad()
def render_pseudo_normals(cfg: Config, batch: dict[str, Tensor], rot: Tensor,
                          trans: Tensor, impl: str = "kernel") -> Tensor:
    """The normals of normal_render_args rendered (kernel B1 on the card),
    normalised and zero off the mesh: (B, o, o, 3)."""
    args, kw = normal_render_args(cfg, batch, rot, trans)
    ren = rasterize_batch(*args, **kw, impl=impl, device=rot.device)
    nrm = ren.attr / torch.linalg.vector_norm(ren.attr, dim=-1,
                                              keepdim=True).clamp_min(1e-8)
    return nrm * ren.mask[..., None]


def vf_norm_labels(cfg: Config, batch: dict[str, Tensor],
                   out: dict[str, Tensor], rot: Tensor, trans: Tensor,
                   impl: str = "kernel") -> dict[str, Tensor]:
    """The pose step's vf and norm pseudo labels at the (stop-gradient)
    pseudo pose, for the heads the student has and the terms weighted:
    vf = [vis | full] = [v, v] with v the keypoint vector field of the
    batch's mesh_fps; norm = render_pseudo_normals."""
    ss, o = cfg.self_sup, cfg.model.output_res
    cls = batch["roi_cls"].long()
    labels = {}
    if ss.vf_lw > 0 and "vf" in out and "mesh_fps" in batch:
        f = cfg.model.geo_head.num_vf_points
        vf = compute_vf(batch["mesh_fps"][cls][:, :f], batch["roi_cam"], rot,
                        trans, batch["roi_center"], o / batch["resize_ratio"],
                        o)
        labels["vf"] = torch.cat([vf, vf], dim=-1)
    if ss.norm_lw > 0 and "norm" in out and "mesh_normals" in batch:
        with span("normal_render"):
            labels["norm"] = render_pseudo_normals(cfg, batch, rot, trans,
                                                   impl)
    return labels


def refiner_batch(batch: dict[str, Tensor], obs_mask: Tensor
                  ) -> dict[str, Tensor]:
    """The DeepIM refiner's batch in the ROI frame: roi_img observed with
    the ROI intrinsics (roi_zoom_K), each ROI's class mesh, the pseudo
    mask as the observed mask."""
    cls = batch["roi_cls"].long()
    return {"obs_img": batch["roi_img"], "K": batch["roi_zoom_K"],
            "verts": batch["mesh_verts"][cls], "faces": batch["mesh_faces"][cls],
            "colors": batch["mesh_colors"][cls], "roi_cls": batch["roi_cls"],
            "obs_mask": obs_mask}


def repj_terms(cfg: Config, batch: dict[str, Tensor], out: dict[str, Tensor],
               impl: str = "kernel") -> dict[str, Tensor]:
    """The RepjRefiner weak loss (models/repj_refiner.py::repj_weak_loss)
    on the student's pose, with its visible (and, from a second mask
    channel, full) mask probabilities, the ROIs' class meshes and full-frame
    intrinsics, at the configured weights and render size. A batch's
    "repj_best" (1,) pins the best view (repj_refiner.repj_inputs)."""
    ss = cfg.self_sup
    mask_type = cfg.model.loss.mask_loss_type
    logits = out["mask_logits"]
    vis_prob = get_mask_prob(logits[..., :1], mask_type)[..., 0]
    full_prob = (get_mask_prob(logits[..., 1:2], mask_type)[..., 0]
                 if logits.shape[-1] >= 2 else vis_prob)
    cls = batch["roi_cls"].long()
    return repj_weak_loss(
        out["rot"], out["trans"], vis_prob, full_prob, batch["gt_rot"],
        batch["gt_trans"], batch["mesh_verts"][cls], batch["mesh_faces"][cls],
        batch["mesh_colors"][cls], batch["roi_cam"], batch["gt_points"],
        batch["roi_extent"], sym_rots=batch.get("sym_rots"),
        sym_valid=batch.get("sym_valid"), render_res=ss.repj_render_res,
        full_hw=(cfg.renderer.height, cfg.renderer.width),
        w_iou2d3d=ss.repj_iou2d3d_lw, w_pm=ss.repj_pm_lw,
        w_miou=ss.repj_miou_lw, w_msssim=ss.repj_msssim_lw,
        raster_kw={"impl": impl}, best=batch.get("repj_best"))


def forward_losses(cfg: Config, state: TrainState, batch: dict[str, Tensor],
                   impl: str = "kernel", mark=no_mark,
                   lpips: LPIPS | None = None, split_lab: bool = False,
                   lab_linear: tuple | None = None, refine=None):
    """The forward half of the pose-mode step: student forward (with
    gradients), teacher forward (without), the teacher's pseudo mask and
    pose (refined by `refine`, a DeepIM refine function, when given), the
    differentiable render of the student pose and the loss suite (LPIPS
    when given; with split_lab, LAB's weight at 0 and its term from
    lab_linear alone; the RepjRefiner terms with repj_refine). Returns
    (losses, render, pseudo labels). mark(name) is called after each phase
    (see gdrn_engine.event_marker)."""
    ss = cfg.self_sup
    ss_loss = dataclasses.replace(ss, lab_lw=0.0) if split_lab else ss
    out, tout = student_teacher(cfg, state, batch, mark)
    pseudo_vis_lr, pseudo_vis = pseudo_visibility(cfg, tout)
    p_rot, p_trans = select_pseudo_pose(ss, batch, tout)
    if refine is not None:
        # no_grad, not inference_mode: the refined pose feeds the labels of
        # a step that takes gradients
        with span("refine"), torch.no_grad():
            p_rot, p_trans = refine(refiner_batch(batch, pseudo_vis), p_rot,
                                    p_trans)
        mark("refine")
    pseudo = {"vis_mask": pseudo_vis, "vis_mask_lr": pseudo_vis_lr,
              "coor": tout["coor"],
              "region": torch.softmax(tout["region_logits"], dim=-1),
              "rot": p_rot.detach(), "trans": p_trans.detach()}
    pseudo.update(vf_norm_labels(cfg, batch, out, pseudo["rot"],
                                 pseudo["trans"], impl))
    if "norm" in pseudo:
        mark("normal_render")

    with span("render_fwd"):
        ren = render_student_pose(cfg, batch, out["rot"], out["trans"],
                                  impl=impl)
    mark("render_fwd")
    with span("losses"):
        ld = compute_self_loss_pose(ss_loss, ren, out, pseudo, batch,
                                    lpips_fn=lpips, lab_linear=lab_linear,
                                    impl=impl)
    mark("losses")
    if ss.repj_refine:
        with span("repj"):
            ld.update(repj_terms(cfg, batch, out, impl))
        mark("repj")
    return ld, ren, pseudo


def make_self_train_step(cfg: Config, model: GDRN, lpips: LPIPS | None = None,
                         split_lab: bool = False, impl: str = "kernel",
                         ema_update_every: int = 1,
                         refiner: tuple[DeepIM, Config] | None = None):
    """Returns train_step(state, batch, mark=None, lab_linear=None) ->
    (state, metrics): one pose-mode step, updating the state in place.
    lpips: a frozen LPIPS (build_lpips), or None to leave the perceptual
    term out, as the JAX step does without lpips_params. split_lab: LAB's
    weight at 0 in the loss; its value and image gradient come, if at all,
    as lab_linear = (value, g (B,S,S,3)), g added to the masked render's
    cotangent. impl 'kernel' runs B1-B3 on CUDA tensors (their plain
    versions on CPU tensors); 'plain' runs the plain versions on any device
    (the control runs of chip_smoke.py); the normal render follows impl.
    metrics holds every loss term and total_loss, as 0-d tensors. mark, if
    given, is called after each phase of the step (see
    gdrn_engine.event_marker). The teacher follows the student every
    ema_update_every steps. refiner: (a DeepIM in eval mode, its Config),
    which refines the pseudo pose by its n_iter_test iterations when
    self_sup.refine_with_deepim (its renders follow impl)."""
    ss = cfg.self_sup
    if impl not in ("kernel", "plain"):
        raise ValueError(f"unknown impl: {impl!r}")
    refine = None
    if ss.refine_with_deepim:
        if refiner is None:
            raise ValueError("refine_with_deepim needs the refiner: "
                             "refiner=(DeepIM, its Config)")
        dmodel, rcfg = refiner
        refine = make_refine_fn(rcfg, dmodel.eval(), rcfg.deepim.n_iter_test,
                                raster_kw={"impl": impl})
    check_supported(ss)
    decay_fn = gated_ema_decay(ss.ema_decay, cfg.solver.ema_warmup_iters,
                               ema_update_every)
    s, o = cfg.model.input_res, cfg.model.output_res
    if s % o:
        raise ValueError(f"input_res {s} is not a multiple of output_res {o}")

    def train_step(state: TrainState, batch: dict[str, Tensor], mark=None,
                   lab_linear=None, extra_grads=None):
        mark = mark or no_mark
        with span("train_step", root=True):
            ld, _, _ = forward_losses(cfg, state, batch, impl, mark, lpips,
                                      split_lab, lab_linear, refine)
            return descend(state, ld, decay_fn, mark, extra_grads)

    return train_step


def _lab_render(cfg: Config, state: TrainState, batch: dict[str, Tensor],
                impl: str) -> tuple[Tensor, Tensor]:
    """The student's render (ROI frame, color (B,S,S,3), differentiable in
    the student's parameters) and the teacher's pseudo visibility mask
    (B,S,S): the pose step's own forward, mask and render
    (student_teacher, pseudo_visibility, render_student_pose), so the side
    steps see what forward_losses sees."""
    out, tout = student_teacher(cfg, state, batch)
    _, vis = pseudo_visibility(cfg, tout)
    ren = render_student_pose(cfg, batch, out["rot"], out["trans"],
                              impl=impl)
    return ren["color"], vis


def make_lab_grad_fn(cfg: Config, model: GDRN, impl: str = "kernel"):
    """Returns lab_grad(state, batch) -> (value, grads): the LAB term alone
    (lab_lw * lab_loss of the masked render against the masked image,
    masked by the teacher's pseudo visibility) and its gradient in each
    student parameter (zeros where it has none), for lab_impl
    'split_grad'. impl: the render's, as make_self_train_step's."""
    ss = cfg.self_sup

    def lab_grad(state: TrainState, batch: dict[str, Tensor]):
        ren, vis = _lab_render(cfg, state, batch, impl)
        val = ss.lab_lw * lab_loss(ren * vis[..., None],
                                   batch["roi_img"] * vis[..., None],
                                   mask=vis, no_l=ss.lab_no_l)
        params = list(state.model.parameters())
        grads = torch.autograd.grad(val, params, allow_unused=True)
        return val.detach(), [torch.zeros_like(p) if g is None else g
                              for p, g in zip(params, grads)]

    return lab_grad


def make_lab_fwd_fn(cfg: Config, model: GDRN, impl: str = "kernel"):
    """Returns fwd(state, batch) -> (ren_color (B,S,S,3), vis (B,S,S)),
    without gradients: the first side step of lab_impl 'pixel_split', the
    render and mask the pose step then makes again."""
    @torch.no_grad()
    def fwd(state: TrainState, batch: dict[str, Tensor]):
        return _lab_render(cfg, state, batch, impl)

    return fwd


def make_lab_pixel_fn(cfg: Config):
    """Returns pix(ren_color, roi_img, vis) -> (value, g): lab_lw *
    lab_loss of the masked pair and its gradient in the masked render,
    for lab_impl 'pixel_split'; the pose step adds g to its masked
    render's cotangent (lab_linear). Computed by autograd of the plain
    lab_loss on every device (kernel B3 computes the same function; it
    stays the 'pallas' mode's)."""
    ss = cfg.self_sup

    def pix(ren_color: Tensor, roi_img: Tensor, vis: Tensor):
        ren_m = (ren_color * vis[..., None]).detach().requires_grad_(True)
        img_m = roi_img * vis[..., None]
        with torch.enable_grad():
            val = ss.lab_lw * lab_loss(ren_m, img_m, mask=vis,
                                       no_l=ss.lab_no_l)
            g, = torch.autograd.grad(val, ren_m)
        return val.detach(), g

    return pix


def build_self_train_step(cfg: Config, model: GDRN,
                          lpips: LPIPS | None = None, impl: str = "kernel",
                          ema_update_every: int = 1,
                          refiner: tuple[DeepIM, Config] | None = None):
    """The pose step for cfg.self_sup.lab_impl, routed as the JAX
    package's jit_self_train_step routes it: step(state, batch, mark=None)
    -> (state, metrics). 'direct', 'surrogate' and 'pallas' are
    make_self_train_step's step; 'pixel_split' runs make_lab_fwd_fn and
    make_lab_pixel_fn first and feeds their (value, g) as lab_linear;
    'split_grad' runs make_lab_grad_fn first, adds its gradients to the
    step's (extra_grads), and its value to the metrics' LAB term and
    total. Raises for an unknown mode."""
    ss = cfg.self_sup
    mode = ss.lab_impl if ss.lab_lw > 0 else "direct"
    check_supported(dataclasses.replace(ss, lab_impl=mode))
    split = mode in ("pixel_split", "split_grad")
    step = make_self_train_step(cfg, model, lpips, split_lab=split,
                                impl=impl, ema_update_every=ema_update_every,
                                refiner=refiner)
    if mode == "pixel_split":
        fwd, pix = make_lab_fwd_fn(cfg, model, impl), make_lab_pixel_fn(cfg)

        def pixel_split_step(state, batch, mark=None):
            with span("train_step", root=True):
                ren, vis = fwd(state, batch)
                return step(state, batch, mark,
                            lab_linear=pix(ren, batch["roi_img"], vis))

        return pixel_split_step
    if mode == "split_grad":
        lab_grad = make_lab_grad_fn(cfg, model, impl)

        def split_grad_step(state, batch, mark=None):
            with span("train_step", root=True):
                val, grads = lab_grad(state, batch)
                state, metrics = step(state, batch, mark, extra_grads=grads)
            metrics["loss_color_ab_obj"] = val
            metrics["total_loss"] = metrics["total_loss"] + val
            return state, metrics

        return split_grad_step
    return step


def draw_geo_aug(cfg: Config, batch: dict[str, Tensor],
                 generator: torch.Generator) -> dict[str, Tensor]:
    """The geo step's random draws, from `generator` (on the CPU), on the
    batch's device: the pose-variated warp matrices (B,2,3), the colour
    gain U(0.8, 1.2) (B,1,1,1) and shift U(-0.05, 0.05) (B,1,1,3), and unit
    normal noise like roi_img."""
    ss = cfg.self_sup
    img = batch["roi_img"]
    B = img.shape[0]
    mats = sample_pose_variated_affines(
        generator, B, rot_deg=ss.geo_aug_rot_deg, zoom=ss.geo_aug_zoom,
        trans=ss.geo_aug_trans, crop_percent=ss.geo_aug_crop)
    gain = torch.rand((B, 1, 1, 1), generator=generator) * 0.4 + 0.8
    shift = torch.rand((B, 1, 1, 3), generator=generator) * 0.1 - 0.05
    noise = torch.randn(tuple(img.shape), generator=generator)
    return {k: v.to(img.device) for k, v in
            dict(mats=mats, gain=gain, shift=shift, noise=noise).items()}


def make_self_geo_train_step(cfg: Config, model: GDRN,
                             ema_update_every: int = 1):
    """Returns train_step(state, batch, aug, mark=None) -> (state, metrics):
    the geo-mode step. The student sees roi_img warped by aug['mats'],
    times aug['gain'], plus aug['shift'] and 0.02 aug['noise'], clipped to
    [0, 1] (aug from draw_geo_aug); its geo-mode maps are trained toward
    the teacher's maps of the unwarped image, warped by the same matrices:
    the thresholded visib mask, xyz, region probabilities, vf and norm
    (compute_self_loss_geo)."""
    ss = cfg.self_sup
    decay_fn = gated_ema_decay(ss.ema_decay, cfg.solver.ema_warmup_iters,
                               ema_update_every)
    mask_type = cfg.model.loss.mask_loss_type

    def train_step(state: TrainState, batch: dict[str, Tensor],
                   aug: dict[str, Tensor], mark=None):
        mark = mark or no_mark
        mats = aug["mats"]
        x = affine_warp(batch["roi_img"], mats) * aug["gain"] + aug["shift"]
        x = (x + 0.02 * aug["noise"]).clamp(0.0, 1.0)
        out, tout = student_teacher(cfg, state, batch, mark, "geo",
                                    dict(batch, roi_img=x))

        def warp(t, mode="bilinear"):
            return affine_warp(t if t.ndim == 4 else t[..., None], mats, mode)
        t_prob = get_mask_prob(tout["mask_logits"], mask_type)[..., 0]
        pseudo = {"vis_mask_lr": (warp(t_prob)[..., 0] > 0.5).float(),
                  "coor": warp(tout["coor"]),
                  "region": warp(torch.softmax(tout["region_logits"], -1))}
        for k in ("vf", "norm"):
            if k in tout:
                pseudo[k] = warp(tout[k])
        ld = compute_self_loss_geo(
            ss, out, pseudo,
            mask_prob_fn=lambda lg: get_mask_prob(lg, mask_type))
        mark("losses")
        return descend(state, ld, decay_fn, mark)

    return train_step


def make_synsup_train_step(cfg: Config, model: GDRN,
                           ema_update_every: int = 1):
    """Returns train_step(state, batch, mark=None) -> (state, metrics): the
    synthetic-supervised step interleaved with the self-supervised ones,
    the stage-I loss (gdrn_loss, no MTL) on the student's forward with BN
    frozen."""
    decay_fn = gated_ema_decay(cfg.self_sup.ema_decay,
                               cfg.solver.ema_warmup_iters, ema_update_every)
    gh = cfg.model.geo_head

    def train_step(state: TrainState, batch: dict[str, Tensor], mark=None):
        mark = mark or no_mark
        net = state.model.eval()
        dev = next(net.parameters()).device
        with autocast(cfg, dev):
            out = net(*model_inputs(batch),
                      generator=dropout_generator(cfg, state.step, dev))
        out = {k: v.float() for k, v in out.items()}
        mark("student_fwd")
        ld = gdrn_loss(cfg.model.loss, cfg.model.pnp_net, out, batch,
                       num_regions=gh.num_regions, xyz_bin=gh.xyz_bin)
        mark("losses")
        return descend(state, ld, decay_fn, mark)

    return train_step


def make_mode_picker(ss: SelfSupConfig, rng_np: np.random.Generator):
    """next_mode() -> 'pose' | 'geo' per iteration (ss.mode_schedule):
    'random' draws rng_np.random() < geo_mode_ratio each time; 'alternate'
    takes geo every round(1 / ratio)-th iteration; 'fix_pose'/'fix_geo'
    pin the mode (as does a ratio of 0, to pose)."""
    sched, ratio = ss.mode_schedule, ss.geo_mode_ratio
    if sched not in ("random", "alternate", "fix_pose", "fix_geo"):
        raise ValueError(f"unknown mode_schedule: {sched!r}")
    if sched == "fix_geo":
        return lambda: "geo"
    if sched == "fix_pose" or ratio <= 0:
        return lambda: "pose"
    if sched == "alternate":
        period = max(1, round(1.0 / ratio))
        counter = itertools.count(1)
        return lambda: "geo" if next(counter) % period == 0 else "pose"
    return lambda: "geo" if rng_np.random() < ratio else "pose"


def stage2_batch(cfg: Config, batch_size: int, device, seed: int = 0,
                 mesh=None) -> dict[str, Tensor]:
    """The benchmark batch of bench.py::build_stage2: make_gdrn_batch, one
    mesh per class (default the 1280-face icosphere of radius 0.06 with
    colours from the normalised vertex positions), its vertex normals and
    its num_vf_points FPS keypoints (mesh_normals, mesh_fps: the vf/norm
    pseudo labels' inputs), the ROI intrinsics and a constant depth map. No
    pseudo pose is loaded, so the step takes the teacher's."""
    batch = make_gdrn_batch(cfg, batch_size, seed=seed)
    verts, faces = mesh if mesh is not None else make_icosphere(0.06, 3)
    colors = (verts - verts.min(0)) / np.ptp(verts, 0)
    C = cfg.model.num_classes
    batch["mesh_verts"] = np.repeat(verts[None], C, 0)
    batch["mesh_faces"] = np.repeat(faces[None], C, 0)
    batch["mesh_colors"] = np.repeat(colors[None].astype(np.float32), C, 0)
    normals = compute_vertex_normals(torch.from_numpy(verts),
                                     torch.from_numpy(faces)).numpy()
    batch["mesh_normals"] = np.repeat(normals[None], C, 0)
    fps = fps_points(verts, cfg.model.geo_head.num_vf_points)
    batch["mesh_fps"] = np.repeat(fps[None].astype(np.float32), C, 0)
    b = to_device(batch, device)
    b["roi_zoom_K"] = roi_zoom_K(b, cfg.model.input_res, cfg.model.output_res)
    b["roi_depth"] = torch.ones((batch_size, cfg.model.input_res,
                                 cfg.model.input_res), device=b["roi_img"].device
                                ) * b["gt_trans"][:, 2, None, None]
    return b


@torch.no_grad()
def aim_heads_(model: GDRN, batch: dict[str, Tensor]) -> None:
    """Bias the network's first outputs toward a usable stage-II start: an
    identity allocentric rotation, a translation term that puts the mesh
    in view (centroid_z: the batch's median relative depth; centroid_z_abs:
    the median ROI centre and depth; trans: the median translation) and a
    mask logit of 10 (the teacher's pseudo mask then covers the ROI).
    Under the JAX package's initialisation the predicted depth is about 0
    and the render empty."""
    pn_cfg = model.cfg.pnp_net
    if pn_cfg.rot_type != "allo_rot6d" or (
            pn_cfg.trans_type == "centroid_z" and pn_cfg.z_type != "REL"):
        raise ValueError("aim_heads_ takes allo_rot6d (with a REL depth "
                         "for centroid_z)")
    gt_t = batch["gt_trans"]
    if pn_cfg.trans_type == "centroid_z":
        t = torch.zeros(3, device=gt_t.device)
        t[2] = (gt_t[:, 2] / batch["resize_ratio"]).median()
    elif pn_cfg.trans_type == "centroid_z_abs":
        c = batch["roi_center"].median(0).values
        t = torch.stack([c[0], c[1], gt_t[:, 2].median()])
    else:
        t = gt_t.median(0).values
    rot = torch.tensor([1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=gt_t.device)
    pn = model.pnp_net
    if hasattr(pn, "fc_pose"):
        pn.fc_pose.bias.copy_(torch.cat([rot, t]))
    else:
        pn.fc_r.bias.copy_(rot)
        pn.fc_t.bias.copy_(t)
    gh = model.geo_head_net
    out = gh.out_layer if hasattr(gh, "out_layer") else gh.out_mask
    out.bias[0] = 10.0


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
