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
(render_student_pose). Not ported here: the JAX pose step's emit_render
argument and its extra_grads and refiner_vars inputs (the port's refiner
is a module whose weights the caller sets); and the side programs that
feed split_lab (make_lab_grad_fn, make_lab_fwd_fn, make_lab_pixel_fn).
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
from ..ops.fps import fps_points
from ..ops.geometry import compute_vf
from ..ops.rasterizer import (compute_vertex_normals, rasterize_batch,
                              sample_texture)
from ..ops.warp import affine_warp, sample_pose_variated_affines
from ..ops.zoom import zoom_K
from .deepim_engine import make_refine_fn, to_device
from .gdrn_engine import (autocast, build_gdrn, descend, init_state,
                          model_inputs, no_mark)
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
    with autocast(cfg, dev):
        out = net(*model_inputs(student_batch or batch),
                  forward_mode=forward_mode)
    out = {k: v.float() for k, v in out.items()}
    mark("student_fwd")
    with autocast(cfg, dev), torch.no_grad():
        tout = state.teacher(*model_inputs(batch), forward_mode=forward_mode)
    tout = {k: v.float() for k, v in tout.items()}
    mark("teacher_fwd")
    return out, tout


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
        labels["norm"] = render_pseudo_normals(cfg, batch, rot, trans, impl)
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
    s, o = cfg.model.input_res, cfg.model.output_res
    out, tout = student_teacher(cfg, state, batch, mark)

    t_vis_prob = get_mask_prob(tout["mask_logits"],
                               cfg.model.loss.mask_loss_type)[..., 0]
    pseudo_vis_lr = (t_vis_prob > 0.5).float()
    # nearest upsampling at an integer factor is a plain repeat
    pseudo_vis = pseudo_vis_lr.repeat_interleave(s // o, 1) \
                              .repeat_interleave(s // o, 2)
    p_rot, p_trans = select_pseudo_pose(ss, batch, tout)
    if refine is not None:
        # no_grad, not inference_mode: the refined pose feeds the labels of
        # a step that takes gradients
        with torch.no_grad():
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

    ren = render_student_pose(cfg, batch, out["rot"], out["trans"],
                              impl=impl)
    mark("render_fwd")
    ld = compute_self_loss_pose(ss_loss, ren, out, pseudo, batch,
                                lpips_fn=lpips, lab_linear=lab_linear,
                                impl=impl)
    mark("losses")
    if ss.repj_refine:
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
                   lab_linear=None):
        mark = mark or no_mark
        ld, _, _ = forward_losses(cfg, state, batch, impl, mark, lpips,
                                  split_lab, lab_linear, refine)
        return descend(state, ld, decay_fn, mark)

    return train_step


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
        with autocast(cfg, next(net.parameters()).device):
            out = net(*model_inputs(batch))
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
