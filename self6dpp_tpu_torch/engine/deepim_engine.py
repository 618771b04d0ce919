"""DeepIM refine loop, train and eval steps (port of
self6dpp_tpu/engine/deepim_engine.py: build_deepim, make_refine_fn,
make_train_step, make_eval_step, init_state, warm_n_iter).

Each refine iteration renders the mesh at the current pose in the zoomed
frame, crops the observation to the same frame, runs the network and
updates the pose; the pose is detached between iterations (reference
engine.py:350). In training each iteration also renders the ground-truth
pose in the same frame, for the flow label (ops/flow.py, from the two
depth maps) and the visible-mask label, and adds deepim_loss. Every render
sees a detached pose, so the renderer runs forward only (kernel B1) and
never its backward. The JAX package scans the loop in one XLA graph; here
it is a Python loop, under torch.inference_mode() in the eval step.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..config import Config, DeepIMConfig
from ..models.deepim import DeepIM, deepim_loss
from ..ops.flow import flow_from_depth, relative_pose_KT
from ..ops.rasterizer import RasterOut, rasterize_batch
from ..ops.zoom import (bboxes_from_pose, centers_2d_from_pose, crop_resize,
                        deepim_boxes, zoom_K)
from ..utils.profiling import span
from . import gdrn_engine
from .gdrn_engine import descend, no_mark
from .train_state import TrainState, ema_decay_schedule

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_deepim(cfg: Config, device=None,
                 generator: torch.Generator | None = None,
                 train: bool = False) -> DeepIM:
    """The DeepIM module on `device` (CUDA by default). For evaluation
    (train=False) its parameters are in the configured compute dtype and
    it is in eval mode; for training they are float32 (the solver's), the
    step computing in the compute dtype under an autocast, and it is in
    train mode. With a generator its weights are drawn from it
    (DeepIM.reset_parameters); otherwise PyTorch's default init."""
    dev = resolve_device(device)
    dtype = torch.float32 if train else _DTYPES[cfg.dist.compute_dtype]
    model = DeepIM(cfg.deepim, dtype=dtype)
    if generator is not None:
        model.reset_parameters(generator)
    return model.to(dev).train(train)


def _render_inputs(cfg: DeepIMConfig, batch: dict[str, Tensor], rot: Tensor,
                   trans: Tensor, raster_kw: dict
                   ) -> tuple[Tensor, Tensor, Tensor, RasterOut]:
    """One refine iteration's rendering and zooming.

    batch: obs_img (B,Hf,Wf,3), obs_box (B,4), K (B,3,3),
           verts (B,V,3)|(V,3), faces (F,3)|(B,F,3), colors like verts.
    Returns (x (B,h,w,6), K_zoom, crop_boxes, ren RasterOut).
    """
    h, w = cfg.input_h, cfg.input_w
    K = batch["K"]
    verts = batch["verts"]
    with span("refine.boxes"):
        v_b = verts.expand(rot.shape[0], *verts.shape[-2:])
        ren_boxes = bboxes_from_pose(v_b, K, rot, trans)
        centers = centers_2d_from_pose(K, rot, trans)
        crop_boxes, _ = deepim_boxes(ren_boxes, centers,
                                     obs_boxes=batch.get("obs_box"),
                                     lamb=cfg.zoom_lamb, out_hw=(h, w))
        Kz = zoom_K(K, crop_boxes, (h, w))
    ren = rasterize_batch(verts, batch["faces"], batch["colors"], Kz, rot,
                          trans, height=h, width=w, device=rot.device,
                          **raster_kw)
    with span("refine.crop"):
        obs = crop_resize(batch["obs_img"], crop_boxes, h, w)
        x = torch.cat([ren.attr[..., :3], obs], dim=-1)
        if cfg.in_channels == 8:
            obs_mask = crop_resize(batch["obs_mask"][..., None], crop_boxes,
                                   h, w)
            x = torch.cat([x, ren.mask[..., None], obs_mask], dim=-1)
    return x, Kz, crop_boxes, ren


def _loss_labels(cfg: Config, batch: dict[str, Tensor], ren: RasterOut,
                Kz: Tensor, rot: Tensor, trans: Tensor, raster_kw: dict
                ) -> dict[str, Tensor]:
    """The batch with one training iteration's labels (when flow_lw > 0
    and with_flow; else the batch as it is): the ground-truth pose rendered
    in the estimate's zoomed frame (a second hard render), the flow from
    the estimate's depth to that render's depth (gt_flow, gt_flow_valid)
    and its mask (gt_mask_visib)."""
    d = cfg.deepim
    if not (d.flow_lw > 0 and d.with_flow):
        return batch
    gt_ren = rasterize_batch(batch["verts"], batch["faces"], batch["colors"],
                             Kz, batch["gt_rot"], batch["gt_trans"],
                             height=d.input_h, width=d.input_w,
                             device=rot.device, **raster_kw)
    KT, Kinv = relative_pose_KT(Kz, rot, trans, batch["gt_rot"],
                                batch["gt_trans"])
    gt_flow, gt_valid = flow_from_depth(ren.depth, gt_ren.depth, KT, Kinv)
    return dict(batch, gt_flow=gt_flow, gt_flow_valid=gt_valid,
                gt_mask_visib=gt_ren.mask)


def make_refine_fn(cfg: Config, model: DeepIM, n_iter: int,
                   raster_kw: dict | None = None, with_loss: bool = False
                   ) -> Callable:
    """refine(batch, init_rot, init_trans, mark=None) -> (rot, trans) after
    n_iter render-and-compare iterations; with_loss -> (rot, trans,
    losses), losses the mean over the iterations of each deepim_loss term
    (on _loss_labels). Renders are hard-only (with_prob=False) of detached
    poses; raster_kw overrides the renderer settings (e.g. impl='plain').
    The network runs under the compute dtype's autocast (none for float32
    or a model whose parameters are in the compute dtype). mark(name), if
    given, is called after each iteration's render (and zoom), its labels,
    its network forward and its loss. Called outside a step, refine is a
    root span (utils/profiling.py)."""
    dcfg = cfg.deepim
    rkw = dict(tile_px=cfg.renderer.tile_px,
               faces_per_tile=cfg.renderer.faces_per_tile,
               sigma_px=1.0, with_prob=False)
    if raster_kw:
        rkw.update(raster_kw)
    compute = _DTYPES[cfg.dist.compute_dtype]

    def refine(batch: dict[str, Tensor], init_rot: Tensor, init_trans: Tensor,
               mark=no_mark):
        with span("refine", root=True):
            rot, trans = init_rot.detach(), init_trans.detach()
            sums: dict[str, Tensor] = {}
            for _ in range(n_iter):
                with span("render"):
                    x, Kz, _, ren = _render_inputs(dcfg, batch, rot, trans,
                                                   rkw)
                mark("render")
                if with_loss:
                    with span("flow_gt"):
                        lb = _loss_labels(cfg, batch, ren, Kz, rot, trans,
                                          rkw)
                    mark("flow_gt")
                with span("network_fwd"), torch.autocast(
                        rot.device.type, dtype=compute,
                        enabled=model.dtype != compute):
                    out = model(x, rot, trans, Kz,
                                obj_class=batch.get("roi_cls"))
                mark("network_fwd")
                if with_loss:
                    with span("loss"):
                        for k, v in deepim_loss(dcfg, out, lb).items():
                            sums[k] = sums[k] + v if k in sums else v
                    mark("loss")
                rot, trans = out["rot"].detach(), out["trans"].detach()
            if with_loss:
                return rot, trans, {k: v / n_iter for k, v in sums.items()}
            return rot, trans

    return refine


def to_device(batch: dict[str, Any], device: torch.device) -> dict[str, Tensor]:
    """Arrays -> tensors on `device`, floating point as float32."""
    out = {}
    for k, v in batch.items():
        t = v if torch.is_tensor(v) else torch.from_numpy(np.array(v))
        out[k] = t.to(device=device, dtype=torch.float32
                      if t.is_floating_point() else t.dtype)
    return out


def init_state(cfg: Config, model: DeepIM) -> TrainState:
    """The model (its float32 parameters: build_deepim(train=True)), its
    EMA teacher and the solver."""
    return gdrn_engine.init_state(cfg, model)


def make_train_step(cfg: Config, model: DeepIM, n_iter: int | None = None,
                    device=None, raster_kw: dict | None = None):
    """Returns train_step(state, batch, mark=None) -> (state, metrics): one
    DeepIM training step on `device` (CUDA by default), updating the state
    in place. n_iter (default n_iter_train; warm_n_iter gives the ramp)
    refine iterations from batch['init_rot'], batch['init_trans'] with
    make_refine_fn(with_loss=True) in train mode; the total is the sum of
    the iterations' loss terms over n_iter; backward, the solver, the EMA
    teacher at ema_decay_schedule(solver.ema_decay, ema_warmup_iters).
    metrics holds each term's mean over the iterations and total_loss.
    mark(name) is called after each phase (render, flow_gt, network_fwd,
    loss per iteration; then backward and optimizer_ema).

    batch: make_eval_step's keys, with gt_rot, gt_trans, gt_points,
    roi_extent, sym_rots, sym_valid.

    Raises for a model with batch norm (FlowNetS with use_bn, and the
    ResNet trunks of DeepIM_Shared and DeepIM_Unshared): the JAX package's
    step applies the model in train mode without a mutable batch_stats
    collection, so Flax refuses the running-statistics update
    (ModifyScopeVariableError), and the port trains nothing the JAX
    package cannot."""
    if any(isinstance(m, torch.nn.modules.batchnorm._BatchNorm)
           for m in model.modules()):
        raise ValueError(
            f"{cfg.deepim.name} (use_bn={cfg.deepim.use_bn}) has batch norm: "
            "the JAX package's DeepIM train step cannot update its running "
            "statistics, and neither does the port's")
    dev = resolve_device(device)
    n_iter = cfg.deepim.n_iter_train if n_iter is None else n_iter
    refine = make_refine_fn(cfg, model, n_iter, raster_kw, with_loss=True)
    decay_fn = ema_decay_schedule(cfg.solver.ema_decay,
                                  cfg.solver.ema_warmup_iters)

    def train_step(state: TrainState, batch: dict[str, Any], mark=None):
        mark = mark or no_mark
        with span("train_step", root=True):
            b = to_device(batch, dev)
            state.model.train()
            _, _, ld = refine(b, b["init_rot"], b["init_trans"], mark)
            return descend(state, ld, decay_fn, mark)

    return train_step


def make_eval_step(cfg: Config, model: DeepIM, device=None,
                   raster_kw: dict | None = None
                   ) -> Callable[[dict[str, Any]], dict[str, Tensor]]:
    """eval_step(batch, mark=None) -> {"rot" (B,3,3), "trans" (B,3)}:
    n_iter_test refine iterations from batch["init_rot"],
    batch["init_trans"] on `device` (CUDA by default); mark as
    make_refine_fn's. One request is one root span (utils/profiling.py)."""
    dev = resolve_device(device)
    refine = make_refine_fn(cfg, model, cfg.deepim.n_iter_test,
                            raster_kw=raster_kw)

    def eval_step(batch: dict[str, Any], mark=no_mark) -> dict[str, Tensor]:
        with span("eval_step", root=True):
            b = to_device(batch, dev)
            with torch.inference_mode():
                rot, trans = refine(b, b["init_rot"], b["init_trans"], mark)
            return {"rot": rot, "trans": trans}

    return eval_step


def warm_n_iter(dcfg: DeepIMConfig, iteration: int) -> int:
    """The refine-count ramp (engine.py:275-294): from 1 to n_iter_train
    over the first n_iter_train_warm_iters iterations."""
    n = max(1, dcfg.n_iter_train)
    if dcfg.n_iter_train_warm_iters <= 0:
        return n
    return min(n, max(1, int(n * (iteration + 1)
                             / dcfg.n_iter_train_warm_iters)))
