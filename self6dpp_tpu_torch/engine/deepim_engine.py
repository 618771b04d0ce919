"""DeepIM refine loop and eval step (port of
self6dpp_tpu/engine/deepim_engine.py).

Each refine iteration renders the mesh at the current pose in the zoomed
frame, crops the observation to the same frame, runs the network and
updates the pose; the pose is detached between iterations (reference
engine.py:350). The JAX package scans the loop in one XLA graph; here it is
a Python loop under torch.inference_mode().
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..config import Config, DeepIMConfig
from ..models.deepim import DeepIM
from ..ops.rasterizer import RasterOut, rasterize_batch
from ..ops.zoom import (bboxes_from_pose, centers_2d_from_pose, crop_resize,
                        deepim_boxes, zoom_K)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def build_deepim(cfg: Config, device=None,
                 generator: torch.Generator | None = None) -> DeepIM:
    """The DeepIM module on `device` (CUDA by default) in the configured
    compute dtype, in eval mode. With a generator its weights are drawn
    from it (DeepIM.reset_parameters); otherwise PyTorch's default init."""
    dev = resolve_device(device)
    model = DeepIM(cfg.deepim, dtype=_DTYPES[cfg.dist.compute_dtype])
    if generator is not None:
        model.reset_parameters(generator)
    return model.to(dev).eval()


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
    obs = crop_resize(batch["obs_img"], crop_boxes, h, w)
    x = torch.cat([ren.attr[..., :3], obs], dim=-1)
    if cfg.in_channels == 8:
        obs_mask = crop_resize(batch["obs_mask"][..., None], crop_boxes, h, w)
        x = torch.cat([x, ren.mask[..., None], obs_mask], dim=-1)
    return x, Kz, crop_boxes, ren


def make_refine_fn(cfg: Config, model: DeepIM, n_iter: int,
                   raster_kw: dict | None = None
                   ) -> Callable[[dict, Tensor, Tensor], tuple[Tensor, Tensor]]:
    """refine(batch, init_rot, init_trans) -> (rot, trans) after n_iter
    render-and-compare iterations. Renders are hard-only (with_prob=False);
    raster_kw overrides the renderer settings (e.g. impl='plain')."""
    dcfg = cfg.deepim
    rkw = dict(tile_px=cfg.renderer.tile_px,
               faces_per_tile=cfg.renderer.faces_per_tile,
               sigma_px=1.0, with_prob=False)
    if raster_kw:
        rkw.update(raster_kw)

    def refine(batch: dict[str, Tensor], init_rot: Tensor, init_trans: Tensor):
        rot, trans = init_rot, init_trans
        for _ in range(n_iter):
            x, Kz, _, _ = _render_inputs(dcfg, batch, rot, trans, rkw)
            out = model(x, rot, trans, Kz, obj_class=batch.get("roi_cls"))
            rot, trans = out["rot"].detach(), out["trans"].detach()
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


def make_eval_step(cfg: Config, model: DeepIM, device=None,
                   raster_kw: dict | None = None
                   ) -> Callable[[dict[str, Any]], dict[str, Tensor]]:
    """eval_step(batch) -> {"rot" (B,3,3), "trans" (B,3)}: n_iter_test refine
    iterations from batch["init_rot"], batch["init_trans"] on `device`
    (CUDA by default)."""
    dev = resolve_device(device)
    refine = make_refine_fn(cfg, model, cfg.deepim.n_iter_test,
                            raster_kw=raster_kw)

    def eval_step(batch: dict[str, Any]) -> dict[str, Tensor]:
        b = to_device(batch, dev)
        with torch.inference_mode():
            rot, trans = refine(b, b["init_rot"], b["init_trans"])
        return {"rot": rot, "trans": trans}

    return eval_step
