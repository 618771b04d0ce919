"""Self6D++ stage-II self-supervised training CLI (port of
tools/train_self6dpp.py, what train_self6dpp.sh runs; reference
core/self6dpp/main_self6dpp.py).

The student GDRN is warm-started from a stage-I checkpoint (--weights,
weights only: the solver starts fresh at them) and an EMA teacher gives
the pseudo labels; pseudo poses come from a detections json with
pose_est/pose_refine. Each iteration is, drawn from one generator in the
JAX CLI's order, a TRAIN2 synthetic-supervised step (data.train2_ratio),
a geo-mode step (self_sup.geo_mode_ratio) or a pose-mode step: the
student's pose rendered through kernels B1 (forward) and B2 (backward) on
the card with impl="kernel", LAB through kernel B3, LPIPS, MS-SSIM, the
DeepIM refiner in the loop and the RepjRefiner loss as configured
(engine/self_engine.py). The teacher is evaluated every test.eval_period
iterations.

    python -m self6dpp_tpu_torch.tools.train_self6dpp \\
        --config configs/self6dpp/lm_ss.py [--weights STAGE1_CKPT_DIR] \\
        [--init-npz WEIGHTS.npz] [--det-file DETS.json] [--resume] \\
        [--opts k=v ...] [--device cpu] \\
        [--dist-coordinator HOST:PORT --dist-nprocs N --dist-rank R]

--dist-*: data parallel over N processes, each rank feeding its own
ims_per_batch (parallel/dist.py). LPIPS reads weights/lpips_alex.npz (relative to the working directory, as
the JAX CLI reads it) and, without it, draws its weights from a seed with
a warning. The refiner reads self_sup.refiner_weights (a flat .npz, or a
checkpoint directory of the port's train_deepim) and, without them, runs
from its seeded init with a warning.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

from ..parallel.dist import (add_distributed_args,
                             maybe_init_distributed_from_args)

logger = logging.getLogger("self6dpp_tpu_torch")
LPIPS_WEIGHTS = os.path.join("weights", "lpips_alex.npz")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--weights", default="",
                   help="stage-I checkpoint directory to warm-start from")
    p.add_argument("--init-npz", default="",
                   help="flat .npz of JAX-layout weights loaded over the "
                        "seeded init before the warm start (strict=False)")
    p.add_argument("--det-file", default="",
                   help="detections json with pose_est/pose_refine")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def build_lpips_of(dev):
    """LPIPS with LPIPS_WEIGHTS, or its seeded init with a warning."""
    from ..models.lpips import LPIPS, build_lpips, load_lpips_params
    sd = load_lpips_params(LPIPS_WEIGHTS)
    if sd is None:
        logger.warning("no converted LPIPS weights found; using random-init "
                       "AlexNet features")
        return build_lpips(dev)
    model = LPIPS()
    model.load_state_dict(sd)
    return model.to(dev).eval().requires_grad_(False)


def build_refiner_of(cfg, dev):
    """(DeepIM in eval mode, its Config) from self_sup.refiner_config and
    refiner_weights, or None without refine_with_deepim."""
    from ..config import load_config
    from ..engine import deepim_engine as de
    from ..engine.checkpoint import CheckpointManager, load_params_npz
    ss = cfg.self_sup
    if not ss.refine_with_deepim:
        return None
    if not ss.refiner_config:
        raise ValueError("self_sup.refine_with_deepim requires "
                         "self_sup.refiner_config")
    rcfg = load_config(ss.refiner_config)
    dmodel = de.build_deepim(
        rcfg, dev, generator=torch.Generator().manual_seed(rcfg.seed))
    if ss.refiner_weights.endswith(".npz"):
        load_params_npz(ss.refiner_weights, dmodel, strict=False)
    elif ss.refiner_weights:
        mgr = CheckpointManager(ss.refiner_weights)
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {ss.refiner_weights}")
        load_params_npz(os.path.join(mgr.directory, str(step), "model.npz"),
                        dmodel)
    else:
        logger.warning("refine_with_deepim without refiner_weights: using a "
                       "random-init refiner (smoke mode)")
    logger.info(f"DeepIM refiner in the loop: {ss.refiner_config}")
    return dmodel.eval(), rcfg


def device_batch_fn(cfg, models, dev):
    """to_device for the stage-II steps: the batch's arrays on `dev` with
    the class meshes (verts, faces, colours, normals, FPS keypoints, and
    UV textures when the models have them) and the ROI intrinsics."""
    from ..engine import self_engine as se
    from ..engine.evaluator import to_device
    mesh = {"mesh_verts": models.verts, "mesh_faces": models.faces,
            "mesh_colors": models.colors, "mesh_normals": models.normals,
            "mesh_fps": models.fps_points}
    if models.uvs is not None:
        mesh.update(mesh_uv=models.uvs, mesh_texture=models.textures)
    mesh = {k: torch.as_tensor(np.asarray(v), device=dev)
            for k, v in mesh.items()}

    def fn(batch):
        db = to_device(batch, dev)
        db.update(mesh)
        db["roi_zoom_K"] = se.roi_zoom_K(db, cfg.model.input_res,
                                         cfg.model.output_res)
        return db
    return fn


def vis_fn_of(cfg, impl: str):
    """vis_fn(state, batch, storage): an image grid of up to 4 ROIs, each
    row [ROI | student render | teacher's visible mask, nearest-resized to
    the ROI], to storage.tb."""
    from ..data.aug import resize_nearest
    from ..engine import self_engine as se
    from ..engine.gdrn_engine import model_inputs
    from ..losses.mask_losses import get_mask_prob

    @torch.no_grad()
    def vis_fn(state, batch, storage):
        out = state.model.eval()(*model_inputs(batch))
        ren = se.render_student_pose(cfg, batch, out["rot"].float(),
                                     out["trans"].float(), impl=impl)
        tout = state.teacher(*model_inputs(batch), forward_mode="geo")
        tmask = get_mask_prob(tout["mask_logits"].float(),
                              cfg.model.loss.mask_loss_type)[..., 0]
        color = ren["color"].float().cpu().numpy()
        tmask = tmask.cpu().numpy()
        img = batch["roi_img"].float().cpu().numpy()
        s = cfg.model.input_res
        rows = []
        for i in range(min(4, color.shape[0])):
            tm = resize_nearest(tmask[i], (s, s))
            rows.append(np.concatenate(
                [img[i], color[i], np.repeat(tm[..., None], 3, -1)], axis=1))
        grid = np.clip(np.concatenate(rows, axis=0), 0, 1)
        storage.tb.add_image("self/roi_ren_pseudomask", grid)
    return vis_fn


def main(argv=None, device=None, impl: str = "kernel") -> dict:
    """Returns {'state', 'timings' (per iteration: the trainer's wait and
    step seconds), 'loader_timings' (per batch of the self-supervised
    loader: its host and label-render seconds), 'modes'
    (per iteration: 'pose', 'geo' or 'synsup'), 'metrics' (the path of
    metrics.json)}. device: the default of --device; impl: the fine stage
    of every render and LAB's kernel ('kernel' or 'plain')."""
    from .. import resolve_device
    from ..config import apply_overrides, load_config
    from ..engine import gdrn_engine as ge
    from ..engine import self_engine as se
    from ..engine.checkpoint import (CheckpointManager, check_no_orbax_steps,
                                     load_params_npz)
    from ..engine.trainer import do_train
    from ..engine.writers import setup_logger
    from .train_gdrn import build_dataset, ckpt_dir, evaluate_fn

    args = parse_args(argv)
    dev = maybe_init_distributed_from_args(
        args, resolve_device(args.device or device))
    cfg = apply_overrides(load_config(args.config), args.opts)
    setup_logger(os.path.join(cfg.output_dir, cfg.exp_name))

    check_no_orbax_steps(ckpt_dir(cfg))
    ds, models, _ = build_dataset(cfg, train=True, det_file=args.det_file,
                                  device=dev, impl=impl)
    to_dev = device_batch_fn(cfg, models, dev)
    batches = ds.batches(cfg.solver.ims_per_batch)
    # the JAX CLI takes its first batch to initialise the state
    next(batches)
    model = ge.build_gdrn(cfg, dev, seed=cfg.seed)
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
        logger.info(f"loaded converted weights from {args.init_npz}")
    state = ge.init_state(cfg, model)
    if args.weights:
        state = CheckpointManager(args.weights).load_weights(state)
        logger.info(f"warm-started student+teacher weights from "
                    f"{args.weights}")
    lpips = build_lpips_of(dev)

    ss = cfg.self_sup
    # the teacher follows every teacher_update_freq epochs
    iters_per_epoch = max(1, len(ds) // cfg.solver.ims_per_batch)
    ema_every = (max(1, ss.teacher_update_freq) * iters_per_epoch
                 if ss.teacher_update_freq > 0 else 1)
    pose_step = se.make_self_train_step(
        cfg, model, lpips, impl=impl, ema_update_every=ema_every,
        refiner=build_refiner_of(cfg, dev))
    geo_step = se.make_self_geo_train_step(cfg, model,
                                           ema_update_every=ema_every)
    geo_gen = torch.Generator().manual_seed(cfg.seed)
    rng_np = np.random.default_rng(cfg.seed)

    # the TRAIN2 synthetic-supervised interleave
    synsup_step = batches2 = None
    train2_ratio = cfg.data.train2_ratio
    if train2_ratio > 0 and cfg.data.train2_datasets:
        ds2, _, _ = build_dataset(cfg, train=True,
                                  dataset_names=cfg.data.train2_datasets,
                                  device=dev, impl=impl)
        batches2 = ds2.batches(cfg.solver.ims_per_batch)
        synsup_step = se.make_synsup_train_step(cfg, model,
                                                ema_update_every=ema_every)
        logger.info(f"TRAIN2 interleave: ratio={train2_ratio} "
                    f"datasets={cfg.data.train2_datasets}")
    next_mode = se.make_mode_picker(ss, rng_np)

    def mixed_batches():
        """Per iteration a TRAIN2 batch, or a geo or pose batch, marked
        by a key that routes the step."""
        while True:
            if synsup_step is not None and rng_np.random() < train2_ratio:
                yield dict(next(batches2), _synsup=np.int32(1))
            elif next_mode() == "geo":
                yield dict(next(batches), _geo=np.int32(1))
            else:
                yield next(batches)

    modes: list[str] = []

    def train_step(state, batch):
        if "_synsup" in batch:
            modes.append("synsup")
            return synsup_step(state, batch)
        if "_geo" in batch:
            modes.append("geo")
            return geo_step(state, batch,
                            se.draw_geo_aug(cfg, batch, geo_gen))
        modes.append("pose")
        return pose_step(state, batch)

    vis_fn = vis_fn_of(cfg, impl) if cfg.vis_period > 0 else None
    # the teacher is the stage-II model that is evaluated
    eval_fn = evaluate_fn(cfg, model, args.det_file, dev, impl, use_ema=True) \
        if cfg.test.eval_period > 0 else None
    timings: list[dict] = []
    state = do_train(cfg, state, train_step, mixed_batches(), to_dev,
                     eval_fn=eval_fn, vis_fn=vis_fn, resume=args.resume,
                     timings=timings)
    return {"state": state, "timings": timings,
            "loader_timings": ds.timings[1:], "modes": modes,
            "metrics": os.path.join(cfg.output_dir, cfg.exp_name,
                                    "metrics.json")}


if __name__ == "__main__":
    main()
