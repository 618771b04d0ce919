"""Offline pseudo poses for stage II (port of tools/gen_pseudo_poses.py,
the link of run_smoke.sh's chain between the detector and
train_self6dpp).

The config's test split with the detections of --det-file injected goes
through the eval loader and the stage-I GDRN eval step: each detection's
pose_est. With --deepim-config, the DeepIM eval step refines those poses
(n_iter_test render-and-compare iterations, each render through kernel B1
on the card with impl="kernel"): pose_refine. The detections json that
train_self6dpp --det-file reads is written to --out: per image
'scene_id/im_id', one entry per detection with obj_id, bbox_est [x, y, w,
h] (the ROI box), score, pose_est [R | t] (3x4) and pose_refine.

    python -m self6dpp_tpu_torch.tools.gen_pseudo_poses \\
        --config configs/gdrn/lm_base.py --gdrn-ckpt OUT/gdrn_lm_base/ckpt \\
        --det-file DETS.json [--deepim-config configs/deepim/lm_flownet.py \\
        --deepim-ckpt OUT/deepim_lm_flownet512/ckpt] --out PSEUDO.json \\
        [--opts k=v ...] [--device cpu]

--gdrn-ckpt and --deepim-ckpt are checkpoint directories of the port's
train_gdrn and train_deepim (engine/checkpoint.py): the student weights of
their latest step. A directory without steps leaves the seeded init (the
JAX tool's resume_or_load does the same) with a warning; orbax steps raise.
--opts applies to --config only, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

logger = logging.getLogger("self6dpp_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--gdrn-ckpt", required=True)
    p.add_argument("--det-file", required=True)
    p.add_argument("--deepim-config", default="")
    p.add_argument("--deepim-ckpt", default="")
    p.add_argument("--out", required=True)
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
    return p.parse_args(argv)


def load_weights(directory: str, model: torch.nn.Module) -> None:
    """The latest step's student weights (train_gdrn.load_latest_weights),
    or a warning and the seeded init when the directory has no step."""
    from .train_gdrn import load_latest_weights
    if not load_latest_weights(directory, model):
        logger.warning(f"no checkpoint step in {directory!r}: the seeded "
                       "init's weights")


def refine_inputs(db: dict[str, torch.Tensor], models, rot, trans) -> dict:
    """The DeepIM eval step's batch from a GDRN eval batch on the device:
    the ROI crop as the observation inside its box, the class meshes, the
    poses to refine."""
    cls = db["roi_cls"].long()
    dev = rot.device
    return {
        "obs_img": db["roi_img"], "K": db["roi_cam"],
        "obs_box": torch.cat([db["roi_center"] - db["roi_wh"] / 2,
                              db["roi_center"] + db["roi_wh"] / 2], dim=1),
        "verts": torch.as_tensor(models.verts, device=dev)[cls],
        "faces": torch.as_tensor(models.faces, device=dev)[cls],
        "colors": torch.as_tensor(models.colors, device=dev)[cls],
        "init_rot": rot, "init_trans": trans, "roi_cls": db["roi_cls"]}


def entries(raw: dict, rot: np.ndarray, trans: np.ndarray,
            rot_r: np.ndarray | None, trans_r: np.ndarray | None):
    """('scene_id/im_id', entry) for each valid ROI of a batch."""
    n = len(raw["gt_rot"])
    valid = raw.get("_valid", np.ones(n, np.int32))
    score = raw.get("score", np.ones(n))
    for i in range(n):
        if not valid[i]:
            continue
        key = (f"{int(raw['scene_im_id_scene'][i])}/"
               f"{int(raw['scene_im_id_im'][i])}")
        cx, cy = raw["roi_center"][i]
        bw, bh = raw["roi_wh"][i]
        e = {"obj_id": int(raw["obj_id"][i]),
             "bbox_est": [float(cx - bw / 2), float(cy - bh / 2),
                          float(bw), float(bh)],
             "score": float(score[i]),
             "pose_est": np.concatenate([rot[i], trans[i][:, None]],
                                        axis=1).tolist()}
        if rot_r is not None:
            e["pose_refine"] = np.concatenate(
                [rot_r[i], trans_r[i][:, None]], axis=1).tolist()
        yield key, e


def main(argv=None, device=None, impl: str = "kernel") -> dict:
    """Writes --out; returns {'dets' (what it wrote), 'out', 'n_rois'}.
    device: the default of --device; impl: the fine stage of every render
    ('kernel' or 'plain')."""
    from .. import resolve_device
    from ..config import apply_overrides, load_config
    from ..data.bop import save_detections
    from ..engine import deepim_engine as de
    from ..engine import gdrn_engine as ge
    from ..engine.evaluator import to_device
    from ..engine.train_state import TrainState
    from ..engine.writers import setup_logger
    from .train_gdrn import build_dataset

    args = parse_args(argv)
    dev = resolve_device(args.device or device)
    cfg = apply_overrides(load_config(args.config), args.opts)
    setup_logger(None)

    ds, models, _ = build_dataset(cfg, train=False, det_file=args.det_file,
                                  device=dev, impl=impl)
    model = ge.build_gdrn(cfg, dev, seed=cfg.seed)
    load_weights(args.gdrn_ckpt, model)
    state = TrainState(step=0, model=model, teacher=None, opt=None)
    eval_step = ge.make_eval_step(cfg, model)

    refine_step = None
    if args.deepim_config:
        dcfg = load_config(args.deepim_config)
        dmodel = de.build_deepim(
            dcfg, dev, generator=torch.Generator().manual_seed(dcfg.seed))
        load_weights(args.deepim_ckpt, dmodel)
        refine_step = de.make_eval_step(dcfg, dmodel, device=dev,
                                        raster_kw={"impl": impl})

    dets: dict[str, list] = {}
    n_rois = 0
    for raw in ds.batches(cfg.solver.ims_per_batch):
        db = to_device(raw, dev)
        out = eval_step(state, db)
        rot, trans = out["rot"], out["trans"]
        rot_r = trans_r = None
        if refine_step is not None:
            ref = refine_step(refine_inputs(db, models, rot, trans))
            rot_r = ref["rot"].float().cpu().numpy()
            trans_r = ref["trans"].float().cpu().numpy()
        for key, e in entries(raw, rot.cpu().numpy(), trans.cpu().numpy(),
                              rot_r, trans_r):
            dets.setdefault(key, []).append(e)
            n_rois += 1

    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    save_detections(args.out, dets)
    logger.info(f"wrote pseudo poses for {len(dets)} images -> {args.out}")
    return {"dets": dets, "out": args.out, "n_rois": n_rois}


if __name__ == "__main__":
    main()
