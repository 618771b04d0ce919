"""YOLOv4 detector train/test CLI (port of tools/train_yolov4.py, what
train_yolov4.sh runs).

Training: the config's first test dataset's meta names the classes; its
train split goes through the detector's loader (data/det_loader.py:
mosaic, random affine, HSV, flips), the train step (forward with batch
norm training, yolo_loss, backward, the solver; no EMA teacher) and the
trainer (engine/trainer.py: checkpoints in <output_dir>/<exp_name>/ckpt,
metrics.json), with COCO AP on the test split every test.eval_period
iterations. --eval-only: the latest checkpoint step (when there is one)
through inference on the card, NMS on the host and the AP table, and the
detections json ({scene_id}/{im_id} -> [{obj_id, bbox_est [x, y, w, h],
score, time}]) that train_gdrn --det-file and train_self6dpp --det-file
read.

    python -m self6dpp_tpu_torch.tools.train_yolov4 \\
        --config configs/gdrn/lm_base.py [--eval-only] [--out-det DETS.json] \\
        [--resume] [--eval-max-images N] [--opts k=v ...] [--device cpu] \\
        [--dist-coordinator HOST:PORT --dist-nprocs N --dist-rank R]

--dist-*: training data parallel over N processes, each rank taking its
own batch of every epoch's order (parallel/dist.py); --eval-only runs on
rank 0.

The batch is solver.ims_per_batch // 4 images at det.input_size², float32.
The weights start from the seeded init (cfg.seed). A checkpoint directory
with orbax steps (the JAX CLI's) raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..parallel.dist import (add_distributed_args, is_main,
                             maybe_init_distributed_from_args)

logger = logging.getLogger("self6dpp_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--out-det", default="", help="output detection json")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-max-images", type=int, default=0,
                   help="cap the in-train eval set (0 = all)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def build_model(ycfg, device, seed: int):
    """The YOLOv4 the CLI starts from: the seeded init on `device`."""
    from ..models.yolo import build_yolo
    return build_yolo(ycfg, device, seed=seed)


def to_device(batch, device):
    """(images NHWC, targets, valid) numpy -> (images NCHW, targets, valid)
    tensors on the device."""
    imgs, tgts, valid = batch
    x = torch.from_numpy(imgs).to(device, non_blocking=True)
    return (x.permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(tgts).to(device, non_blocking=True),
            torch.from_numpy(valid).to(device, non_blocking=True))


def make_train_step(ycfg):
    """train_step(state, batch, mark=None) -> (state, metrics): the forward
    with batch norm training, yolo_loss, backward and the solver, updating
    the state in place; metrics holds loss_box, loss_obj, loss_cls and
    total_loss as 0-d tensors. mark(name), if given, is called after the
    forward, the loss, the backward and the solver."""
    from ..engine.gdrn_engine import descend, no_mark
    from ..models.yolo import yolo_loss

    def train_step(state, batch, mark=None):
        mark = mark or no_mark
        x, tg, tv = batch
        outs = state.model.train()(x)
        mark("forward")
        ld = yolo_loss(outs, tg, tv, ycfg)
        mark("loss")
        return descend(state, ld, lambda step: 1.0, mark)

    return train_step


@torch.no_grad()
def run_detector_eval(model, ycfg, dataset, bs, class_to_obj_id, device,
                      max_images: int = 0, stats: dict | None = None):
    """Inference (eval-mode forward and decode on the device) and NMS on
    the host over the eval split. Returns (the AP table, the detection
    json's rows by scene_im_id, the last batch's seconds per image).
    Boxes are mapped back to the original frame before scoring. stats,
    when given, gets 'batches' (one {'infer_s', 'nms_s', 'images'} per
    batch) and 'evaluate_s' (the AP table's seconds)."""
    from ..engine.det_evaluator import DetEvaluator
    from ..models.yolo import decode_predictions, non_max_suppression

    model.eval()
    evaluator = DetEvaluator(num_classes=ycfg.num_classes)
    dets: dict[str, list] = {}
    n_done, dt = 0, 0.0
    timings: list[dict] = []
    for imgs, shapes, gts, recs in dataset.eval_batches(bs):
        t0 = time.perf_counter()
        x = torch.from_numpy(imgs).to(device).permute(0, 3, 1, 2).contiguous()
        pred = decode_predictions(model(x), ycfg).cpu().numpy()
        t1 = time.perf_counter()
        dt = (t1 - t0) / len(recs)
        nms = non_max_suppression(pred, ycfg.conf_thresh, ycfg.iou_thresh)
        timings.append({"infer_s": t1 - t0,
                        "nms_s": time.perf_counter() - t1,
                        "images": len(recs)})
        for d, sh, gt, rec in zip(nms, shapes, gts, recs):
            d = np.asarray(d, np.float32).reshape(-1, 6)
            boxes = sh.to_original(d[:, :4])
            evaluator.add_image(rec.scene_im_id, boxes, d[:, 5], d[:, 4],
                                gt[:, 1:5], gt[:, 0])
            dets[rec.scene_im_id] = [
                {"obj_id": class_to_obj_id(int(cls)),
                 "bbox_est": [float(x1), float(y1), float(x2 - x1),
                              float(y2 - y1)],
                 "score": float(score), "time": dt}
                for (x1, y1, x2, y2), (score, cls) in zip(boxes, d[:, 4:6])]
            n_done += 1
        if max_images and n_done >= max_images:
            break
    t0 = time.perf_counter()
    ap = evaluator.evaluate()
    if stats is not None:
        stats.update(batches=timings, evaluate_s=time.perf_counter() - t0)
    return ap, dets, dt


def main(argv=None, device=None) -> dict:
    """Training returns {'state', 'timings' (per iteration: the trainer's
    wait and step seconds beside the loader's host seconds), 'metrics'
    (the path of metrics.json)}; --eval-only returns {'ap', 'dets',
    'out_det', 'timings' (per batch: inference and NMS seconds),
    'evaluate_s' (the AP table's seconds), 'eval_s' (the whole pass),
    'loader_timings' (per batch: the loader's host seconds)}. device: the
    default of --device."""
    from .. import resolve_device
    from ..config import apply_overrides, load_config
    from ..convert import param_kinds
    from ..data.bop import load_bop_split, save_detections
    from ..data.det_loader import DetDataset
    from ..data.ref import get_meta
    from ..engine.checkpoint import CheckpointManager, check_no_orbax_steps
    from ..engine.optim import build_optimizer
    from ..engine.train_state import create_train_state
    from ..engine.trainer import do_train
    from ..engine.writers import setup_logger
    from ..models.yolo import YoloConfig

    args = parse_args(argv)
    dev = maybe_init_distributed_from_args(
        args, resolve_device(args.device or device))
    cfg = apply_overrides(load_config(args.config), args.opts)
    setup_logger(os.path.join(cfg.output_dir, cfg.exp_name))
    meta = get_meta(cfg.data.test_datasets[0])
    ycfg = YoloConfig(num_classes=meta.num_objects,
                      input_size=cfg.det.input_size,
                      width_multiple=cfg.det.width_multiple,
                      depth_multiple=cfg.det.depth_multiple)

    def class_of_obj_id(oid: int) -> int:
        return meta.objects.index(meta.id2obj[oid])

    def class_to_obj_id(cls: int) -> int:
        return meta.obj2id[meta.objects[cls]]

    test_dir = os.path.join(cfg.data.dataset_root, meta.name, "test")
    test_set = DetDataset(load_bop_split(test_dir), cfg.det, class_of_obj_id,
                          train=False)
    bs = max(cfg.solver.ims_per_batch // 4, 1)
    ckpt_dir = os.path.join(cfg.output_dir, cfg.exp_name, "ckpt")
    check_no_orbax_steps(ckpt_dir)
    model = build_model(ycfg, dev, cfg.seed)
    opt = build_optimizer(cfg.solver, model.parameters(),
                          kinds=list(param_kinds(model).values()))
    state = create_train_state(model, opt, with_ema=False)

    if args.eval_only:
        if not is_main():
            return {}
        state, _ = CheckpointManager(ckpt_dir).resume_or_load(state,
                                                              resume=True)
        stats: dict = {}
        t0 = time.perf_counter()
        ap, dets, _ = run_detector_eval(state.model, ycfg, test_set, bs,
                                        class_to_obj_id, dev, stats=stats)
        eval_s = time.perf_counter() - t0
        logger.info("COCO AP: " + "  ".join(
            f"{k}={v * 100:.2f}" for k, v in ap.items()))
        out_path = args.out_det or os.path.join(
            cfg.output_dir, cfg.exp_name, "detections.json")
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        save_detections(out_path, dets)
        logger.info(f"wrote {out_path}")
        return {"ap": ap, "dets": dets, "out_det": out_path,
                "timings": stats["batches"], "evaluate_s": stats["evaluate_s"],
                "eval_s": eval_s, "loader_timings": test_set.timings}

    train_dir = os.path.join(cfg.data.dataset_root, meta.name, "train")
    train_set = DetDataset(load_bop_split(train_dir), cfg.det,
                           class_of_obj_id, train=True, seed=cfg.seed)

    def eval_fn(st):
        ap, _, _ = run_detector_eval(st.model, ycfg, test_set, bs,
                                     class_to_obj_id, dev,
                                     max_images=args.eval_max_images)
        return {"avg": ap}

    timings: list[dict] = []
    state = do_train(cfg, state, make_train_step(ycfg),
                     train_set.train_batches(bs),
                     lambda b: to_device(b, dev), eval_fn=eval_fn,
                     resume=args.resume, timings=timings)
    return {"state": state,
            "timings": [{**a, **b} for a, b in zip(train_set.timings,
                                                   timings)],
            "metrics": os.path.join(cfg.output_dir, cfg.exp_name,
                                    "metrics.json")}


if __name__ == "__main__":
    main()
