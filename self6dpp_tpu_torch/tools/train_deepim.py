"""DeepIM train/test CLI (port of tools/train_deepim.py, what
train_deepim.sh and test_deepim.sh run). Each instance's initial pose is
its ground truth plus noise (15 deg rotation, (1, 1, 5) cm translation
std, drawn from default_rng(cfg.seed) in the JAX CLI's order); every
refine iteration renders through kernel B1 on the card with
impl="kernel" (engine/deepim_engine.py).

Training: the train split through the train-mode loader, the DeepIM train
step (one per refine count of the n_iter_train_warm_iters ramp) and the
trainer, with the test split evaluated every test.eval_period iterations
from a fixed perturbation. --eval-only: n_iter_test refine iterations on
the test split; prints the recall tables as markdown.

    python -m self6dpp_tpu_torch.tools.train_deepim \\
        --config configs/deepim/lm_flownet.py [--eval-only] [--resume] \\
        [--init-npz WEIGHTS.npz] [--init-pose-file POSES.json] \\
        [--opts k=v ...] [--device cpu] \\
        [--dist-coordinator HOST:PORT --dist-nprocs N --dist-rank R]

--init-pose-file is taken and not read, as the JAX CLI takes it: a warning
says so. --dist-*: training data parallel over N processes
(parallel/dist.py); --eval-only runs on rank 0.

Weights: --init-npz (the JAX DeepIM's flat .npz) over the seeded init;
without it, --eval-only takes the latest step of the checkpoint directory
when there is one. An orbax checkpoint in <output_dir>/<exp_name>/ckpt
raises.
"""

from __future__ import annotations

import argparse
import logging
import os
import time

import numpy as np
import torch

from ..parallel.mesh import make_mesh
from ..parallel.dist import (add_distributed_args, is_main,
                             maybe_init_distributed_from_args)

logger = logging.getLogger("self6dpp_tpu_torch")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--init-pose-file", default="",
                   help="taken and not read, as by the JAX CLI: the eval "
                        "starts from the ground truth plus noise")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-npz", default="",
                   help="flat .npz of JAX-layout DeepIM weights loaded over "
                        "the seeded init (strict=False)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def draw_noise(rng: np.random.Generator, n: int):
    """n rotation perturbations (euler xyz ~ N(0, 15 deg)) and translation
    offsets (N(0, (1, 1, 5) cm)), drawn in that order."""
    return (rng.normal(0, 15, (n, 3)),
            rng.normal(0, [0.01, 0.01, 0.05], (n, 3)))


def noisy_init(raw: dict, rng: np.random.Generator) -> dict:
    """raw with init_rot, init_trans: its ground truth perturbed by
    draw_noise."""
    from scipy.spatial.transform import Rotation
    euler, dt = draw_noise(rng, len(raw["gt_rot"]))
    dR = Rotation.from_euler("xyz", euler, degrees=True).as_matrix()
    raw["init_rot"] = (dR @ raw["gt_rot"]).astype(np.float32)
    raw["init_trans"] = (raw["gt_trans"] + dt).astype(np.float32)
    return raw


def deepim_inputs(batch: dict, models, device) -> dict[str, torch.Tensor]:
    """The eval step's batch from a loader batch (the JAX CLI's to_device):
    per-class verts, faces and colours, K, the ROI crop as the observation
    and the detection box as obs_box."""
    from ..engine.evaluator import to_device
    db = to_device(batch, device)
    cls = db["roi_cls"].long()
    for k in ("verts", "faces", "colors"):
        db[k] = torch.as_tensor(getattr(models, k), device=device)[cls]
    db["K"] = db["roi_cam"]
    db["obs_img"] = db.pop("roi_img")
    db["obs_box"] = torch.cat([db["roi_center"] - db["roi_wh"] / 2,
                               db["roi_center"] + db["roi_wh"] / 2], dim=1)
    return db


def eval_fn_of(cfg, model, dev, impl: str):
    """eval_fn(state) -> tables for the trainer: the test split from the
    fixed perturbation (default_rng(0) for every batch, as the JAX CLI
    draws it), n_iter_test refine iterations, the pose evaluator."""
    from ..engine import deepim_engine as de
    from ..engine.evaluator import PoseEvaluator, run_inference
    from .train_gdrn import build_dataset
    ds_t, models_t, meta_t = build_dataset(cfg, train=False, device=dev,
                                           impl=impl)
    estep = de.make_eval_step(cfg, model, device=dev,
                              raster_kw={"impl": impl})

    def eval_fn(st):
        ev = PoseEvaluator(models_t, meta_t, device=dev, impl=impl)
        batches = (noisy_init(raw, np.random.default_rng(0))
                   for raw in ds_t.batches(cfg.solver.ims_per_batch))
        run_inference(estep, batches, ev,
                      to_device_fn=lambda b: deepim_inputs(b, models_t, dev),
                      device=dev)
        return ev.evaluate()
    return eval_fn


def train(args, cfg, dev, impl: str) -> dict:
    """The training run of main: returns {'state', 'timings', 'metrics'}
    (as tools/train_gdrn.train)."""
    from ..engine import deepim_engine as de
    from ..engine.checkpoint import check_no_orbax_steps, load_params_npz
    from ..engine.trainer import do_train
    from .train_gdrn import build_dataset, ckpt_dir, loop_timings

    check_no_orbax_steps(ckpt_dir(cfg))
    ds, models, _ = build_dataset(cfg, train=True, device=dev, impl=impl)
    rng = np.random.default_rng(cfg.seed)
    batches = (noisy_init(raw, rng)
               for raw in ds.batches(cfg.solver.ims_per_batch))
    # the JAX CLI takes its first batch to initialise the state
    next(batches)
    model = de.build_deepim(cfg, dev, train=True,
                            generator=torch.Generator().manual_seed(cfg.seed))
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
    state = de.init_state(cfg, model)
    raster_kw = {"impl": impl}
    if cfg.deepim.n_iter_train_warm_iters > 0:
        # the refine-count ramp: one step per count, built at first use
        steps: dict[int, object] = {}

        def step(state, batch):
            n = de.warm_n_iter(cfg.deepim, state.step)
            if n not in steps:
                steps[n] = de.make_train_step(cfg, model, n_iter=n,
                                              device=dev, raster_kw=raster_kw)
            return steps[n](state, batch)
    else:
        step = de.make_train_step(cfg, model, device=dev,
                                  raster_kw=raster_kw)
    eval_fn = eval_fn_of(cfg, model, dev, impl) \
        if cfg.test.eval_period > 0 else None
    timings: list[dict] = []
    state = do_train(cfg, state, step, batches,
                     lambda b: deepim_inputs(b, models, dev),
                     eval_fn=eval_fn, resume=args.resume, timings=timings)
    return {"state": state, "timings": loop_timings(ds, timings),
            "metrics": os.path.join(cfg.output_dir, cfg.exp_name,
                                    "metrics.json")}


def main(argv=None, device=None, impl: str = "kernel") -> dict:
    """Training returns train()'s dict; --eval-only returns {'tables',
    'results', 'timings' (per batch: the loader's host and label-render
    seconds, the wait and step seconds of run_inference), 'evaluate_s'} on
    rank 0 ({} on the others under --dist-*). device: the default of
    --device; impl: the fine stage of every render ('kernel' or
    'plain')."""
    from .. import resolve_device
    from ..config import apply_overrides, load_config
    from ..engine import deepim_engine as de
    from ..engine.checkpoint import load_params_npz
    from ..engine.evaluator import (PoseEvaluator, run_inference,
                                    table_to_markdown)
    from ..engine.writers import setup_logger
    from .train_gdrn import build_dataset, ckpt_dir, load_latest_weights

    args = parse_args(argv)
    dev = maybe_init_distributed_from_args(
        args, resolve_device(args.device or device))
    cfg = apply_overrides(load_config(args.config), args.opts)
    # the (data, fsdp) rank grid of dist.mesh_shape, before any loader
    # takes its share of the records (parallel/mesh.py)
    make_mesh(cfg.dist)
    setup_logger(os.path.join(cfg.output_dir, cfg.exp_name))
    if args.init_pose_file:
        logger.warning(f"--init-pose-file {args.init_pose_file} is not read: "
                       "as the JAX CLI, the eval starts from the ground "
                       "truth plus noise")
    if not args.eval_only:
        return train(args, cfg, dev, impl)
    if not is_main():
        return {}

    ds, models, meta = build_dataset(cfg, train=False, device=dev, impl=impl)
    model = de.build_deepim(cfg, dev,
                            generator=torch.Generator().manual_seed(cfg.seed))
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
    else:
        load_latest_weights(ckpt_dir(cfg), model)
    rng = np.random.default_rng(cfg.seed)
    # the JAX CLI draws the noise of one batch for its init batch first
    draw_noise(rng, cfg.solver.ims_per_batch)

    step = de.make_eval_step(cfg, model, device=dev,
                             raster_kw={"impl": impl})
    ev = PoseEvaluator(models, meta, device=dev, impl=impl)
    batches = (noisy_init(raw, rng)
               for raw in ds.batches(cfg.solver.ims_per_batch))
    run_inference(step, batches, ev,
                  to_device_fn=lambda b: deepim_inputs(b, models, dev),
                  device=dev)
    t0 = time.perf_counter()
    tables = ev.evaluate()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    evaluate_s = time.perf_counter() - t0
    print(table_to_markdown(tables))
    timings = [{**a, **b} for a, b in zip(ds.timings, ev.timings)]
    return {"tables": tables, "results": ev.results_for_csv(),
            "timings": timings, "evaluate_s": evaluate_s}


if __name__ == "__main__":
    main()
