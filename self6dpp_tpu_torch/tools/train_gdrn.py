"""GDR-Net train/test CLI (port of tools/train_gdrn.py, what train_gdrn.sh
and test_gdrn.sh run).

Training: the config's first train dataset through the train-mode loader
(augmentation, the configured sampler, labels rendered through kernel B1
on the card), the stage-I step (engine/gdrn_engine.py) and the trainer
(engine/trainer.py: checkpoints in <output_dir>/<exp_name>/ckpt,
metrics.json), with the test split evaluated every test.eval_period
iterations. --eval-only: the test split through the eval loader, the eval
step and the pose evaluator; prints the recall tables as markdown and
writes <output_dir>/<exp_name>/results-bop.csv.

    python -m self6dpp_tpu_torch.tools.train_gdrn \\
        --config configs/gdrn/lm_base.py [--eval-only] [--resume] \\
        [--det-file DETS.json] [--init-npz WEIGHTS.npz] [--opts k=v ...] \\
        [--device cpu] \\
        [--dist-coordinator HOST:PORT --dist-nprocs N --dist-rank R]

--dist-*: training data parallel over N processes, each rank feeding its
own ims_per_batch (parallel/dist.py); --eval-only runs on rank 0.

Weights: --init-npz (the JAX package's flat .npz, engine/checkpoint.py)
over the seeded init (cfg.seed); the student and the teacher start from
them. Without it, --eval-only takes the latest step of the checkpoint
directory when there is one. A checkpoint directory with orbax steps (the
JAX CLIs') raises.
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..parallel.dist import (add_distributed_args, is_main,
                             maybe_init_distributed_from_args)


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--det-file", default="", help="test detections json")
    p.add_argument("--init-npz", default="",
                   help="flat .npz of JAX-layout weights loaded over the "
                        "seeded init (strict=False)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
    add_distributed_args(p)
    return p.parse_args(argv)


def build_dataset(cfg, train: bool = False, det_file: str = "",
                  dataset_names: tuple[str, ...] | None = None,
                  device=None, impl: str = "kernel"):
    """(GDRNDataset, ObjectModels, DatasetMeta) of the config's first test
    dataset: its BOP split, the detections injected when det_file is
    given, the PLY models of the meta's objects."""
    from ..data.bop import inject_detections, load_bop_split, load_detections
    from ..data.loader import GDRNDataset, ObjectModels
    from ..data.ref import get_meta

    names = dataset_names if dataset_names else (
        cfg.data.train_datasets if train else cfg.data.test_datasets)
    meta = get_meta(names[0])
    split = "train" if train else "test"
    split_dir = os.path.join(cfg.data.dataset_root, meta.name, split)
    obj_ids = None
    if cfg.data.object_filter:
        obj_ids = {meta.obj2id[o] for o in cfg.data.object_filter}
    records = load_bop_split(split_dir, obj_ids=obj_ids,
                             visib_thresh=cfg.data.filter_visib_thr)
    if det_file:
        records = inject_detections(records, load_detections(det_file),
                                    top_k_per_obj=cfg.data.det_topk_per_obj,
                                    score_thresh=cfg.data.det_thresh)
    models = ObjectModels.from_ply_files(
        meta.objects,
        [meta.model_path(cfg.data.dataset_root, o) for o in meta.objects],
        n_regions=cfg.model.geo_head.num_regions,
        n_points=cfg.data.model_points, max_sym=cfg.data.max_sym_rots,
        sym_names=meta.sym_objects)
    return GDRNDataset(cfg, records, models, meta, train=train,
                       seed=cfg.seed, device=device, impl=impl), models, meta


def ckpt_dir(cfg) -> str:
    return os.path.join(cfg.output_dir, cfg.exp_name, "ckpt")


def load_latest_weights(directory: str, model) -> bool:
    """The student's weights of the latest step of a checkpoint directory
    into `model`, when there is a step; returns whether there was. Raises
    on orbax steps."""
    from ..engine.checkpoint import (check_no_orbax_steps, load_params_npz,
                                     step_dirs)
    check_no_orbax_steps(directory)
    steps = step_dirs(directory)[0]
    if steps:
        load_params_npz(os.path.join(directory, str(steps[-1]),
                                     "model.npz"), model)
    return bool(steps)


def loop_timings(ds, timings: list[dict]) -> list[dict]:
    """Per iteration of the training loop: the trainer's wait and step
    seconds beside the loader's host and label-render seconds of its
    batch (the loader builds one batch ahead of the loop for the init)."""
    return [{**a, **b} for a, b in zip(ds.timings[1:], timings)]


def evaluate_fn(cfg, model, det_file: str, device, impl: str,
                use_ema: bool = False):
    """eval_fn(state) -> tables for the trainer: the test split through
    the eval step (the teacher's with use_ema) and the pose evaluator."""
    from ..engine import gdrn_engine as eng
    from ..engine.evaluator import PoseEvaluator, run_inference
    ds_t, models_t, meta_t = build_dataset(cfg, train=False,
                                           det_file=det_file, device=device,
                                           impl=impl)
    estep = eng.make_eval_step(cfg, model, use_ema=use_ema)

    def eval_fn(st):
        ev = PoseEvaluator(models_t, meta_t, device=device, impl=impl)
        run_inference(lambda db: estep(st, db),
                      ds_t.batches(cfg.solver.ims_per_batch), ev,
                      device=device)
        return ev.evaluate()
    return eval_fn


def train(args, cfg, dev, impl: str) -> dict:
    """The training run of main: returns {'state', 'timings', 'metrics'
    (the path of metrics.json)}."""
    from ..engine import gdrn_engine as eng
    from ..engine.checkpoint import check_no_orbax_steps, load_params_npz
    from ..engine.evaluator import to_device
    from ..engine.trainer import do_train

    check_no_orbax_steps(ckpt_dir(cfg))
    ds, _, _ = build_dataset(cfg, train=True, device=dev, impl=impl)
    batches = ds.batches(cfg.solver.ims_per_batch)
    # the JAX CLI takes its first batch to initialise the state
    next(batches)
    model = eng.build_gdrn(cfg, dev, seed=cfg.seed)
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
    state = eng.init_state(cfg, model)
    eval_fn = None
    if cfg.test.eval_period > 0:
        eval_fn = evaluate_fn(cfg, model, args.det_file, dev, impl)
    timings: list[dict] = []
    state = do_train(cfg, state, eng.make_train_step(cfg, model), batches,
                     lambda b: to_device(b, dev), eval_fn=eval_fn,
                     resume=args.resume, timings=timings)
    return {"state": state, "timings": loop_timings(ds, timings),
            "metrics": os.path.join(cfg.output_dir, cfg.exp_name,
                                    "metrics.json")}


def main(argv=None, device=None, impl: str = "kernel") -> dict:
    """Training returns train()'s dict; --eval-only returns {'tables',
    'results' (the CSV's rows), 'csv', 'timings' (per batch: the loader's
    host and label-render seconds, the wait and step seconds of
    run_inference), 'evaluate_s'}, on rank 0 ({} on the others: --dist-*
    runs training data parallel, parallel/dist.py). device: the default of
    --device; impl: the fine stage of every render ('kernel' or
    'plain')."""
    from .. import resolve_device
    from ..config import Config, apply_overrides, load_config
    from ..engine import gdrn_engine as eng
    from ..engine.checkpoint import load_params_npz
    from ..engine.evaluator import (PoseEvaluator, run_inference,
                                    save_bop_csv, table_to_markdown)
    from ..engine.train_state import TrainState
    from ..engine.writers import setup_logger

    args = parse_args(argv)
    dev = maybe_init_distributed_from_args(
        args, resolve_device(args.device or device))
    cfg: Config = apply_overrides(load_config(args.config), args.opts)
    setup_logger(os.path.join(cfg.output_dir, cfg.exp_name))
    if not args.eval_only:
        return train(args, cfg, dev, impl)
    if not is_main():
        return {}

    ds, models, meta = build_dataset(cfg, train=False, det_file=args.det_file,
                                     device=dev, impl=impl)
    model = eng.build_gdrn(cfg, dev, seed=cfg.seed)
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
    else:
        load_latest_weights(ckpt_dir(cfg), model)
    state = TrainState(step=0, model=model, teacher=None, opt=None)
    step = eng.make_eval_step(cfg, model)
    ev = PoseEvaluator(models, meta, device=dev, impl=impl)
    run_inference(lambda db: step(state, db),
                  ds.batches(cfg.solver.ims_per_batch), ev, device=dev)
    # the BOP19 VSD/MSSD/MSPD average recalls when the config's error
    # types ask for them
    bop19 = bool({"vsd", "mssd", "mspd"} & set(cfg.test.error_types))
    t0 = time.perf_counter()
    tables = ev.evaluate(bop19=bop19)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    evaluate_s = time.perf_counter() - t0
    print(table_to_markdown(tables))
    csv = os.path.join(cfg.output_dir, cfg.exp_name, "results-bop.csv")
    save_bop_csv(csv, ev.results_for_csv())
    timings = [{**a, **b} for a, b in zip(ds.timings, ev.timings)]
    return {"tables": tables, "results": ev.results_for_csv(), "csv": csv,
            "timings": timings, "evaluate_s": evaluate_s}


if __name__ == "__main__":
    main()
