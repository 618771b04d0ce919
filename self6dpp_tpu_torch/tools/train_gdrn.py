"""GDR-Net test CLI (port of tools/train_gdrn.py --eval-only, what
test_gdrn.sh runs): the config's test split through the eval loader, the
GDRN eval step and the pose evaluator; prints the recall tables as
markdown and writes <output_dir>/<exp_name>/results-bop.csv.

    python -m self6dpp_tpu_torch.tools.train_gdrn \\
        --config configs/gdrn/lm_base.py --eval-only \\
        [--det-file DETS.json] [--init-npz WEIGHTS.npz] [--opts k=v ...] \\
        [--device cpu]

Weights: --init-npz (the JAX package's flat .npz, engine/checkpoint.py);
without it, the seeded init (cfg.seed) when the checkpoint directory holds
no orbax step, and an error when it does (orbax is not ported). Training
(no --eval-only) belongs to the training slice and raises.
"""

from __future__ import annotations

import argparse
import os
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--det-file", default="", help="test detections json")
    p.add_argument("--init-npz", default="",
                   help="flat .npz of JAX-layout weights loaded over the "
                        "seeded init (strict=False)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
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


def check_no_orbax_steps(cfg) -> None:
    """Raise when <output_dir>/<exp_name>/ckpt holds orbax steps: the JAX
    CLIs would resume from them, and the port cannot read them."""
    d = os.path.join(cfg.output_dir, cfg.exp_name, "ckpt")
    steps = [s for s in os.listdir(d) if s.isdigit()] \
        if os.path.isdir(d) else []
    if steps:
        raise RuntimeError(
            f"{d} holds orbax checkpoint steps {sorted(steps)[:4]}, which "
            "the port does not read; export them with the JAX package's "
            "save_params_npz and pass --init-npz")


def main(argv=None, device=None, impl: str = "kernel") -> dict:
    """Returns {'tables', 'results' (the CSV's rows), 'csv', 'timings'
    (per batch: the loader's host and label-render seconds, the wait and
    step seconds of run_inference), 'evaluate_s'}. device: the default of
    --device; impl: the fine stage of every render ('kernel' or
    'plain')."""
    from .. import resolve_device
    from ..config import Config, apply_overrides, load_config
    from ..engine import gdrn_engine as eng
    from ..engine.checkpoint import load_params_npz
    from ..engine.evaluator import (PoseEvaluator, run_inference,
                                    save_bop_csv, table_to_markdown)
    from ..engine.train_state import TrainState

    args = parse_args(argv)
    if not args.eval_only:
        raise NotImplementedError(
            "GDRN training belongs to the training slice (train_gdrn.sh end "
            "to end); run with --eval-only")
    dev = resolve_device(args.device or device)
    cfg: Config = apply_overrides(load_config(args.config), args.opts)

    ds, models, meta = build_dataset(cfg, train=False, det_file=args.det_file,
                                     device=dev, impl=impl)
    model = eng.build_gdrn(cfg, dev, seed=cfg.seed)
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
    else:
        check_no_orbax_steps(cfg)
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
