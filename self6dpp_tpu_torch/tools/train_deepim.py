"""DeepIM test CLI (port of tools/train_deepim.py --eval-only, what
test_deepim.sh runs): each test instance's initial pose is its ground
truth plus noise (15 deg rotation, (1, 1, 5) cm translation std, drawn
from default_rng(cfg.seed) in the JAX CLI's order), refined n_iter_test
times (engine/deepim_engine.py: a render through kernel B1 per iteration
on the card with impl="kernel"); prints the recall tables as markdown.

    python -m self6dpp_tpu_torch.tools.train_deepim \\
        --config configs/deepim/lm_flownet.py --eval-only \\
        [--init-npz WEIGHTS.npz] [--opts k=v ...] [--device cpu]

Weights: --init-npz (the JAX DeepIM's flat .npz) over the seeded init; an
orbax checkpoint in <output_dir>/<exp_name>/ckpt raises (the JAX CLI
resumes from it). Training belongs to the training slice and raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--init-npz", default="",
                   help="flat .npz of JAX-layout DeepIM weights loaded over "
                        "the seeded init (strict=False)")
    p.add_argument("--opts", nargs="*", default=[])
    p.add_argument("--device", default=None, help="default: cuda")
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


def main(argv=None, device=None, impl: str = "kernel") -> dict:
    """Returns {'tables', 'results', 'timings' (per batch: the loader's
    host and label-render seconds, the wait and step seconds of
    run_inference), 'evaluate_s'}. device: the default of --device; impl:
    the fine stage of every render ('kernel' or 'plain')."""
    from .. import resolve_device
    from ..config import apply_overrides, load_config
    from ..engine import deepim_engine as de
    from ..engine.checkpoint import load_params_npz
    from ..engine.evaluator import (PoseEvaluator, run_inference,
                                    table_to_markdown)
    from .train_gdrn import build_dataset, check_no_orbax_steps

    args = parse_args(argv)
    if not args.eval_only:
        raise NotImplementedError(
            "DeepIM training belongs to the training slice (train_deepim.sh "
            "end to end); run with --eval-only")
    dev = resolve_device(args.device or device)
    cfg = apply_overrides(load_config(args.config), args.opts)

    ds, models, meta = build_dataset(cfg, train=False, device=dev, impl=impl)
    model = de.build_deepim(cfg, dev,
                            generator=torch.Generator().manual_seed(cfg.seed))
    if args.init_npz:
        load_params_npz(args.init_npz, model, strict=False)
    check_no_orbax_steps(cfg)
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
