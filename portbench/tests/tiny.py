"""Test-size cells of each traffic kind, written as files into a directory
laid out as portbench/ is (configs/, traffic/, kinds/, metrics/), with a
bench dict naming them: what the tests drive on the CPU."""

from __future__ import annotations

import json
import os
import shutil

LIMITS_TRAIN = {"loss_gap": 1e-3, "grad_gap": 1e-3, "grad_upper_half_gap": 1e-3,
                "change_gap": 1e-3}
CELLS = {
    "t.selfsup": ("tiny_gdrn", "tiny_selfsup"),
    "t.supervised": ("tiny_gdrn", "tiny_supervised"),
    "t.refine": ("tiny_deepim", "tiny_refine"),
}
FILES = {
    "configs/tiny_gdrn.json": {
        "name": "tiny_gdrn",
        "sizes": {"model.input_res": 64, "model.output_res": 16,
                  "model.num_classes": 2},
        "meshes": {"subdivisions": 1, "radius": 0.06, "colors": "position"}},
    "configs/tiny_deepim.json": {
        "name": "tiny_deepim",
        "sizes": {"deepim.input_h": 64, "deepim.num_classes": 2},
        "meshes": {"subdivisions": 1, "radius": [0.04, 0.1],
                   "colors": "normal_tint"}},
    "traffic/tiny_selfsup.json": {
        "kind": "gdrn_train", "stage": 2, "recipe": "stage2_pose_tiny",
        "overrides": [], "rois": 4, "pool": 4, "check_steps": 3,
        "teacher_offset": 0.1, "step_count": 8000, "solver_count": 10,
        "render_block": 2, "profiled_seconds": 1, "profiled_steps": 2,
        "limits": dict(LIMITS_TRAIN, teacher_change_gap=1e-3,
                       change_median_leaf_gap=1e-3)},
    "traffic/tiny_supervised.json": {
        "kind": "gdrn_train", "stage": 1, "recipe": "gdrn_synthetic_smoke",
        "overrides": ["dist.compute_dtype=float32"], "rois": 4, "pool": 4,
        "check_steps": 3, "render_block": 4, "profiled_seconds": 1,
        "profiled_steps": 2,
        "limits": dict(LIMITS_TRAIN, stats_change_gap=1e-3)},
    "traffic/tiny_refine.json": {
        "kind": "deepim_refine", "recipe": "deepim_synthetic_smoke",
        "overrides": ["dist.compute_dtype=float32"], "rois": 2, "pool": 4,
        "frame_hw": [120, 160], "center_px": [50.0, 70.0],
        "rot_noise_deg": 15.0, "trans_noise_m": [0.01, 0.01, 0.05],
        "render_block": 8, "warmup_requests": 1, "sample": 3,
        "profiled_seconds": 1, "profiled_steps": 2,
        "limits": {"rot_gap_deg": 1e-3, "center_gap_px": 1e-3}},
}


def bench() -> dict:
    e2e = [{"name": "train_rois_per_s", "unit": "rois/s",
            "workloads": ["t.selfsup", "t.supervised"]},
           {"name": "refine_ms_p50", "unit": "ms", "workloads": ["t.refine"]},
           {"name": "refine_ms_p95", "unit": "ms", "workloads": ["t.refine"]},
           {"name": "peak_mem_gib", "unit": "GiB"},
           {"name": "setup_s", "unit": "s"}]
    return {"workloads": [{"name": n, "config": c, "traffic": t, "chips": 1}
                          for n, (c, t) in CELLS.items()],
            "end_to_end": e2e, "per_layer": []}


def write_base(root: str) -> str:
    """The test cells' files under root; the benchmark's own kinds and
    metric readers beside them."""
    for rel, data in FILES.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            json.dump(data, f)
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for folder in ("kinds", "metrics"):
        shutil.copytree(os.path.join(here, folder),
                        os.path.join(root, folder), dirs_exist_ok=True)
    return root
