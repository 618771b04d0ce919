"""A test-size cell of kind gdrn_refined on the CPU: stage2_pose_tiny's
step with a float32 DeepIM refiner (deepim_synthetic_smoke's: 64² zoom,
2 iterations) in the loop, built through build_refiner_of from
self_sup.refiner_config. A run is `correct` against reference/refined.py;
half the batch, a learning rate 1.3 times and the refiner built with 3
iterations each fail it. The bench and the cell's files are made here,
beside tiny.write_base's."""

import dataclasses
import json
import os

import pytest

from portbench.kinds import gdrn_refined, gdrn_train
from portbench.tests import tiny

CELL = "t.selfsup_refined"
REFINER = "configs/deepim/synthetic_smoke.py"
FILES = {
    "configs/tiny_gdrn_refined.json": {
        "name": "tiny_gdrn_refined",
        "sizes": {"model.input_res": 64, "model.output_res": 16,
                  "model.num_classes": 2,
                  "self_sup.refine_with_deepim": True,
                  "self_sup.refiner_config": REFINER,
                  "refiner.deepim.input_h": 64,
                  "refiner.deepim.in_channels": 6,
                  "refiner.deepim.n_iter_test": 2,
                  "refiner.dist.compute_dtype": "float32"},
        "meshes": {"subdivisions": 1, "radius": 0.06, "colors": "position"}},
    "traffic/tiny_selfsup_refined.json": {
        "kind": "gdrn_refined", "stage": 2, "recipe": "stage2_pose_tiny",
        "overrides": ["self_sup.refine_with_deepim=True",
                      f"self_sup.refiner_config={REFINER}"],
        "refiner_recipe": "deepim_synthetic_smoke",
        "rois": 4, "pool": 4, "check_steps": 3, "teacher_offset": 0.1,
        "step_count": 8000, "solver_count": 10, "render_block": 2,
        "refine_block": 2, "profiled_seconds": 1, "profiled_steps": 2,
        "limits": dict(tiny.LIMITS_TRAIN, teacher_change_gap=1e-3,
                       change_median_leaf_gap=1e-3,
                       pseudo_rot_gap_deg=1e-3, pseudo_center_gap_px=1e-3)},
}


def bench() -> dict:
    b = tiny.bench()
    b["workloads"].append({"name": CELL, "config": "tiny_gdrn_refined",
                           "traffic": "tiny_selfsup_refined", "chips": 1})
    for m in b["end_to_end"]:
        if m["name"] == "train_rois_per_s":
            m["workloads"].append(CELL)
    return b


@pytest.fixture
def refined(base, monkeypatch):
    """The cell's files in the test base; the refiner's recipe in float32
    on the port's side (the reference computes in float32 anyway)."""
    from self6dpp_tpu_torch import config as C
    for rel, data in FILES.items():
        with open(os.path.join(base, rel), "w") as f:
            json.dump(data, f)
    smoke = C.CONFIGS[REFINER]
    monkeypatch.setitem(C.CONFIGS, REFINER, lambda: dataclasses.replace(
        smoke(), dist=C.DistConfig(compute_dtype="float32")))
    return base


def test_refined_port_matches_reference(refined, run):
    rc, res = run(CELL, bench=bench())
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert {"pseudo_rot_gap_deg", "pseudo_center_gap_px"} <= set(
        res["checks"])
    assert res["readings"]["pseudo_trans_gap_mm"] < 1e-3
    assert set(res["metrics"]) == {"train_rois_per_s", "peak_mem_gib",
                                   "setup_s"}


@pytest.mark.parametrize("fault", [gdrn_train.half_batch, gdrn_train.wrong_lr,
                                   gdrn_refined.refine_iters_3],
                         ids=["half_batch", "lr_x1.3", "refine_iters_3"])
def test_refined_fault_is_not_correct(refined, run, fault):
    rc, res = run(CELL, step_wrapper=fault, bench=bench())
    assert rc == 0
    assert res["correct"] is False, res["checks"]
    if fault is gdrn_refined.refine_iters_3:
        # it fails on the refined pose itself, not only through the
        # training numbers that the pose feeds
        c = res["checks"]["pseudo_rot_gap_deg"]
        assert c["value"] > c["limit"], res["checks"]


def test_kind_names_its_faults():
    names = [n for n, _ in gdrn_refined.DRIVER.faults]
    assert names == ["half_batch", "lr_x1.3", "refine_iters_3"]


def marked_trace(steps: int = 2):
    """A synthetic trace of `steps` refined steps, host µs from 0, 1000 a
    step: the marks' spin launches end student_fwd, render, network_fwd,
    render, network_fwd, refine, losses at 100, 200, ..., 700 (the step's
    start mark at 0); a cudaMalloc of 130 µs blocks the host for the last
    30 µs of each render."""
    from portbench.tests.test_portbench_spans import host, kernel
    names = ["student_fwd", "render", "network_fwd", "render",
             "network_fwd", "refine", "losses"]
    ev, corr = [], 0
    for k in range(steps):
        t0 = 1000 * k
        for i in range(len(names) + 1):
            corr += 1
            ev += [host("cudaLaunchKernel", t0 + 100 * i, corr=corr),
                   kernel("void spin_kernel(long)", t0 + 100 * i + 5, 1,
                          corr)]
        for a in (170, 370):
            ev.append(host("cudaMalloc", t0 + a, dur=130.0))
    return names, ev


def test_render_host_reader_splits_the_refined_step_by_its_mark_names():
    """refined.refiner_render_host_ms sums the step's two render phases
    (100 µs each, 30 of them blocked); the step's names cycle is not one
    of distinct phases, so the readers that split steps by the window's
    phase names (train.host_issue_ms) read nothing here."""
    import types
    from portbench import harness
    names, ev = marked_trace()
    cell = types.SimpleNamespace(traffic={"profiled_steps": 2},
                                 mark_names=names)
    ctx = types.SimpleNamespace(cell=cell, events=ev,
                                phase_ms=dict.fromkeys(names, 1.0))
    read = harness.load_reader("refined.refiner_render_host_ms")
    assert read(ctx) == pytest.approx(2 * 0.07)
    assert harness.load_reader("train.host_issue_ms")(
        types.SimpleNamespace(cell=cell, events=ev,
                              phase_ms=dict.fromkeys(names, 1.0))) is None
    cell.mark_names = None
    assert read(ctx) is None
