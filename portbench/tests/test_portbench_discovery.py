"""A new configuration, traffic mix, per-layer metric, traffic kind (its
driver, end-to-end values and faults) and reference recipe are taken by
adding files and BENCHMARK.json entries only: the harness finds each by
the name the entry gives."""

import json
import os

import torch

from portbench import calibrate, cells, compare, harness
from portbench.tests import tiny

READER = '''
def read(ctx):
    return 2.0 * ctx.phase_ms["forward"]
'''


def test_new_files_are_found_by_name(base, run):
    with open(os.path.join(base, "configs", "tiny_gdrn.json")) as f:
        config = json.load(f)
    config["name"] = "throwaway_cfg"
    with open(os.path.join(base, "configs", "throwaway_cfg.json"), "w") as f:
        json.dump(config, f)
    with open(os.path.join(base, "traffic", "tiny_supervised.json")) as f:
        traffic = json.load(f)
    traffic["rois"] = 2
    with open(os.path.join(base, "traffic", "throwaway_mix.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(base, "metrics", "throwaway.forward_x2.py"),
              "w") as f:
        f.write(READER)
    bench = tiny.bench()
    bench["workloads"].append({"name": "throwaway.cell",
                               "config": "throwaway_cfg",
                               "traffic": "throwaway_mix", "chips": 1})
    bench["end_to_end"][0]["workloads"].append("throwaway.cell")
    bench["per_layer"].append({"name": "throwaway.forward_x2", "unit": "ms",
                               "moves": "train_rois_per_s",
                               "workloads": ["throwaway.cell"]})

    rc, res = run("throwaway.cell", bench=bench)
    assert rc == 0 and res["correct"] is True
    assert set(res["metrics"]) == {"train_rois_per_s", "peak_mem_gib",
                                   "setup_s"}
    names = [m["name"] for m in harness.cell_metrics(bench, "per_layer",
                                                     "throwaway.cell")]
    assert names == ["throwaway.forward_x2"]
    read = harness.load_reader("throwaway.forward_x2", base)
    assert read(harness.Context(phase_ms={"forward": 1.5})) == 3.0
    assert harness.cell_metrics(bench, "per_layer", "t.selfsup") == []


KIND = '''"""Stage-II steps on gdrn_train's driver, with an end-to-end value
and a list of faults of their own."""

from portbench.kinds.gdrn_train import GdrnTrain, half_batch


class StepsPerSecond(GdrnTrain):
    faults = (("half_batch", half_batch),)

    def end_to_end(self, res):
        return {"throwaway_steps_per_s": res["steps"] / res["seconds"]}


DRIVER = StepsPerSecond
'''
RECIPE = '''"""stage2_pose_tiny at twice its learning rate."""

from portbench.reference import config


def get_config():
    return config.apply_overrides(config.stage2_pose_tiny(),
                                  ["solver.base_lr=0.002"])
'''


def _write(base, rel, text):
    path = os.path.join(base, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def test_new_kind_and_recipe_are_found_by_name(base, run, monkeypatch):
    # the port's recipe of the same name; a real configuration finds it in
    # self6dpp_tpu_torch/config.py
    from self6dpp_tpu_torch import config as C
    monkeypatch.setattr(C, "throwaway_recipe", lambda: C.apply_overrides(
        C.stage2_pose_tiny(), ["solver.base_lr=0.002"]), raising=False)
    _write(base, "kinds/throwaway_kind.py", KIND)
    _write(base, "reference/recipes/throwaway_recipe.py", RECIPE)
    with open(os.path.join(base, "traffic", "tiny_selfsup.json")) as f:
        traffic = json.load(f)
    traffic.update(kind="throwaway_kind", recipe="throwaway_recipe")
    _write(base, "traffic/throwaway_mix.json", json.dumps(traffic))
    bench = tiny.bench()
    bench["workloads"].append({"name": "throwaway.cell",
                               "config": "tiny_gdrn",
                               "traffic": "throwaway_mix", "chips": 1})
    bench["end_to_end"].append({"name": "throwaway_steps_per_s",
                                "unit": "steps/s",
                                "workloads": ["throwaway.cell"]})
    assert cells.reference_config("throwaway_recipe", [],
                                  base).solver.base_lr == 0.002

    rc, res = run("throwaway.cell", bench=bench)
    assert rc == 0 and res["correct"] is True, res and res["checks"]
    assert set(res["metrics"]) == {"throwaway_steps_per_s", "peak_mem_gib",
                                   "setup_s"}
    assert res["metrics"]["throwaway_steps_per_s"]["value"] > 0

    with open(os.path.join(base, "configs", "tiny_gdrn.json")) as f:
        config = json.load(f)
    cpu, seed = torch.device("cpu"), 3_000_000_029
    cell = calibrate.program_run(config, traffic, seed, cpu, base=base)
    ref = calibrate.Reference(cell)
    ok, checks = compare.judge(ref.numbers(cell), traffic["limits"])
    assert ok, checks
    assert [name for name, _ in cell.faults] == ["half_batch"]
    for _, wrap in cell.faults:
        broken = calibrate.program_run(config, traffic, seed, cpu, wrap,
                                       base=base)
        bad, checks = compare.judge(ref.numbers(broken), traffic["limits"])
        assert not bad, checks


def test_a_listed_value_the_driver_omits_fails_by_its_name(base, capsys):
    bench = tiny.bench()
    bench["end_to_end"][1]["workloads"].append("t.supervised")
    rc = harness.main(["--workload", "t.supervised", "--seed", "5",
                       "--seconds", "0.5", "--trace", "0"], device="cpu",
                      bench=bench, base=base)
    out = capsys.readouterr()
    assert rc != 0
    assert "refine_ms_p50" in out.err
    assert '"correct"' not in out.out


def test_metric_without_workloads_follows_its_moves():
    bench = tiny.bench()
    bench["per_layer"].append({"name": "every_refine_cell", "unit": "ms",
                               "moves": "refine_ms_p50"})
    assert [m["name"] for m in harness.cell_metrics(
        bench, "per_layer", "t.refine")] == ["every_refine_cell"]
    assert harness.cell_metrics(bench, "per_layer", "t.selfsup") == []


def test_every_benchmark_metric_has_a_reader():
    root = harness.root_dir()
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for w in bench["workloads"]:
        assert os.path.exists(os.path.join(harness.HERE, "configs",
                                           w["config"] + ".json"))
        traffic = harness.read_json(os.path.join(harness.HERE, "traffic",
                                                 w["traffic"] + ".json"))
        assert issubclass(harness.load_kind(traffic["kind"]), cells.Driver)
