"""A new configuration, traffic mix and per-layer metric are taken by
adding files and BENCHMARK.json entries only: the harness finds each by
the name the entry gives."""

import json
import os

from portbench import harness
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
        assert os.path.exists(os.path.join(harness.HERE, "traffic",
                                           w["traffic"] + ".json"))
