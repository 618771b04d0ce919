"""What a run loads: no module whose top-level name is jax, jaxlib, flax
or self6dpp_tpu (compared whole: self6dpp_tpu_torch is the port), and the
reference loads nothing of the port."""

import json
import os
import subprocess
import sys

from portbench import harness

ROOT = harness.root_dir()
RUN = """
import json, sys, torch
torch.set_num_threads(1)
from portbench import harness
from portbench.tests import tiny
base = tiny.write_base(sys.argv[1])
for w in sorted(tiny.CELLS):
    assert harness.main(["--workload", w, "--seed", "5", "--seconds", "0.2",
                         "--trace", "0"], device="cpu", bench=tiny.bench(),
                        base=base) == 0
import portbench.calibrate, portbench.trace, portbench.readers
for m in json.load(open("BENCHMARK.json"))["per_layer"]:
    harness.load_reader(m["name"])
print("TOP", json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
REFERENCE = """
import json, pkgutil, importlib, sys
import portbench.reference as r
for m in pkgutil.walk_packages(r.__path__, "portbench.reference."):
    importlib.import_module(m.name)
print("TOP", json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def top_level(code, *args):
    out = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("TOP ")][-1]
    return set(json.loads(line[4:]))


def test_a_run_loads_no_jax(tmp_path):
    top = top_level(RUN, str(tmp_path))
    assert "self6dpp_tpu_torch" in top and "portbench" in top
    assert not top & set(harness.BANNED)


def test_reference_loads_nothing_of_the_port():
    top = top_level(REFERENCE)
    assert not top & (set(harness.BANNED) | {"self6dpp_tpu_torch"})
