import json

import pytest
import torch

from portbench import harness
from portbench.tests import tiny


@pytest.fixture(scope="session", autouse=True)
def one_thread():
    # the CPU build's oneDNN convolution backward is not safe on several
    # threads beside other test workers
    torch.set_num_threads(1)


@pytest.fixture
def base(tmp_path):
    return tiny.write_base(str(tmp_path))


@pytest.fixture
def run(base, capsys):
    """run(workload, step_wrapper=None, bench=None) -> (exit code, the
    result line as a dict, or None): one CPU run of a test cell, 1 s."""
    def go(workload, step_wrapper=None, bench=None, seed=3_000_000_019):
        rc = harness.main(["--workload", workload, "--seed", str(seed),
                           "--seconds", "1", "--trace", "0"], device="cpu",
                          step_wrapper=step_wrapper,
                          bench=bench or tiny.bench(), base=base)
        lines = capsys.readouterr().out.strip().splitlines()
        return rc, json.loads(lines[-1]) if rc == 0 and lines else None
    return go
