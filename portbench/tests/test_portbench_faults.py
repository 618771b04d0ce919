"""The timed path broken underneath a run that skips only the look for a
card: `correct` comes out false for each fault a cell can have, and the
control (the reference one precision below, float8 matrix products) reads
above the cell's limits."""

import math

import pytest
import torch

from portbench import calibrate, compare, harness
from portbench.kinds import deepim_refine, gdrn_train
from portbench.tests import tiny


def unchanged(step):
    """A step that returns its state unchanged (parameters, teacher and
    statistics put back)."""
    def broken(state, batch, mark=None, **kw):
        keep = [t.detach().clone() for t in _state_tensors(state)]
        state, metrics = step(state, batch, mark, **kw)
        with torch.no_grad():
            for t, k in zip(_state_tensors(state), keep):
                t.copy_(k)
        return state, metrics
    return broken


def _state_tensors(state):
    out = list(state.model.parameters()) + list(state.model.buffers())
    return out + (list(state.teacher.parameters())
                  if state.teacher is not None else [])


@pytest.mark.parametrize("workload", ["t.selfsup", "t.supervised"])
@pytest.mark.parametrize("fault", [unchanged, gdrn_train.half_batch,
                                   gdrn_train.wrong_lr],
                         ids=["unchanged", "half_batch", "wrong_lr"])
def test_training_fault_is_not_correct(run, workload, fault):
    rc, res = run(workload, step_wrapper=fault)
    assert rc == 0
    assert res["correct"] is False, res["checks"]


def test_unchanged_state_reads_one_on_change(run):
    rc, res = run("t.selfsup", step_wrapper=unchanged)
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_altered_answer_is_not_correct(run):
    rc, res = run("t.refine", step_wrapper=deepim_refine.turned_answer)
    assert rc == 0
    assert res["correct"] is False
    assert res["checks"]["rot_gap_deg"]["value"] == pytest.approx(1.0,
                                                                  rel=1e-3)


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_control_reads_above_the_limits(base, workload):
    import os
    from portbench.harness import read_json
    c, t = tiny.CELLS[workload]
    config = read_json(os.path.join(base, "configs", c + ".json"))
    traffic = read_json(os.path.join(base, "traffic", t + ".json"))
    cell = harness.make_cell(config, traffic, 3_000_000_023,
                             torch.device("cpu"), base)
    cell.setup()
    cell.calibration_window(0.5)
    cell.free_program()
    read = calibrate.reading(cell, control_ref=True)
    ok, _ = compare.judge(read["program"], traffic["limits"])
    assert ok
    bad, checks = compare.judge(read["control"], traffic["limits"])
    assert not bad, checks
    assert any(math.isfinite(v["value"]) and v["value"] > v["limit"]
               for v in checks.values())
