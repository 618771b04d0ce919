"""Whole runs of the test cells on the CPU: the port's steps (their plain
kernel versions on CPU tensors) against the frozen reference, both in
float32, agree to rounding, and the result line has the contract's keys."""

import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("workload", sorted(tiny.CELLS))
def test_port_matches_reference(run, workload):
    rc, res = run(workload)
    assert rc == 0
    assert res["correct"] is True, res["checks"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    e2e = {m["name"] for m in tiny.bench()["end_to_end"]
           if workload in m.get("workloads", [workload])}
    assert set(res["metrics"]) == e2e
    assert all(m["value"] > 0 for k, m in res["metrics"].items()
               if k != "peak_mem_gib")


def test_same_seed_same_inputs(base):
    import torch
    from portbench import cells
    from portbench.harness import read_json
    import os
    cfg = read_json(os.path.join(base, "configs", "tiny_gdrn.json"))
    tr = read_json(os.path.join(base, "traffic", "tiny_selfsup.json"))
    a = cells.GdrnTrain(cfg, tr, 2 ** 31 + 5, torch.device("cpu"))._batches()
    b = cells.GdrnTrain(cfg, tr, 2 ** 31 + 5, torch.device("cpu"))._batches()
    c = cells.GdrnTrain(cfg, tr, 2 ** 31 + 6, torch.device("cpu"))._batches()
    assert all(torch.equal(x[k], y[k]) for x, y in zip(a, b) for k in x)
    assert not torch.equal(a[0]["roi_img"], c[0]["roi_img"])
    assert a[0]["roi_img"].shape == c[0]["roi_img"].shape


def test_teacher_offset_moves_every_element_by_its_leaf_rms():
    import torch
    from portbench import inputs
    g = torch.Generator().manual_seed(7)
    params = [torch.randn(4, 3, generator=g), torch.tensor([2.0, 0.0, 1.0]),
              torch.zeros(5)]
    before = [p.clone() for p in params]
    inputs.offset_teacher_(params, torch.Generator().manual_seed(11), 0.3)
    for p, b in zip(params, before):
        rms = b.square().mean().sqrt()
        assert torch.allclose((p - b).abs(), 0.3 * rms.expand_as(b),
                              atol=1e-6)
