"""The readings that a cell's limits are set from, taken on the card at the
cell's own size, in one process:

    python3 -m portbench.calibrate --workload <name> --seeds <n> \
        [--control-seeds <k>] [--fault-seeds <m>] [--out <file.json>]

For each of n seeds: the program's set-up (its checked first steps, or a
short window of requests), then the gaps between it and the float32
reference. On the first k seeds also the control, the reference computed
one precision below the configuration's bfloat16 (its networks in bfloat16
on float8 e4m3 matrix products and convolutions: `reference/steps.py`),
against the same float32 reference; and on the first m seeds each fault
the cell can have, planted in the program and read against the same
reference: training cells, half of each batch left out with the loss's
mean over the rest, and the solver's learning rate 1.3 times the
configured one; refinement, one ROI's answer altered where it is produced
(its refined rotation turned by 1 degree). A state left unchanged reads 1
by the change's measure and needs no run. The benchmark's own runs never
run this."""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import torch

from . import cells, compare, harness, inputs


def half_batch(step):
    """The training fault: each step sees the first half of its ROIs."""
    def broken(state, batch, mark=None, **kw):
        b = batch["roi_img"].shape[0]
        return step(state, inputs.take_rows(batch, slice(0, b // 2)), mark,
                    **kw)
    return broken


def turned_answer(step, degrees: float = 1.0):
    """The refinement fault: the first ROI's rotation turned by `degrees`
    about the camera's z axis where the answer is produced."""
    def broken(batch):
        out = dict(step(batch))
        rot = out["rot"].clone()
        a = math.radians(degrees)
        turn = torch.tensor([[math.cos(a), -math.sin(a), 0.0],
                             [math.sin(a), math.cos(a), 0.0],
                             [0.0, 0.0, 1.0]], device=rot.device)
        rot[0] = turn @ rot[0]
        out["rot"] = rot
        return out
    return broken


def wrong_lr(step, factor: float = 1.3):
    """A training fault in the solver: from the first step on, every
    update taken at `factor` times the configured learning rate."""
    def broken(state, batch, mark=None, **kw):
        if not getattr(state.opt, "_lr_fault", False):
            lr_fn = state.opt.lr_fn
            state.opt.lr_fn = lambda count: factor * lr_fn(count)
            state.opt._lr_fault = True
        return step(state, batch, mark, **kw)
    return broken


FAULTS = {"gdrn_train": (("half_batch", half_batch), ("lr_x1.3", wrong_lr)),
          "deepim_refine": (("turned_answer", turned_answer),)}


def program_run(config, traffic, seed, device, wrap=None):
    """A program's set-up (and a short window of requests), freed."""
    cell = cells.make_cell(config, traffic, seed, device)
    cell.setup(wrap)
    if isinstance(cell, cells.DeepimRefine):
        cell.run(traffic.get("calibrate_seconds", 3.0))
    cell.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return cell


class Reference:
    """The float32 reference's readings of one seed, taken once, and the
    gaps of any run of that seed to them."""

    def __init__(self, cell):
        self.train = isinstance(cell, cells.GdrnTrain)
        if self.train:
            self.ref = cell.reference_readings()
        else:
            picked = cell.sample()
            self.picked = [j for j, _, _ in picked]
            self.cams = cell.cameras(picked)
            self.ref = cell.reference_answers(picked)

    def numbers(self, cell) -> dict:
        if self.train:
            return compare.train_numbers(cell.readings, self.ref)
        picked = cell.sample()
        if [j for j, _, _ in picked] != self.picked:
            raise RuntimeError("the run answered other requests")
        return compare.pose_numbers([(r, t) for _, r, t in picked], self.ref,
                                    self.cams)

    def control(self, cell) -> dict:
        if self.train:
            return compare.train_numbers(
                cell.reference_readings(control=True), self.ref)
        return compare.pose_numbers(
            cell.reference_answers(cell.sample(), control=True), self.ref,
            self.cams)


def reading(cell, control_ref=False) -> dict:
    """The program's gaps to the reference, and the control's."""
    ref = Reference(cell)
    out = {"program": ref.numbers(cell)}
    if control_ref:
        out["control"] = ref.control(cell)
    return out


def one_seed(config, traffic, seed, device, control: bool,
             faults: bool) -> dict:
    t0 = time.perf_counter()
    cell = program_run(config, traffic, seed, device)
    ref = Reference(cell)
    out = {"program": ref.numbers(cell)}
    if control:
        out["control"] = ref.control(cell)
    if faults:
        for name, wrap in FAULTS[traffic["kind"]]:
            out[name] = ref.numbers(program_run(config, traffic, seed, device,
                                                wrap))
    out["seed"], out["seconds"] = seed, time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--fault-seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=3_000_000_001)
    p.add_argument("--out", default=None)
    a = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    bench = harness.read_json(os.path.join(harness.root_dir(),
                                           "BENCHMARK.json"))
    wl = harness.by_name(bench["workloads"], a.workload)
    config = harness.read_json(os.path.join(harness.HERE, "configs",
                                            wl["config"] + ".json"))
    traffic = harness.read_json(os.path.join(harness.HERE, "traffic",
                                             wl["traffic"] + ".json"))
    dev = torch.device("cuda", 0)
    rows = []
    for i in range(a.seeds):
        row = one_seed(config, traffic, a.first_seed + 7919 * i, dev,
                       i < a.control_seeds, i < a.fault_seeds)
        rows.append(row)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "w") as f:
                json.dump({"workload": a.workload, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
