"""What the drivers of the benchmark's cells share. A traffic file names
its `kind`; the driver of that kind is found by the name as
portbench/kinds/<kind>.py (its class named by the file's DRIVER), and the
traffic file's parameters (batch, pool, overrides, noise, limits) fill
it. A driver (the Driver class below) builds the program from the
configuration and the seed (set-up), checks its first steps or keeps its
answers, runs the window, gives its end-to-end values under the names
BENCHMARK.json uses, frees the program and reads the reference
(portbench/reference) on the same inputs, and names the faults that
calibrate.py plants in it. A reference recipe is found by its name in
portbench/reference/config.py, or else as the get_config() of
portbench/reference/recipes/<name>.py."""

from __future__ import annotations

import math
import time

import torch

from .harness import HERE, load_module
from .reference import config as ref_config
from .reference import steps as ref_steps

WEIGHTS, DATA, LPIPS_W, TEACHER = 0, 1, 2, 4       # generator streams


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def port_config(name: str, overrides: list[str]):
    from self6dpp_tpu_torch import config as C
    return C.apply_overrides(getattr(C, name)(), list(overrides))


def reference_config(name: str, overrides: list[str], base: str = HERE):
    """The reference's recipe `name` in float32: reference/config.py's, or
    else the get_config() of <base>/reference/recipes/<name>.py."""
    make = getattr(ref_config, name, None)
    if make is None:
        make = load_module(base, "reference/recipes", name).get_config
    cfg = ref_config.apply_overrides(make(), list(overrides))
    return ref_steps.float32_config(cfg)


def percentile(values: list[float], q: float) -> float:
    """The q-quantile of values, linear between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def config_value(cfg, dotted: str):
    for part in dotted.split("."):
        cfg = getattr(cfg, part)
    return list(cfg) if isinstance(cfg, tuple) else cfg


def check_sizes(cfg, sizes: dict) -> None:
    """The configuration file's sizes are those of the config as run."""
    wrong = {k: (v, config_value(cfg, k)) for k, v in sizes.items()
             if config_value(cfg, k) != v}
    if wrong:
        raise ValueError(f"the configuration as run differs from its file: "
                         f"{wrong}")


class Clock:
    """Seconds of each part of set-up on the host's clock, each part ended
    by waiting for the device. Once the inputs are made, the device's peak
    memory restarts: it counts the program and its inputs, not the
    benchmark's making of them."""

    def __init__(self, device):
        self.device, self.parts = device, {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> None:
        sync(self.device)
        if name == "inputs" and self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        now = time.perf_counter()
        self.parts[name] = now - self.t
        self.t = now


class Phases:
    """mark(name) records a CUDA event after each phase of a step (the
    port's gdrn_engine.event_marker); read() gives each phase's mean time
    a step (or request) on the card's clock, summed over its occurrences.
    With spin, each mark also launches an empty kernel (torch.cuda._sleep
    of 0 cycles), whose launch the device trace shows at the host's time
    of the mark: what trace.reduce names the idle gaps by."""

    def __init__(self, spin: bool = False):
        self.steps: list[list] = []
        self.spin = spin

    def start(self):
        from self6dpp_tpu_torch.engine.gdrn_engine import event_marker
        marks: list = []
        self.steps.append(marks)
        record = event_marker(marks)

        def mark(name: str) -> None:
            record(name)
            if self.spin:
                torch.cuda._sleep(0)
        mark("start")
        return mark

    def read(self) -> dict[str, float]:
        sums: dict[str, float] = {}
        for marks in self.steps:
            for (_, a), (name, b) in zip(marks, marks[1:]):
                sums[name] = sums.get(name, 0.0) + a.elapsed_time(b)
        n = max(len(self.steps), 1)
        return {k: v / n for k, v in sums.items()}


class Driver:
    """What the harness and calibrate.py call on a cell's driver. A kind
    file's DRIVER is built as DRIVER(config, traffic, seed, device, base),
    base being the directory that holds configs/, traffic/, kinds/,
    metrics/ and reference/recipes/, and gives:

      setup(step_wrapper)   builds the program and takes its checked first
                            steps or warm requests; sets setup_parts.
                            step_wrapper(step) -> step lets a test or
                            calibrate.py break the timed path
      run(seconds, phases=None, max_steps=None)
                            the window: {"steps", "work", "seconds",
                            "failed", ...}
      end_to_end(res)       the window's end-to-end values, under the
                            names BENCHMARK.json gives them
      free_program()
      reference(control=False)
                            the float32 reference's readings of this seed
                            (control: one precision below)
      gaps(ref, own=None)   the gaps of own (by default this run's
                            readings) to the reference's readings ref
      model_flops()         FLOPs of one step or request
      faults                ((name, wrap), ...): the faults calibrate.py
                            plants in the timed path, each wrap a
                            step_wrapper
    """

    faults: tuple = ()

    def calibration_window(self, seconds: float) -> None:
        """What calibrate.py runs between set-up and freeing the program
        so that the run has readings: nothing where set-up's checked
        steps are the readings."""

    def numbers(self) -> dict[str, float]:
        """This run's gaps to the float32 reference: what decides
        `correct`."""
        return self.gaps(self.reference())
