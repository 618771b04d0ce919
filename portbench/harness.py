"""One run of one cell:

    python3 -m portbench --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. BENCHMARK.json names the cell's configuration
and traffic; the harness finds them as portbench/configs/<config>.json and
portbench/traffic/<traffic>.json, and each per-layer metric's reader as
portbench/metrics/<metric>.py (a `read(ctx)` that returns a number, or None
when it finds nothing to read). The run builds the program from the seed
(set-up), measures for --seconds, frees the program, checks what it
produced against the plain reference, and prints one JSON line.
--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
metrics, the device's busy seconds and a breakdown.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import statistics
import sys
import time

from . import START

BANNED = ("jax", "jaxlib", "flax", "self6dpp_tpu")
HERE = os.path.dirname(os.path.abspath(__file__))


def root_dir() -> str:
    return os.path.dirname(HERE)


def read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def by_name(entries: list[dict], name: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no entry named {name!r}")


def cell_metrics(bench: dict, section: str, workload: str) -> list[dict]:
    """The metrics of `section` that this cell reports: those listing it,
    and those without a list whose `moves` (or, end to end, themselves)
    the cell reports."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if section == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names
                                 else [])]


def load_reader(name: str, base: str = HERE):
    path = os.path.join(base, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not
    load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def cache_dirs(root: str) -> None:
    """Every build and kernel cache at a fixed directory in the checkout
    (the port builds its kernels into self6dpp_tpu_torch/_build)."""
    base = os.path.join(root, ".portbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["USE_FLAX"] = "0"


class Context:
    """What a per-layer reader reads."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def percentile(values: list[float], q: float) -> float:
    """The q-quantile of values, linear between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def parse(argv):
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device=None, step_wrapper=None, bench=None,
         base=HERE) -> int:
    """The run; returns the exit code. Tests pass a CPU `device` (the run
    then skips the look for a card), a `step_wrapper` that breaks the timed
    path, and their own `bench` and `base` (the directory holding configs/,
    traffic/ and metrics/)."""
    args = parse(argv)
    root = root_dir()
    cache_dirs(root)
    bench = bench or read_json(os.path.join(root, "BENCHMARK.json"))
    wl = by_name(bench["workloads"], args.workload)
    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < wl["chips"]:
            print(f"portbench: the cell needs {wl['chips']} CUDA device(s); "
                  f"found {torch.cuda.device_count()}", file=sys.stderr)
            return 3
        device = torch.device("cuda", 0)
    device = torch.device(device)
    from . import cells, compare, counts, trace
    config = read_json(os.path.join(base, "configs", wl["config"] + ".json"))
    traffic = read_json(os.path.join(base, "traffic",
                                     wl["traffic"] + ".json"))
    cell = cells.make_cell(config, traffic, args.seed, device)
    before = time.perf_counter() - START
    cell.setup(step_wrapper)
    setup_s = time.perf_counter() - START

    breakdown = None
    dev_extra: dict = {}
    metrics: dict = {}
    if args.trace == 0:
        res = cell.run(args.seconds)
    else:
        phases = cells.Phases()
        res = cell.run(max(args.seconds - traffic["profiled_seconds"], 1.0),
                       phases)
        prof_phases = cells.Phases(spin=True)
        calls = counts.KernelCalls(traffic["profiled_steps"])
        with calls.active():
            _, events, window = trace.profiled(lambda: cell.run(
                math.inf, prof_phases, max_steps=traffic["profiled_steps"]))
        names = [("between_steps" if n == "start" else n)
                 for marks in prof_phases.steps for n, _ in marks]
        red = trace.reduce(events, window, names)
        breakdown = {"device_ops": red["device_ops"],
                     "idle_gaps": red["idle_gaps"]}
        dev_extra = {"busy_s": red["busy_s"], "window_s": red["window_s"]}
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    failed = res.get("failed", 0)
    if args.trace == 0:
        values = {"setup_s": setup_s, "peak_mem_gib": peak / 2 ** 30}
        if "latencies" in res:
            lat = [x * 1e3 for x in res["latencies"]]
            values["refine_ms_p50"] = statistics.median(lat)
            values["refine_ms_p95"] = percentile(lat, 0.95)
        else:
            values["train_rois_per_s"] = res["work"] / res["seconds"]
        for m in cell_metrics(bench, "end_to_end", wl["name"]):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}

    cell.free_program()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = cell.numbers()
    ok, checks = compare.judge(numbers, traffic["limits"])

    if args.trace == 1:
        ctx = Context(phase_ms=phases.read(), trace=red, events=events,
                      calls=calls.calls, window=res, cell=cell,
                      flops=lambda: cell.model_flops())
        for m in cell_metrics(bench, "per_layer", wl["name"]):
            v = load_reader(m["name"], base)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    found = banned_modules()
    if found:
        print(f"portbench: loaded {found}, which the benchmark may not load",
              file=sys.stderr)
        return 4
    device_block = {"platform": "gpu" if device.type == "cuda" else "cpu",
                    "kind": torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu",
                    "count": wl["chips"], "memory_peak_bytes": int(peak)}
    device_block.update(dev_extra)
    result = {"correct": bool(ok and failed == 0),
              "attempted": res["steps"], "failed": failed,
              "metrics": metrics, "device": device_block}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["setup_parts"] = dict(before_setup=before, **cell.setup_parts)
    result["readings"] = {k: v for k, v in numbers.items()
                          if k not in checks}
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
