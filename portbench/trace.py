"""Reading the device trace of a window: torch.profiler with CUDA activity
only (kernels, copies, fills and the runtime's calls, without the per-op
host callbacks that slow an eager step several fold), reduced to the
seconds the device was busy, the device operations that took most time,
the idle gaps named by the phase the host was issuing, and kernel time by
name. The trace is written under the run's TMPDIR and deleted once read."""

from __future__ import annotations

import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPIN = "spin_kernel"        # torch.cuda._sleep's kernel: cells.Phases' marks


def _clean(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.:-]", "_", name)[:64]


def profiled(run_fn) -> tuple[dict, list[dict], float]:
    """run_fn() under the profiler: (its result, the trace's events, the
    traced window's seconds on the host's clock)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = run_fn()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return res, [e for e in events if e.get("ph") == "X"], window


def _busy(dev: list[dict]) -> list[list]:
    """The device's busy intervals [start, end, the event that opened
    it], from its events in time order."""
    out: list[list] = []
    for e in sorted(dev, key=lambda e: float(e["ts"])):
        a = float(e["ts"])
        b = a + float(e.get("dur", 0))
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b, e])
    return out


def reduce(events: list[dict], window_s: float, phase_names: list[str]
           ) -> dict:
    """busy_s; device_ops (the 10 operations by total seconds); idle_gaps
    (the gaps between device work, each summed under the phase that
    launched the operation ending it, the phases bounded by the launches
    of the phase marks' empty kernels and named in order by phase_names;
    'step' where they do not line up); device_events (their count)."""
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
    ivs = _busy(dev)
    busy_us = sum(b - a for a, b, _ in ivs)
    ops: dict[str, float] = {}
    for e in dev:
        d = float(e.get("dur", 0))
        ops[_clean(e["name"])] = ops.get(_clean(e["name"]), 0.0) + d
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {})}
    # the phase marks: the host's launches of the empty marker kernels
    marks = sorted(launched[e["args"]["correlation"]] for e in dev
                   if e.get("cat") == "kernel" and SPIN in e["name"]
                   and e.get("args", {}).get("correlation") in launched)
    named = len(marks) == len(phase_names)
    gaps: dict[str, float] = {}
    for (_, end, _), (start, _, first) in zip(ivs, ivs[1:]):
        name = "step"
        if named:
            # the device waited for the operation that ended the gap: it
            # belongs to the phase whose mark is the first at or after
            # that operation's launch
            t = launched.get(first.get("args", {}).get("correlation"),
                             start)
            i = next((j for j, m in enumerate(marks) if m >= t), None)
            name = phase_names[i] if i is not None else "after_last_mark"
        gaps[name] = gaps.get(name, 0.0) + (start - end)
    top = lambda d: [[k, v * 1e-6] for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"busy_s": busy_us * 1e-6, "window_s": window_s,
            "device_ops": top(ops), "idle_gaps": top(gaps),
            "device_events": len(dev)}


def first_kernel_us(events: list[dict], fragment: str, count: int) -> float:
    """The summed duration of the first `count` launches of the kernel
    whose name holds `fragment`."""
    ks = sorted((float(e["ts"]), float(e.get("dur", 0))) for e in events
                if e.get("cat") == "kernel" and fragment in e["name"])
    return sum(d for _, d in ks[:count])
