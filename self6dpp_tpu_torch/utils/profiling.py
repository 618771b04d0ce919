"""Profiling and step timing (port of self6dpp_tpu/utils/profiling.py):

  - trace(log_dir): a torch.profiler trace of the block (CPU, and CUDA
    when a card is there) written to log_dir as a Chrome trace file
    (*.pt.trace.json), which Perfetto and TensorBoard's profiler plugin
    read; the JAX package writes an XLA trace there;
  - annotate(name): a named range in the trace (record_function), also an
    NVTX range when CUDA is present;
  - StepTimer: a rolling step timer with p50/p90/max/mean;
    block_and_stop(result) synchronises the result's device first;
  - device_memory_stats(): per card, torch.cuda.memory_stats' bytes in
    use and their peak.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into log_dir (created); yields the profiler, whose
    key_averages() the caller may read after the block."""
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(log_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"{os.getpid()}.{time.time_ns()}.pt.trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range for the block, in the profiler's trace and (on CUDA)
    as an NVTX range."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def _sync(result) -> None:
    """Synchronise the device of every CUDA tensor in result (nested
    dicts, lists and tuples)."""
    devs = set()

    def walk(x):
        if torch.is_tensor(x):
            if x.is_cuda:
                devs.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)
    walk(result)
    for d in devs:
        torch.cuda.synchronize(d)


class StepTimer:
    """Rolling step timer (the last `window` steps)."""

    def __init__(self, window: int = 100):
        self.times: deque[float] = deque(maxlen=window)
        self._t0: float | None = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)

    def block_and_stop(self, result):
        """Wait for the result's device, then stop the clock."""
        _sync(result)
        self.times.append(time.perf_counter() - self._t0)

    def stats(self) -> dict[str, float]:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)),
                "max": float(a.max()),
                "mean": float(a.mean())}


def device_memory_stats() -> dict:
    """{card: {'bytes_in_use', 'peak_bytes_in_use'}} (empty without CUDA)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": s.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak")}
    return out
