"""Profiling (port of self6dpp_tpu/utils/profiling.py) and the port's
recorder of host spans and counters:

  - trace(log_dir): a torch.profiler trace of the block (CPU, and CUDA
    when a card is there) written to log_dir as a Chrome trace file
    (*.pt.trace.json), which Perfetto and TensorBoard's profiler plugin
    read; the JAX package writes an XLA trace there;
  - span(name, root=False): a named host span around a block. Under a
    torch profiler it is a range in the trace (record_function), also an
    NVTX range when CUDA is present; inside recording() it is kept as a
    Span. Otherwise it is one shared no-op context and costs a global
    read. A root span (a training step, a refine request) gives its
    descendants a new step id; inside an open root it is nothing;
  - count(name, n): adds n to the counter of the innermost open span;
  - recording(): the recorder on for the block, which yields the
    Recording: every span, on time.perf_counter_ns(), with its parent and
    step id, and per span the counters, host_syncs among them (every
    synchronisation of the host with the card, counted from
    torch.cuda.set_sync_debug_mode("warn")'s warnings).

Spans live where the work happens (the engines' steps and phases, the
renderer's stages, the refine iteration, the loss families); the
benchmark (portbench) places them on a device trace's clock.
"""

from __future__ import annotations

import contextlib
import os
import re
import threading
import time
import warnings

import torch
from torch.autograd import profiler as _autograd_profiler

# torch.cuda.set_sync_debug_mode("warn")'s message for every host sync
_SYNC_WARNING = r".*called a synchronizing CUDA operation"


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


class Span:
    """One recorded span: start and end on time.perf_counter_ns(), the
    index of its parent in Recording.spans (-1 for none), the step id of
    its root (None outside any root) and its counters."""

    __slots__ = ("name", "start_ns", "end_ns", "parent", "step", "counts")

    def __init__(self, name: str, start_ns: int, parent: int,
                 step: int | None):
        self.name, self.start_ns, self.end_ns = name, start_ns, None
        self.parent, self.step, self.counts = parent, step, {}

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, {self.start_ns}, {self.end_ns}, "
                f"parent={self.parent}, step={self.step}, {self.counts})")


class Recording:
    """What recording() kept: spans in the order they opened, and the
    counters counted outside any span. Only the thread that opened the
    recording records."""

    def __init__(self):
        self.spans: list[Span] = []
        self.counts: dict[str, int] = {}
        self.thread = threading.get_ident()
        self._open: list[int] = []      # indices of the open spans
        self._root: int | None = None   # index of the open root span
        self._steps = 0

    def open(self, name: str, root: bool) -> int | None:
        if threading.get_ident() != self.thread:
            return None
        if root:
            if self._root is not None:
                return None
            step = self._steps
            self._steps += 1
        else:
            step = None if self._root is None \
                else self.spans[self._root].step
        i = len(self.spans)
        self.spans.append(Span(name, time.perf_counter_ns(),
                               self._open[-1] if self._open else -1, step))
        self._open.append(i)
        if root:
            self._root = i
        return i

    def close(self, i: int) -> None:
        self.spans[i].end_ns = time.perf_counter_ns()
        self._open.pop()
        if i == self._root:
            self._root = None

    def add(self, name: str, n: int) -> None:
        if threading.get_ident() != self.thread:
            return
        c = self.spans[self._open[-1]].counts if self._open else self.counts
        c[name] = c.get(name, 0) + n


_recording: Recording | None = None


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


class _LiveSpan:
    __slots__ = ("name", "root", "rec", "index", "ranges")

    def __init__(self, name: str, root: bool, rec: Recording | None):
        self.name, self.root, self.rec = name, root, rec
        self.index = self.ranges = None

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self.ranges = torch.profiler.record_function(self.name)
            self.ranges.__enter__()
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_push(self.name)
        if self.rec is not None:
            self.index = self.rec.open(self.name, self.root)
        return self

    def __exit__(self, *exc):
        if self.index is not None:
            self.rec.close(self.index)
        if self.ranges is not None:
            if torch.cuda.is_available():
                torch.cuda.nvtx.range_pop()
            self.ranges.__exit__(*exc)
        return False


def span(name: str, root: bool = False):
    """A context for the block named `name`: recorded inside recording(),
    a profiler and NVTX range under a profiler, else the shared no-op."""
    rec = _recording
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _LiveSpan(name, root, rec)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` of the innermost open span (of the
    recording's own counters outside every span); nothing when not
    recording."""
    rec = _recording
    if rec is not None:
        rec.add(name, n)


@contextlib.contextmanager
def recording():
    """The recorder on for the block; yields the Recording. On a card,
    each host sync is counted as host_syncs (the sync debug mode set to
    warn for the block, and restored after it); other warnings pass."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a recording is already active")
    rec = Recording()
    cuda = torch.cuda.is_available()
    with warnings.catch_warnings():
        warnings.filterwarnings("always", message=_SYNC_WARNING)
        shown = warnings.showwarning

        def show(message, category, *args, **kw):
            if re.match(_SYNC_WARNING, str(message)):
                rec.add("host_syncs", 1)
            else:
                shown(message, category, *args, **kw)
        warnings.showwarning = show
        mode = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("warn")
        _recording = rec
        try:
            yield rec
        finally:
            _recording = None
            if cuda:
                torch.cuda.set_sync_debug_mode(mode)
