"""Host spans placed on a device trace's clock, and what the trace says of
each: the time the host spent blocked in CUDA calls, the device launches
it made, its synchronising calls and the device's idle gaps it left.

Spans are objects with name, start_ns, end_ns, parent (an index into the
same list, -1 for none) and step (the id of their step or request, None
outside one), on one host clock: either the port's recorder's
(self6dpp_tpu_torch/utils/profiling.py, time.perf_counter_ns) with the
trace mapped onto it by fit_offset, or the trace's own clock, for the
spans that mark_spans builds from the phase marks' empty kernels. A
trace event at ts (µs) lies at (ts - offset_us) * 1000 on the spans'
clock.

table() gives, per span name, the mean a step (or request) of:
  host_ms    its spans' durations;
  own_ms     host_ms less the host's time blocked inside them in CUDA
             runtime or driver calls longer than BLOCKED_US (a full launch
             queue, an allocation, a synchronisation), the union of such
             calls on every thread counted once;
  self_ms    host_ms less the time its child spans cover;
  launches   kernel launches, copies and fills the host issued inside
             them (the marks' empty kernels left out);
  sync_calls synchronising CUDA calls issued inside them;
  host_syncs the recorder's host_syncs counter, counted inside them;
  idle_ms    the device's idle gaps whose ending operation was launched
             while this span was the innermost open one; the gaps of
             none go to "outside".
Everything but idle_ms and self_ms counts what the span's descendants
hold too.
"""

from __future__ import annotations

import bisect
import re
import statistics

from .trace import DEVICE_CATS, SPIN, _busy

HOST_CATS = ("cuda_runtime", "cuda_driver")
BLOCKED_US = 100.0
LAUNCH = re.compile(r"Launch|Memcpy|Memset")
SYNC = re.compile(r"Synchronize$|^cudaMemcpy$|^cuMemcpy[DH]to[DH]$")
OUTSIDE = "outside"


class HostSpan:
    __slots__ = ("name", "start_ns", "end_ns", "parent", "step", "counts")

    def __init__(self, name, start_ns, end_ns, parent, step, counts=None):
        self.name, self.start_ns, self.end_ns = name, start_ns, end_ns
        self.parent, self.step = parent, step
        self.counts = counts or {}


def self_ns(spans) -> list:
    """Each span's duration less the durations of its children."""
    out = [s.end_ns - s.start_ns for s in spans]
    for s in spans:
        if s.parent >= 0:
            out[s.parent] -= s.end_ns - s.start_ns
    return out


def spin_launches(events: list[dict]) -> tuple[list[float], set]:
    """The host's launch times (µs, the trace's clock) of the phase marks'
    empty kernels, in order, and their correlation ids."""
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in events
                if e.get("cat") in HOST_CATS
                and "correlation" in e.get("args", {})}
    corr = {e["args"]["correlation"] for e in events
            if e.get("cat") == "kernel" and SPIN in e["name"]
            and e.get("args", {}).get("correlation") in launched}
    return sorted(launched[c] for c in corr), corr


def fit_offset(host_ns: list[int], launch_us: list[float]
               ) -> tuple[float, float]:
    """The offset (µs) of the trace's clock over the host's, the median
    over the marks of launch - host, and the largest residual (µs)."""
    if not host_ns or len(host_ns) != len(launch_us):
        raise ValueError(f"{len(host_ns)} marks against {len(launch_us)} "
                         f"launches")
    d = [u - h * 1e-3 for h, u in zip(host_ns, launch_us)]
    off = statistics.median(d)
    return off, max(abs(x - off) for x in d)


def mark_spans(events: list[dict], steps: int, names: list[str]):
    """Spans on the trace's clock from the phase marks' launches: per step
    a root 'step' from its first mark to its last, under it each phase
    from the mark before it to its own, the phases named in turn by
    `names`. None when the marks do not split into `steps` steps."""
    marks, _ = spin_launches(events)
    if steps <= 0 or not names or not marks or len(marks) % steps:
        return None
    m = len(marks) // steps
    if m < 2 or (m - 1) % len(names):
        return None
    out: list[HostSpan] = []
    for k in range(steps):
        ts = [t * 1e3 for t in marks[k * m:(k + 1) * m]]
        root = len(out)
        out.append(HostSpan("step", ts[0], ts[-1], -1, k))
        for i in range(1, m):
            out.append(HostSpan(names[(i - 1) % len(names)], ts[i - 1],
                                ts[i], root, k))
    return out


class _Innermost:
    """The innermost span open at a time, for properly nested spans."""

    def __init__(self, spans):
        self.spans = spans
        self.order = sorted(range(len(spans)),
                            key=lambda i: (spans[i].start_ns,
                                           -spans[i].end_ns))
        self.starts = [spans[i].start_ns for i in self.order]

    def __call__(self, t: float) -> int:
        j = bisect.bisect_right(self.starts, t) - 1
        if j < 0:
            return -1
        i = self.order[j]
        while i >= 0 and not (self.spans[i].start_ns <= t
                              < self.spans[i].end_ns):
            i = self.spans[i].parent
        return i


def _union(ivs: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[list[float]] = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def table(spans, events: list[dict], offset_us: float = 0.0,
          window_ns: tuple[float, float] | None = None) -> dict:
    """Per span name, the means a step of the quantities in the module's
    docstring ({} without a step), over closed, properly nested spans;
    idle gaps are read only given the window's bounds on the spans'
    clock."""
    steps = {s.step for s in spans if s.step is not None}
    if not steps:
        return {}
    at = lambda ts: (float(ts) - offset_us) * 1e3
    inner = _Innermost(spans)
    _, spin = spin_launches(events)
    n = len(spans)
    launches, syncs = [0] * n, [0] * n
    blocked, launched = [], {}

    def add(counter, t):
        i = inner(t)
        while i >= 0:
            counter[i] += 1
            i = spans[i].parent

    for e in events:
        if e.get("cat") not in HOST_CATS:
            continue
        corr = e.get("args", {}).get("correlation")
        t = at(e["ts"])
        launched[corr] = t
        if float(e.get("dur", 0)) > BLOCKED_US:
            blocked.append((t, t + float(e["dur"]) * 1e3))
        if LAUNCH.search(e["name"]) and corr not in spin:
            add(launches, t)
        if SYNC.search(e["name"]):
            add(syncs, t)
    blocked = _union(blocked)
    host_syncs = [s.counts.get("host_syncs", 0) for s in spans]
    for i in reversed(range(n)):        # children follow their parents
        if spans[i].parent >= 0:
            host_syncs[spans[i].parent] += host_syncs[i]
    idle = {} if window_ns is None else _idle(
        spans, inner, events, at, launched, window_ns)
    selfs = self_ns(spans)
    out: dict[str, dict] = {}
    for i, s in enumerate(spans):
        r = out.setdefault(s.name, dict.fromkeys(
            ("calls", "host_ms", "own_ms", "self_ms", "launches",
             "sync_calls", "host_syncs", "idle_ms"), 0.0))
        dur = s.end_ns - s.start_ns
        held = sum(max(0.0, min(b, s.end_ns) - max(a, s.start_ns))
                   for a, b in blocked)
        r["calls"] += 1
        r["host_ms"] += dur * 1e-6
        r["own_ms"] += (dur - held) * 1e-6
        r["self_ms"] += selfs[i] * 1e-6
        r["launches"] += launches[i]
        r["sync_calls"] += syncs[i]
        r["host_syncs"] += host_syncs[i]
    for name, ns in idle.items():
        out.setdefault(name, {"idle_ms": 0.0})["idle_ms"] = ns * 1e-6
    k = len(steps)
    return {name: {q: v / k for q, v in r.items()}
            for name, r in out.items()}


def _idle(spans, inner, events, at, launched, window_ns) -> dict:
    """ns of device idle per span name: each gap in the window before a
    busy interval goes to the innermost span open at the launch of the
    operation that opened the interval; the window's tail to OUTSIDE."""
    idle: dict[str, float] = {}
    t0, t1 = window_ns
    end = t0
    for a, b, first in _busy([e for e in events
                              if e.get("cat") in DEVICE_CATS]):
        a, b = at(a), at(b)
        if a > end:
            i = inner(launched.get(first.get("args", {}).get("correlation"),
                                   a))
            key = spans[i].name if i >= 0 else OUTSIDE
            idle[key] = idle.get(key, 0.0) + a - end
        end = max(end, b)
    if t1 > end:
        idle[OUTSIDE] = idle.get(OUTSIDE, 0.0) + t1 - end
    return idle


def phase_value(ctx, name: str, key: str) -> float | None:
    """`key` of span `name` in the table of the traced window's phase
    spans (mark_spans: the root is 'step'), for a per-layer reader; None
    where the run traced no marks. The table is kept on ctx."""
    got = getattr(ctx, "_phase_table", None)
    if got is None:
        events, cell = getattr(ctx, "events", None), getattr(ctx, "cell", None)
        sp = mark_spans(events, cell.traffic["profiled_steps"],
                        list(ctx.phase_ms)) if events and cell else None
        got = ctx._phase_table = table(sp, events) if sp else {}
    return got.get(name, {}).get(key)
