"""What the per-layer metrics' readers (portbench/metrics/<name>.py) share:
a phase's time from the step's mark hook, the device's idle share and the
kernels' roofline shares from the trace, the whole step's share of the
card's peak. Each returns None where the run has nothing to read."""

from __future__ import annotations

from . import counts, trace


def phase_ms(ctx, name: str) -> float | None:
    """The phase's mean milliseconds a step (or request) on the card's
    clock, over the window's steps."""
    return ctx.phase_ms.get(name)


def idle_pct(ctx) -> float | None:
    """The share of the traced window in which no operation ran on the
    device."""
    t = ctx.trace
    if t["window_s"] <= 0 or t["device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline_pct(ctx, kernel: str, fragment: str) -> float | None:
    """The kernel's share of its roofline over the first calls of the
    traced window: the bounds of those calls, from their own inputs and
    outputs, over the device time of the same launches."""
    calls = ctx.calls.get(kernel) or []
    if not calls:
        return None
    us = trace.first_kernel_us(ctx.events, fragment, len(calls))
    if us <= 0:
        return None
    bound = sum(counts.BOUNDS[kernel](c) for c in calls)
    return 100.0 * bound / (us * 1e-3)


def mfu_pct(ctx) -> float | None:
    """The model FLOPs of the window's steps (counted over the plain
    reference at the cell's shapes) over the window's seconds, as a share
    of the card's dense bf16 peak."""
    w = ctx.window
    if w["steps"] == 0 or w["seconds"] <= 0:
        return None
    return 100.0 * ctx.flops() * w["steps"] / w["seconds"] / counts.PEAK_BF16
