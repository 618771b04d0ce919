"""Host spans on a synthetic device trace whose clock runs a known offset
ahead of the host's (portbench/spans.py): the offset and its residual from
the marks, and the gaps, launches, syncs and blocked time each span takes
as the innermost one open; the new readers read None where nothing was
traced."""

import types

import pytest

from portbench import harness, spans
from portbench.spans import HostSpan

OFF = 5_000_000.0          # µs the trace's clock runs ahead of the host's
NEW = ("train.host_issue_ms", "train.launches", "train.host_syncs",
       "refine.render_host_ms", "refine.launches", "refine.host_syncs")


def host(name, ts, dur=1.0, corr=None):
    """A CUDA runtime call at host µs ts (the trace's clock: ts + OFF)."""
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts + OFF,
            "dur": dur, "args": {} if corr is None else {"correlation": corr}}


def kernel(name, ts, dur, corr):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts + OFF,
            "dur": dur, "args": {"correlation": corr}}


def trace():
    """One step, host µs: root [0, 920), render [100, 500) holding
    render.bin [200, 300), network_fwd [500, 900). The device runs
    k1 [150, 250), k2 [400, 450), the mark's spin kernel [570, 571),
    k3 [600, 700), k4 [950, 960)."""
    ev = [host("cudaLaunchKernel", 120, corr=1), kernel("k1", 150, 100, 1),
          host("cudaLaunchKernel", 210, corr=2), kernel("k2", 400, 50, 2),
          host("cudaMemcpyAsync", 220, corr=5),
          host("cudaMalloc", 230, dur=150.0),        # blocked 230-380
          host("cudaStreamSynchronize", 240, dur=20.0),
          host("cudaLaunchKernel", 550, corr=3), kernel("k3", 600, 100, 3),
          host("cudaLaunchKernel", 560, corr=9),
          kernel("void spin_kernel(long)", 570, 1, 9),
          host("cudaEventRecord", 580),
          host("cudaLaunchKernel", 930, corr=4), kernel("k4", 950, 10, 4)]
    sp = [HostSpan("eval_step", 0, 920_000, -1, 0),
          HostSpan("render", 100_000, 500_000, 0, 0, {"host_syncs": 2}),
          HostSpan("render.bin", 200_000, 300_000, 1, 0, {"host_syncs": 1}),
          HostSpan("network_fwd", 500_000, 900_000, 0, 0)]
    return sp, ev


def test_fit_offset_and_its_largest_residual():
    hosts = [1_000_000_000 + 7_000 * i for i in range(9)]
    jitter = [2.0, 3.0, 1.0, 2.0, 9.0, 2.0, 2.5, 1.5, 2.0]
    launch = [h * 1e-3 + OFF + j for h, j in zip(hosts, jitter)]
    off, res = spans.fit_offset(hosts, launch)
    assert off == pytest.approx(OFF + 2.0)
    assert res == pytest.approx(7.0)
    with pytest.raises(ValueError):
        spans.fit_offset(hosts, launch[:-1])


def test_gaps_launches_syncs_and_blocked_time_go_to_the_innermost_span():
    sp, ev = trace()
    t = spans.table(sp, ev, OFF, window_ns=(0, 1000_000))
    step, ren, bin_, net = (t[k] for k in ("eval_step", "render",
                                           "render.bin", "network_fwd"))
    # the spin kernel's launch, the event record and the sync are no
    # launches; k4's is after the root
    assert (step["launches"], ren["launches"], bin_["launches"],
            net["launches"]) == (4, 3, 2, 1)
    assert (step["sync_calls"], ren["sync_calls"], bin_["sync_calls"]) \
        == (1, 1, 1)
    assert (step["host_syncs"], ren["host_syncs"], bin_["host_syncs"]) \
        == (3, 3, 1)
    # cudaMalloc blocks 230-380: 70 µs of render.bin, 150 of render
    assert bin_["host_ms"] == pytest.approx(0.1)
    assert bin_["own_ms"] == pytest.approx(0.03)
    assert ren["own_ms"] == pytest.approx(0.25)
    assert step["own_ms"] == pytest.approx(0.77)
    assert ren["self_ms"] == pytest.approx(0.3)
    assert step["self_ms"] == pytest.approx(0.12)
    # gaps: 0-150 (k1, launched in render), 250-400 (k2, in render.bin),
    # 450-570 and 571-600 (the spin kernel and k3, in network_fwd),
    # 700-950 (k4, launched after the root), the tail 960-1000 outside
    assert ren["idle_ms"] == pytest.approx(0.15)
    assert bin_["idle_ms"] == pytest.approx(0.15)
    assert net["idle_ms"] == pytest.approx(0.149)
    assert t["outside"]["idle_ms"] == pytest.approx(0.29)
    busy = 0.1 + 0.05 + 0.001 + 0.1 + 0.01
    assert sum(r["idle_ms"] for r in t.values()) == pytest.approx(1 - busy)


def test_means_are_per_step_and_idle_needs_the_window():
    sp, ev = trace()
    two = sp + [HostSpan(s.name, s.start_ns + 2_000_000,
                         s.end_ns + 2_000_000,
                         s.parent + 4 if s.parent >= 0 else -1, 1)
                for s in sp]
    t = spans.table(two, ev, OFF)
    assert t["eval_step"]["calls"] == 1
    assert t["eval_step"]["launches"] == 2          # 4 in one of two steps
    assert t["render"]["host_ms"] == pytest.approx(0.4)
    assert all(r["idle_ms"] == 0 for r in t.values())
    assert spans.table([HostSpan("render", 0, 5, -1, None)], ev) == {}


def phase_trace(steps=2, per_step=5, gap=1000.0):
    """Spin launches of `steps` steps of per_step marks, each phase 100 µs
    on the trace's clock, a launch and a sync inside each phase."""
    ev, c = [], 100
    for k in range(steps):
        for i in range(per_step):
            t = k * gap + i * 100.0
            ev += [host("cudaLaunchKernel", t, corr=c),
                   kernel("void spin_kernel(long)", t + 5, 1, c)]
            if i:
                ev += [host("cudaLaunchKernel", t - 50, corr=c + 1),
                       host("cudaStreamSynchronize", t - 40)]
            c += 2
    return ev


def ctx(events, phase_ms, steps=2):
    return harness.Context(events=events, phase_ms=phase_ms,
                           cell=types.SimpleNamespace(
                               traffic={"profiled_steps": steps}))


def test_phase_readers_read_the_marks():
    # refine: start, then (render, network_fwd) twice
    c = ctx(phase_trace(), {"render": 1.0, "network_fwd": 1.0})
    got = {m: harness.load_reader(m)(c) for m in NEW}
    assert got["refine.render_host_ms"] == pytest.approx(0.2)
    assert got["refine.launches"] == got["train.launches"] == 4
    assert got["refine.host_syncs"] == got["train.host_syncs"] == 4
    assert got["train.host_issue_ms"] == pytest.approx(0.4)


@pytest.mark.parametrize("c", [
    harness.Context(phase_ms={"forward": 1.0}),
    ctx([], {"render": 1.0}),
    ctx(phase_trace(), {}),
    ctx(phase_trace(per_step=4), {"render": 1.0, "network_fwd": 1.0}),
    ctx(phase_trace(steps=3), {"render": 1.0}, steps=2),
])
def test_new_readers_read_none_where_nothing_was_traced(c):
    assert [harness.load_reader(m)(c) for m in NEW] == [None] * len(NEW)
