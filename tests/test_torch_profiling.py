"""The port's recorder (self6dpp_tpu_torch/utils/profiling.py): off, a
span is one shared no-op and nothing is kept; on, spans keep their
nesting, parents and step ids, counters go to the innermost open span,
host syncs are counted from the sync debug mode's warnings, and the mode
is restored. gdrn_engine.event_marker's marks stay (name, event) pairs
and carry the host's time. CPU only; no model is built."""

import time
import warnings

import pytest
import torch

from self6dpp_tpu_torch.engine import gdrn_engine
from self6dpp_tpu_torch.utils import profiling

SYNC = "called a synchronizing CUDA operation"


def busy(ns: int) -> None:
    end = time.perf_counter_ns() + ns
    while time.perf_counter_ns() < end:
        pass


def test_off_span_is_the_shared_no_op_and_keeps_nothing():
    a, b = profiling.span("a"), profiling.span("b", root=True)
    assert a is b
    with a:
        profiling.count("host_syncs", 3)
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.counts == {}
    with a:
        pass
    assert rec.spans == []


def test_nesting_parents_and_step_ids():
    with profiling.recording() as rec:
        with profiling.span("render.project"):
            pass
        for _ in range(2):
            with profiling.span("train_step", root=True):
                with profiling.span("losses"):
                    with profiling.span("losses.mask"):
                        pass
                    # a root inside an open root is nothing
                    with profiling.span("refine", root=True):
                        with profiling.span("render"):
                            pass
    got = [(s.name, s.parent, s.step) for s in rec.spans]
    assert got == [("render.project", -1, None),
                   ("train_step", -1, 0), ("losses", 1, 0),
                   ("losses.mask", 2, 0), ("render", 2, 0),
                   ("train_step", -1, 1), ("losses", 5, 1),
                   ("losses.mask", 6, 1), ("render", 6, 1)]
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns


def test_self_time_is_what_the_children_leave():
    from portbench import spans
    with profiling.recording() as rec:
        with profiling.span("train_step", root=True):
            busy(2_000_000)
            with profiling.span("backward"):
                busy(3_000_000)
            with profiling.span("optimizer_ema"):
                busy(1_000_000)
    root, bwd, opt = rec.spans
    selfs = spans.self_ns(rec.spans)
    dur = lambda s: s.end_ns - s.start_ns
    assert selfs[0] == dur(root) - dur(bwd) - dur(opt)
    assert selfs[1:] == [dur(bwd), dur(opt)]
    assert selfs[0] >= 2_000_000 and dur(bwd) >= 3_000_000


def test_counters_go_to_the_innermost_open_span():
    with profiling.recording() as rec:
        profiling.count("host_syncs")
        with profiling.span("eval_step", root=True):
            profiling.count("host_syncs", 2)
            with profiling.span("render"):
                profiling.count("host_syncs")
                profiling.count("host_syncs", 4)
                profiling.count("faces", 7)
            profiling.count("host_syncs")
    assert rec.counts == {"host_syncs": 1}
    assert [s.counts for s in rec.spans] == [
        {"host_syncs": 3}, {"host_syncs": 5, "faces": 7}]


def test_event_marker_keeps_name_event_and_adds_the_host_time(monkeypatch):
    class Event:
        def __init__(self, enable_timing=False):
            self.recorded = False

        def record(self):
            self.recorded = True

    monkeypatch.setattr(torch.cuda, "Event", Event)
    marks: list = []
    mark = gdrn_engine.event_marker(marks)
    t0 = time.perf_counter_ns()
    mark("start")
    mark("render")
    t1 = time.perf_counter_ns()
    (n0, e0), (n1, e1) = marks
    assert (n0, n1) == ("start", "render") and e0.recorded and e1.recorded
    assert marks[0] == ("start", e0) and len(marks[1]) == 2
    assert t0 <= marks[0].host_ns <= marks[1].host_ns <= t1


def test_recording_counts_syncs_and_restores_the_sync_debug_mode(
        monkeypatch):
    mode = {"now": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_sync_debug_mode",
                        lambda: mode["now"])
    monkeypatch.setattr(torch.cuda, "set_sync_debug_mode",
                        lambda m: mode.__setitem__("now", m))
    with warnings.catch_warnings(record=True) as passed:
        warnings.simplefilter("always")
        with profiling.recording() as rec:
            assert mode["now"] == "warn"
            with profiling.span("train_step", root=True):
                for _ in range(3):      # one site, counted every time
                    warnings.warn(SYNC)
                warnings.warn("something else")
        assert mode["now"] == 0
        with pytest.raises(ValueError):
            with profiling.recording():
                raise ValueError
        assert mode["now"] == 0 and profiling.span("x") is profiling.span("y")
    assert rec.spans[0].counts == {"host_syncs": 3}
    assert [str(w.message) for w in passed] == ["something else"]


def test_one_recording_at_a_time():
    with profiling.recording():
        with pytest.raises(RuntimeError):
            with profiling.recording():
                pass
