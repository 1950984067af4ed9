"""The port's probe (``repro_torch.probe``): spans off and on, self time
under a fake clock, the bounded rows and a step that raises, the spans and
counters a fine session leaves per step, the profiler's ranges, reports
unchanged by the probe, and the spanned methods still on their classes."""

import gc
import importlib

import pytest
import torch

import repro_torch.configs as TC
from repro_torch import probe
from repro_torch.core import events as tevents
from repro_torch.core import session as tsession
from repro_torch.core.events import EventKind
from repro_torch.core.handler import EventHandler
from repro_torch.launch import analyze

EMIT_CHILDREN = ("emit records", "emit live objects", "emit dispatch")
REDUCE_CHILDREN = ("reduce prep", "reduce copies", "reduce launch")
#: methods that carry a span as a decorator and that outside timers (a
#: profiler's or a benchmark's wrappers) look up in their class's __dict__
SPANNED_METHODS = (
    ("repro_torch.core.instrument", "EagerInstrumenter", "op"),
    ("repro_torch.core.pool", "MemoryPool", "alloc"),
    ("repro_torch.core.instrument", "EagerInstrumenter", "_emit_trace"),
    ("repro_torch.core.processor", "EventProcessor", "_preprocess_trace"),
    ("repro_torch.core.tools.locator", "LocatorTool", "_capture_stack"),
    ("repro_torch.core.instrument", "EagerInstrumenter", "_on_free"),
)


@pytest.fixture(autouse=True)
def _port_state():
    tevents.reset_seq()
    tsession.reset_state()
    probe.reset()
    yield
    probe.reset()
    tsession.reset_state()


def _rows(step=None):
    return [r for r in probe.snapshot() if r["step"] == step]


def _analyze(steps=2, observe=None):
    """A fine session (workingset, hotness, locator) on reduced glm4-9b."""
    cfg = TC.reduced(TC.get("glm4-9b"))
    return analyze.run(cfg, steps, "cpu", observe=observe)


class _Buffers:
    """Each step's TRACE_BUFFER events and the pool's handles at each."""

    def __init__(self):
        self.events, self.handles = {}, {}

    def __call__(self, session):
        def seen(ev):
            self.events[ev.step] = self.events.get(ev.step, 0) + 1
            self.handles[ev.step] = (self.handles.get(ev.step, 0)
                                     + len(session.pool.tensors))
        session.handler.subscribe(seen, kinds=(EventKind.TRACE_BUFFER,))


def test_off_keeps_no_spans_and_counters_still_count():
    assert not probe.ON
    assert probe.span("a") is probe.span("b")
    with probe.span("a"):
        probe.count("x", 3)
    probe.start_step(7)
    probe.count("x")
    probe.count("x", 2)
    probe.end_step()
    probe.count("y")
    rows = probe.snapshot()
    got = [(r["step"], r["spans_on"], r["counts"], r["spans"]) for r in rows]
    assert got == [(None, False, {"x": 3, "y": 1}, {}),
                   (7, False, {"x": 3}, {})]


def test_nesting_and_self_time_are_exact_under_a_fake_clock(monkeypatch):
    ticks = iter(range(0, 10_000, 10))
    monkeypatch.setattr(probe, "_clock", lambda: next(ticks))
    gc_was = gc.isenabled()
    gc.disable()

    @probe.wrap("leaf")
    def leaf():
        return 5

    try:
        probe.enable()
        probe.start_step(3)
        with probe.span("outer"):             # 0 .. 70
            with probe.span("inner"):         # 10 .. 40
                assert leaf() == 5            # 20 .. 30
            with probe.span("inner"):         # 50 .. 60
                pass
        probe.end_step()
        with probe.span("after"):             # 80 .. 90
            pass
    finally:
        if gc_was:
            gc.enable()
    free, step = probe.snapshot()
    assert step["step"] == 3 and step["spans_on"]
    assert step["spans"] == {
        "outer": {"calls": 1, "total_ns": 70, "self_ns": 30},
        "inner": {"calls": 2, "total_ns": 40, "self_ns": 30},
        "leaf": {"calls": 1, "total_ns": 10, "self_ns": 10}}
    assert free["spans"] == {"after": {"calls": 1, "total_ns": 10,
                                       "self_ns": 10}}
    assert leaf.__name__ == "leaf"


def test_a_collection_leaves_the_self_time_of_the_span_it_interrupts():
    probe.enable()
    with probe.span("outer"):
        gc.collect()
    spans = probe.snapshot()[0]["spans"]
    assert spans["gc"]["calls"] >= 1
    outer = spans["outer"]
    assert outer["total_ns"] - outer["self_ns"] == spans["gc"]["total_ns"]
    probe.enable(False)
    probe.reset()
    gc.collect()
    assert probe.snapshot()[0]["spans"] == {}


def test_rows_are_bounded_and_spans_keep_no_list():
    probe.enable()
    for step in range(probe.ROWS + 10):
        probe.start_step(step)
        probe.count("x")
        for _ in range(3):
            with probe.span("a"):
                pass
        probe.end_step()
    free, *rows = probe.snapshot()
    assert len(rows) == probe.ROWS
    assert [rows[0]["step"], rows[-1]["step"]] == [10, probe.ROWS + 9]
    assert rows[-1]["counts"] == {"x": 1}
    assert rows[-1]["spans"]["a"]["calls"] == 3
    assert free["spans"] == {} and not probe._stack


def test_a_step_that_raises_is_closed_by_the_next_step_start():
    probe.enable()
    handler = EventHandler()

    @probe.wrap("work")
    def work(fail):
        probe.count("x")
        with probe.span("inner"):
            if fail:
                raise RuntimeError("injected")

    handler.step_start(0)
    with pytest.raises(RuntimeError):
        work(True)
    assert not probe._stack              # the raise closed both spans
    handler.step_start(0)                # the step, run again
    work(False)
    handler.step_end(0)
    probe.count("x")
    free, failed, again = probe.snapshot()
    assert [failed["step"], again["step"]] == [0, 0]
    for row in (failed, again):
        assert row["counts"] == {"x": 1}
        assert [row["spans"][n]["calls"] for n in ("work", "inner")] \
            == [1, 1]
    assert free["counts"] == {"x": 1}


@pytest.mark.parametrize("enabled", [False, True], ids=["off", "on"])
def test_a_fine_session_counts_its_buffers_and_scanned_handles(enabled):
    if enabled:
        probe.enable()
    seen = _Buffers()
    _analyze(observe=seen)
    rows = [r for r in probe.snapshot() if r["step"] is not None]
    assert [r["step"] for r in rows] == [0, 1]
    for r in rows:
        step = r["step"]
        assert seen.events[step] > 0
        assert r["counts"]["trace buffers"] == seen.events[step]
        assert r["counts"]["pool handles scanned"] == seen.handles[step]
        assert r["counts"]["reduction wait ns"] > 0
        assert r["spans_on"] is enabled
        assert bool(r["spans"]) is enabled


def test_a_fine_session_nests_its_spans_under_each_emission():
    gc_was = gc.isenabled()
    gc.disable()            # no collection spans among the children
    try:
        probe.enable()
        seen = _Buffers()
        _analyze(observe=seen)
    finally:
        if gc_was:
            gc.enable()
    for r in probe.snapshot():
        if r["step"] is None:
            continue
        n, spans = seen.events[r["step"]], r["spans"]
        for name in ("trace emission", "trace reduction", *EMIT_CHILDREN):
            assert spans[name]["calls"] == n, name
        # each parent's time outside itself is exactly its children's
        emit = spans["trace emission"]
        assert emit["total_ns"] - emit["self_ns"] == sum(
            spans[c]["total_ns"] for c in EMIT_CHILDREN)
        reduce = spans["trace reduction"]
        assert reduce["total_ns"] - reduce["self_ns"] == sum(
            spans[c]["total_ns"] for c in REDUCE_CHILDREN)
        for name in ("op", "pool alloc", "frees", "handler dispatch",
                     "processor", "tool workingset", "tool hotness",
                     "tool locator", "locator stack capture",
                     *REDUCE_CHILDREN):
            assert spans[name]["calls"] > 0, name
    assert not probe._stack


def test_spans_turn_on_under_the_profiler_with_no_enable_call():
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("the run"):
            _analyze(steps=1)
            gc.collect()
    assert not probe._enabled
    rows = _rows(0)
    assert len(rows) == 1 and rows[0]["spans_on"]
    probe.start_step(1)                     # the profiler has stopped
    assert not probe.ON
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]
    run = next(e.time_range for e in events if e.name == "the run")
    ranges = {}
    for e in events:
        ranges.setdefault(e.name, []).append(e.time_range)
    for name in ("op", "trace emission", *EMIT_CHILDREN, "trace reduction",
                 "handler dispatch", "processor", "tool locator",
                 "reduce copies", "reduce launch"):
        assert name in ranges, name
        for tr in ranges[name]:
            assert run.start <= tr.start and tr.end <= run.end, name
    assert len(ranges["trace emission"]) \
        == rows[0]["spans"]["trace emission"]["calls"]

    def inside(name, parent):
        for tr in ranges[name]:
            assert any(p.start <= tr.start and tr.end <= p.end
                       for p in ranges[parent]), (name, parent)
    inside("trace reduction", "emit dispatch")
    for name in EMIT_CHILDREN:
        inside(name, "trace emission")
    for name in REDUCE_CHILDREN:
        inside(name, "trace reduction")


def test_the_analyze_launcher_prints_the_spans_a_step(capsys):
    analyze.main(["--arch", "glm4-9b", "--reduced", "--device", "cpu",
                  "--steps", "2", "--spans"])
    out = capsys.readouterr().out
    assert "spans over 2 steps" in out
    for name in ("trace emission:", "emit live objects:", "reduce copies:"):
        assert name in out, name
    assert "counters a step: pool handles scanned" in out


def test_reports_are_equal_with_the_probe_on_and_off():
    got = {}
    for enabled in (False, True):
        tevents.reset_seq()
        tsession.reset_state()
        probe.reset()
        probe.enable(enabled)
        reports, logits, _schedule = _analyze()
        got[enabled] = (reports.data, logits)
    assert got[True][0] == got[False][0]
    assert torch.equal(got[True][1], got[False][1])


@pytest.mark.parametrize("module,cls_name,attr", SPANNED_METHODS,
                         ids=[f"{c}.{a}" for _m, c, a in SPANNED_METHODS])
def test_the_spanned_methods_stay_on_their_classes(module, cls_name, attr):
    cls = getattr(importlib.import_module(module), cls_name)
    fn = cls.__dict__[attr]
    assert callable(fn) and fn.__name__ == attr
    assert fn.__wrapped__.__qualname__ == f"{cls_name}.{attr}"
