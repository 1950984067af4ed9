"""The readers of the port's probe (``portbench/probe_rows.py`` and the six
metrics on it): exact values on a snapshot built here under a fake clock,
nothing where the port has no probe, and a traced run of each tiny cell."""

import gc
import sys
import types

import pytest

import small
from portbench import harness

from repro_torch import probe

READERS = ("reduction_wait_ms_per_buffer", "pool_scan_growth_per_step",
           "emit_objects_ms_per_step", "processor_ms_per_step",
           "tools_ms_per_step", "gc_ms_per_step")
MS = 1_000_000


def read(name, run):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(run)


@pytest.fixture(autouse=True)
def _probe():
    probe.reset()
    yield
    probe.reset()


@pytest.fixture
def built(monkeypatch):
    """Two profiled steps (spans on), then a window of three (counters)."""
    ticks = iter(range(0, 10**12, MS))             # one ms a clock read
    monkeypatch.setattr(probe, "_clock", lambda: next(ticks))
    gc_was = gc.isenabled()
    gc.disable()
    try:
        probe.enable()
        for step in (0, 1):
            probe.start_step(step)
            with probe.span("trace emission"):      # 0 .. 3: self 2
                with probe.span("emit live objects"):
                    pass
            with probe.span("processor"):           # self 2 + 1
                with probe.span("handler dispatch"):
                    pass
            for tool in ("tool hotness", "tool locator"):
                with probe.span(tool):
                    pass
            with probe.span("gc"):
                pass
            probe.end_step()
        probe.enable(False)
        for step in (2, 3, 4):
            probe.start_step(step)
            probe.count("trace buffers", 10)
            probe.count("pool handles scanned", 10 * (100 + 7 * step))
            probe.count("reduction wait ns", 10 * 2 * MS)
            probe.end_step()
    finally:
        if gc_was:
            gc.enable()
    return types.SimpleNamespace(steps=3)


def test_the_readers_read_the_rows_they_name(built):
    got = {name: read(name, built) for name in READERS}
    assert got == {"reduction_wait_ms_per_buffer": 2.0,
                   "pool_scan_growth_per_step": 7.0,
                   "emit_objects_ms_per_step": 1.0,
                   "processor_ms_per_step": 3.0,
                   "tools_ms_per_step": 2.0,
                   "gc_ms_per_step": 1.0}


def test_the_readers_read_nothing_without_the_probe(built, monkeypatch):
    import repro_torch
    monkeypatch.delattr(repro_torch, "probe")      # as on a port without it
    monkeypatch.setitem(sys.modules, "repro_torch.probe", None)
    for name in READERS:
        assert read(name, built) is None, name


@pytest.mark.parametrize("name", small.CELLS)
def test_a_traced_run_of_a_tiny_cell_reads_the_probes_metrics(name):
    """The profiled steps turn the spans on; the window's rows hold the
    counters (a 2-s window, so that the growth has two steps to read)."""
    res = small.run(name, seconds=2.0, trace=True)
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 2
    got = res["metrics"]
    for metric in READERS:
        assert isinstance(got[metric]["value"], float), metric
    profiled = [r for r in probe.snapshot()
                if r["spans_on"] and r["step"] is not None]
    assert [r["step"] for r in profiled] == [1, 2]
