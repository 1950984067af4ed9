"""Host spans around the calls into the port's layers, with self time.

A copy, in the benchmark, of the method of ``chip_smoke.py``'s
``HostSpans``: for the length of a ``with`` block each listed method is
replaced by a wrapper that times the call.  Wrappers nest (an operator
hook emits a trace buffer, which is reduced), so each span keeps its
total and its self time: the total less the time of the spans called
inside it.  While ``annotate`` is set, each call is also a
``torch.profiler.record_function`` range, so a profiled window can say
what the host did while the device idled.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import importlib
import time

import torch

#: span name -> (module, class, method) of the port
PORT_SPANS = (
    ("op", "repro_torch.core.instrument", "EagerInstrumenter", "op"),
    ("pool alloc", "repro_torch.core.pool", "MemoryPool", "alloc"),
    ("trace emission", "repro_torch.core.instrument", "EagerInstrumenter",
     "_emit_trace"),
    ("trace reduction", "repro_torch.core.processor", "EventProcessor",
     "_preprocess_trace"),
    ("locator stack capture", "repro_torch.core.tools.locator",
     "LocatorTool", "_capture_stack"),
    ("frees", "repro_torch.core.instrument", "EagerInstrumenter", "_on_free"),
)


class HostSpans:
    def __init__(self, table=PORT_SPANS):
        self.table = table
        self.annotate = False
        self._stack: list = []
        self._orig: list = []
        self.reset()

    def reset(self) -> None:
        self.self_s = collections.defaultdict(float)
        self.total_s = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)

    def _enter(self, name):
        frame = [0.0, None]
        if self.annotate:
            frame[1] = torch.profiler.record_function(name)
            frame[1].__enter__()
        self._stack.append(frame)
        return frame, time.perf_counter()

    def _exit(self, name, frame, t0) -> None:
        dt = time.perf_counter() - t0
        if frame[1] is not None:
            frame[1].__exit__(None, None, None)
        self._stack.pop()
        self.self_s[name] += dt - frame[0]
        self.total_s[name] += dt
        self.calls[name] += 1
        if self._stack:
            self._stack[-1][0] += dt

    def wrap(self, name: str, fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            frame, t0 = self._enter(name)
            try:
                return fn(*args, **kw)
            finally:
                self._exit(name, frame, t0)
        return timed

    @contextlib.contextmanager
    def span(self, name: str):
        """A span around a block of the benchmark's own code."""
        frame, t0 = self._enter(name)
        try:
            yield
        finally:
            self._exit(name, frame, t0)

    def __enter__(self) -> "HostSpans":
        for name, module, cls_name, attr in self.table:
            cls = getattr(importlib.import_module(module), cls_name)
            fn = cls.__dict__[attr]
            self._orig.append((cls, attr, fn))
            setattr(cls, attr, self.wrap(name, fn))
        return self

    def __exit__(self, *exc) -> None:
        for cls, attr, fn in reversed(self._orig):
            setattr(cls, attr, fn)
        self._orig.clear()
