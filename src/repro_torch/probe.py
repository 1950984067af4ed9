"""The port's own probe: spans and counters along the session path.

It imports nothing of the port, so every layer (``core``, ``kernels``)
can import it without loading another.

Two kinds of reading, kept per step in *rows*:

  * **counters** (:func:`count`) are always on: an integer added to the
    current step's row (``trace buffers``, ``pool handles scanned``,
    ``reduction wait ns``);
  * **spans** (:func:`span`, :func:`wrap`) time a block or a whole method.
    Off, a span costs one check of the module's ``ON`` flag and returns a
    shared null context.  On, it adds its call, its duration and its self
    time (the duration less that of the spans opened directly inside it)
    on :func:`time.perf_counter_ns` to the row it was opened in.  While a
    ``torch.profiler`` session records it is also the profiler's fast
    host range (``torch._C._profiler._RecordFunctionFast``), so it sits on
    the profiler's clock beside the device's operations and each idle gap
    of the device can be put down to the span open over it.  That range
    puts nothing on the device's timeline.

``EventHandler.step_start`` (:mod:`repro_torch.core.handler`) opens a
row (:func:`start_step`) and refreshes ``ON``: spans are on after
:func:`enable` or while the profiler records, which is looked at once a
step.  ``step_end`` closes the row (:func:`end_step`); counts and spans
outside a step go to the row with no step.  A step that raises before
its end leaves its row open until the next :func:`start_step`, which
closes it.  The newest :data:`ROWS` step rows are kept.  While spans are
on, every garbage collection is a ``gc`` span, so its time leaves the
self time of the span it interrupts.

:func:`snapshot` gives, for each row, its step, its counts, whether its
spans were on, and each span name's calls, total and self time.  The
probe keeps one stack: it times the thread that runs the session.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import gc
import time

#: step rows kept, the newest: a benchmark window and the steps before it
ROWS = 4096
#: spans are kept (refreshed at each step start, and by :func:`enable`)
ON = False
_enabled = False          # enable() was called
_profiling = False        # a torch.profiler session was recording at refresh
_range = None             # the profiler's fast range, once torch is imported
_clock = time.perf_counter_ns
_NULL = contextlib.nullcontext()


class _Row:
    __slots__ = ("step", "spans_on", "counts", "spans")

    def __init__(self, step, spans_on: bool):
        self.step = step
        self.spans_on = spans_on
        self.counts: dict = {}
        self.spans: dict = {}     # name -> [calls, total_ns, self_ns]


_free = _Row(None, False)     # outside any step
_rows: collections.deque = collections.deque(maxlen=ROWS)
_row = _free
_stack: list = []             # the open spans, innermost last
_gc_open: list = []


class _Span:
    __slots__ = ("name", "row", "inner", "range", "start")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.row = _row
        self.inner = 0
        self.range = None
        if _profiling:
            self.range = _range(self.name)
            self.range.__enter__()
        self.start = _clock()
        _stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        took = _clock() - self.start
        if _stack and _stack[-1] is self:
            _stack.pop()
            if _stack:
                _stack[-1].inner += took
        if self.range is not None:
            self.range.__exit__(None, None, None)
        acc = self.row.spans.get(self.name)
        if acc is None:
            acc = self.row.spans[self.name] = [0, 0, 0]
        acc[0] += 1
        acc[1] += took
        acc[2] += took - self.inner
        return False


def span(name: str):
    """A context manager timing its block as the span ``name``."""
    if not ON:
        return _NULL
    return _Span(name)


def wrap(name: str):
    """Decorator form of :func:`span`: each call of the function is a span
    ``name``.  The function keeps its name and its place on its class."""
    def deco(fn):
        @functools.wraps(fn)
        def spanned(*args, **kw):
            if not ON:
                return fn(*args, **kw)
            with _Span(name):
                return fn(*args, **kw)
        return spanned
    return deco


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` of the current row (always on)."""
    counts = _row.counts
    counts[name] = counts.get(name, 0) + n


def _on_gc(phase: str, info) -> None:
    if phase == "start":
        if ON:
            _gc_open.append(_Span("gc").__enter__())
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def _refresh() -> None:
    global ON, _profiling, _range
    import torch
    profiling = torch.autograd._profiler_enabled()
    on = _enabled or profiling
    if profiling and _range is None:
        _range = torch._C._profiler._RecordFunctionFast
    if on and _on_gc not in gc.callbacks:
        gc.callbacks.append(_on_gc)
    elif not on and _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    ON, _profiling = on, profiling


def enable(on: bool = True) -> None:
    """Keep spans from now on (or stop keeping them), profiler or not."""
    global _enabled
    _enabled = on
    _refresh()


def start_step(step: int) -> None:
    """Open the row of ``step``, closing any row still open; refresh
    whether spans are on."""
    global _row
    _refresh()
    _row = _Row(step, ON)
    _rows.append(_row)


def end_step() -> None:
    """Close the current step's row: what follows goes to the row with no
    step."""
    global _row
    _row = _free


def reset() -> None:
    """Forget every row and span, and turn spans off."""
    global _free, _row
    _free = _row = _Row(None, False)
    _rows.clear()
    _stack.clear()
    _gc_open.clear()
    enable(False)


def _view(row: _Row) -> dict:
    return {"step": row.step, "counts": dict(row.counts),
            "spans_on": row.spans_on or bool(row.spans),
            "spans": {name: {"calls": a[0], "total_ns": a[1], "self_ns": a[2]}
                      for name, a in row.spans.items()}}


def snapshot() -> list:
    """One dict a row, the row with no step first, then the kept step rows
    in the order they were opened: ``step`` (None outside any step),
    ``counts`` ({name: int}), ``spans_on`` (whether spans were kept in it)
    and ``spans`` ({name: {"calls", "total_ns", "self_ns"}}, closed spans
    only)."""
    return [_view(r) for r in (_free, *_rows)]
