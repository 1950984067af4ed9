"""PASTA event handler (paper §III-B).

Abstracts the platform's event sources behind one ``emit``/``subscribe``
surface.  Sources:

  * **framework callbacks** — the model code calls
    ``operator_start/operator_end``, the
    :class:`~repro_torch.core.pool.MemoryPool` emits tensor/object memory
    events, ``pasta.start/end`` emit region events;
  * **device trace buffers** — access records surfaced as TRACE_BUFFER
    events and aggregated on the GPU by the event processor.

The dispatch spine is columnar: every emission flows through
:class:`~repro_torch.core.events.EventBatch` dispatch.  ``emit(Event)`` is a thin
compatibility shim that wraps a one-row batch; ``emit_row`` appends to the
SoA ring without constructing an Event; ``emit_batch`` hands a whole
producer-built batch to the subscribers.  With buffering enabled, rows
accumulate in the ring and flush at capacity, at step boundaries, or on an
explicit ``flush()`` — the paper's low-overhead principle: do almost nothing
at event time, aggregate in the processor (on device where volumes are
large).
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import Callable, Iterable

import numpy as np

from .annotate import GridIdFilter, current_region
from . import capture as capture_mod
from . import events as events_mod
from .events import (Event, EventBatch, EventKind, EventRing, KIND_CODE,
                     KIND_LIST)


class EventHandler:
    def __init__(self, device: tuple = (), buffer_capacity: int = 4096,
                 buffered: bool = False):
        self._subs: dict = collections.defaultdict(list)   # scalar fns
        self._batch_subs: list = []                        # batch fns
        self.enabled = True
        self.device = device
        self.grid_filter = GridIdFilter()
        self._grid_id = 0
        self._step = -1
        self.buffer_capacity = buffer_capacity
        self._buffered = buffered
        self._ring = EventRing(buffer_capacity)

    # ------------------------------------------------------------ subscribe
    def subscribe(self, fn: Callable[[Event], None],
                  kinds: Iterable = ("*",)) -> None:
        """Subscribe a scalar per-event callback (compatibility surface)."""
        for k in kinds:
            key = k if isinstance(k, str) else k.value
            self._subs[key].append(fn)

    def subscribe_batch(self, fn: Callable[[EventBatch], None]) -> None:
        """Subscribe a columnar consumer; called once per EventBatch, before
        any scalar subscribers (so normalization lands first)."""
        self._batch_subs.append(fn)

    def unsubscribe(self, fn) -> None:
        """Remove ``fn`` wherever it is subscribed (scalar or batch)."""
        while fn in self._batch_subs:
            self._batch_subs.remove(fn)
        for subs in self._subs.values():
            while fn in subs:
                subs.remove(fn)

    def unsubscribe_all(self) -> None:
        self._subs.clear()
        self._batch_subs.clear()

    # ------------------------------------------------------------ buffering
    @property
    def buffered(self) -> bool:
        return self._buffered

    def set_buffered(self, on: bool) -> None:
        """Toggle ring buffering; disabling flushes pending rows first."""
        if self._buffered and not on:
            self.flush()
        self._buffered = on

    @contextlib.contextmanager
    def buffering(self):
        """Scoped ring buffering: rows batch up inside, flush on exit."""
        prev = self._buffered
        self._buffered = True
        try:
            yield self
        finally:
            self.flush()
            self._buffered = prev

    def flush(self) -> None:
        """Dispatch whatever is pending in the ring as one batch."""
        batch = self._ring.flush()
        if batch is not None:
            self._dispatch(batch)

    # ----------------------------------------------------------------- emit
    def emit(self, ev: Event) -> None:
        """Scalar emit — compatibility shim over the columnar spine: fills
        defaults, then either appends to the ring (buffered) or dispatches a
        one-row batch wrapping this very object."""
        if not self.enabled:
            return
        if ev.step < 0:
            ev.step = self._step
        if not ev.region:
            ev.region = current_region()
        if not ev.device:
            ev.device = self.device
        if self._buffered:
            if self._ring.append(KIND_CODE[ev.kind], ev.name, ev.step,
                                 ev.time, ev.size, ev.addr, ev.seq, ev.attrs,
                                 ev.device, ev.region, event=ev):
                self.flush()
            return
        self._dispatch(EventBatch.from_events((ev,)))

    def emit_row(self, kind: EventKind, name: str = "", step: int = -1,
                 time_: float | None = None, size: int = 0, addr: int = 0,
                 device: tuple | None = None, region: tuple | None = None,
                 attrs: dict | None = None, seq: int | None = None) -> int:
        """Allocation-light emit: appends one row to the ring (or dispatches
        a one-row batch when buffering is off) without constructing an Event.
        Returns the row's sequence number.  Pass a pre-reserved ``seq``
        (:func:`repro_torch.core.events.next_seq`) when the producer must stamp
        its own bookkeeping before subscribers run."""
        if seq is None:
            seq = next(events_mod._seq)
        if not self.enabled:
            return seq
        if step < 0:
            step = self._step
        if time_ is None:
            time_ = time.perf_counter()
        if not device:
            device = self.device
        if region is None:
            region = current_region()
        if self._buffered:
            if self._ring.append(KIND_CODE[kind], name, step, time_, size,
                                 addr, seq, attrs, device, region):
                self.flush()
            return seq
        batch = EventBatch.of(
            kind, names=(name,), steps=(step,), times=(time_,),
            sizes=(size,), addrs=(addr,), seqs=(seq,),
            attrs=None if attrs is None else [attrs],
            device=device, region=region)
        self._dispatch(batch)
        return seq

    def emit_batch(self, batch: EventBatch) -> None:
        """Dispatch a producer-built columnar batch.  Pending ring rows are
        flushed first so cross-path event order is preserved."""
        if not self.enabled:
            return
        if self._buffered:
            self.flush()
        neg = batch.steps < 0
        if neg.any():
            batch.steps = np.where(neg, self._step, batch.steps)
        if isinstance(batch.devices, tuple) and not batch.devices:
            batch.devices = self.device
        if isinstance(batch.regions, tuple) and not batch.regions:
            batch.regions = current_region()
        self._dispatch(batch)

    # ------------------------------------------------------------- dispatch
    def _dispatch(self, batch: EventBatch) -> None:
        for fn in tuple(self._batch_subs):
            fn(batch)
        if not self._subs:
            return
        if len(batch) == 1:
            ev = batch.event(0)
            for fn in self._subs.get(ev.kind.value, ()):
                fn(ev)
            for fn in self._subs.get("*", ()):
                fn(ev)
            return
        star = self._subs.get("*", ())
        if star:
            idx = range(len(batch))
        else:
            wanted = [c for c in np.unique(batch.kinds)
                      if self._subs.get(KIND_LIST[c].value)]
            if not wanted:
                return
            idx = np.nonzero(np.isin(batch.kinds, np.asarray(
                wanted, dtype=np.int16)))[0]
        for i in idx:
            ev = batch.event(int(i))
            for fn in self._subs.get(ev.kind.value, ()):
                fn(ev)
            for fn in star:
                fn(ev)

    # ------------------------------------------------- framework-side hooks
    def operator_start(self, name: str, **attrs) -> Event:
        ev = Event(EventKind.OPERATOR_START, name=name, attrs=attrs)
        self.emit(ev)
        return ev

    def operator_end(self, name: str, **attrs) -> Event:
        ev = Event(EventKind.OPERATOR_END, name=name, attrs=attrs)
        self.emit(ev)
        return ev

    def step_start(self, step: int) -> None:
        """Step edge: a flush boundary for the buffered path."""
        self._step = step
        self.emit_row(EventKind.STEP_START, name=f"step{step}", step=step)
        if self._buffered:
            self.flush()

    def step_end(self, step: int, **attrs) -> None:
        self.emit_row(EventKind.STEP_END, name=f"step{step}", step=step,
                      attrs=attrs)
        if self._buffered:
            self.flush()

    def sync(self, name: str = "sync") -> None:
        self.emit_row(EventKind.SYNC, name=name)

    def memcpy(self, nbytes: int, direction: str, name: str = "") -> None:
        self.emit_row(EventKind.MEMCPY, name=name or f"memcpy_{direction}",
                      size=nbytes, attrs={"direction": direction})

    def trace_buffer(self, records, name: str = "", **attrs) -> None:
        """Surface a device access-record buffer (fine-grained tier).
        Trace rows are rare and HEAVY (raw access records): they bypass the
        ring and dispatch immediately, so the processor reduces them to
        O(#objects) aggregates right away instead of the ring pinning raw
        buffers until the next flush boundary."""
        if self._buffered:
            self.flush()                 # keep cross-row ordering
            self._buffered = False
            try:
                self.emit_row(EventKind.TRACE_BUFFER, name=name,
                              attrs={"records": records, **attrs})
            finally:
                self._buffered = True
            return
        self.emit_row(EventKind.TRACE_BUFFER, name=name,
                      attrs={"records": records, **attrs})

    # ------------------------------------------------ compiled-step capture
    def capture_compiled(self, artifact_or_fn, label: str = "",
                         default_trip: int = 1, steps: int = 1,
                         cost_analysis: dict | None = None):
        """Emit kernel/collective events for a captured step: a
        :class:`~repro_torch.core.capture.StepArtifact`, a
        :class:`~repro_torch.core.trace.StepTrace` (the static
        counterpart: records scaled by their trip counts), or a
        no-argument callable, which is captured first.  Returns the
        :class:`~repro_torch.core.capture.CaptureStats` rollup."""
        from . import trace as trace_mod
        artifact = artifact_or_fn
        if callable(artifact_or_fn):
            artifact = capture_mod.capture_step(artifact_or_fn)
        t0 = time.perf_counter()
        if isinstance(artifact, trace_mod.StepTrace):
            stats = trace_mod.analyze_trace(artifact)
        else:
            stats = capture_mod.analyze(artifact, default_trip=default_trip)
        parse_s = time.perf_counter() - t0
        self.emit(Event(EventKind.COMPILE, name=label,
                        attrs={"parse_s": parse_s,
                               "cost_analysis": cost_analysis or {}}))
        for kname, count in stats.kernel_counts.items():
            gid = self._grid_id
            self._grid_id += 1
            if not self.grid_filter(gid):
                continue
            meta = stats.kernel_meta.get(kname, {})
            self.emit(Event(EventKind.KERNEL_LAUNCH, name=kname,
                            attrs={"count": count * steps, "grid_id": gid,
                                   "label": label,
                                   "op_name": meta.get("op_name", ""),
                                   "bytes": meta.get("bytes", 0)}))
        for inst in stats.collective_instances:
            self.emit(Event(EventKind.COLLECTIVE, name=inst["name"],
                            size=int(inst["bytes"]),
                            attrs={"opcode": inst["opcode"],
                                   "mult": inst["mult"] * steps,
                                   "group_size": inst["group_size"],
                                   "label": label,
                                   "overlapped": inst["overlapped"],
                                   "exposed_bytes": inst["exposed_bytes"],
                                   "hidden_s": inst["hidden_s"],
                                   "wire_bytes": inst["wire_bytes"]}))
        return stats


# ---------------------------------------------------------------------------
# Deprecated process-global surface: thin shims over the implicit root
# session (see repro_torch.core.session).  New code uses pasta.Session /
# repro_torch.core.session.current_handler().
# ---------------------------------------------------------------------------

def default_handler() -> EventHandler:
    """Deprecated: the old process-global handler accessor.  Resolves the
    *current session's* handler (innermost active session, falling back
    to the implicit root session)."""
    import warnings
    warnings.warn(
        "pasta.default_handler() is deprecated; use pasta.Session (scoped "
        "pipelines) or repro_torch.core.session.current_handler()",
        DeprecationWarning, stacklevel=2)
    from .session import current_handler
    return current_handler()


def attach(handler: EventHandler | None = None) -> EventHandler:
    """Deprecated: install ``handler`` as the process-global default (the
    paper's per-process LD_PRELOAD injection).  Replaces the implicit root
    session's handler; scoped ``with pasta.Session(...)`` blocks are the
    supported interface."""
    import warnings
    warnings.warn(
        "pasta.attach() is deprecated; use `with pasta.Session(...)` — "
        "scoped sessions replace the process-global handler",
        DeprecationWarning, stacklevel=2)
    from .session import _attach_root
    return _attach_root(handler)
