"""Unified PASTA session facade — scoped attach, tool registry, reports.

The paper promises "a unified interface to capture and analyze runtime
events at multiple levels"; :class:`Session` is that interface.  One object
owns the whole pipeline — ``EventHandler`` → ``EventProcessor`` → tool
collection — plus its event sources (the :class:`EagerInstrumenter`
framework hooks and the virtual :class:`MemoryPool`)::

    with pasta.Session(tools="workingset,hotness", instrument=True,
                       fine=True, torch_device="cuda") as s:
        run_workload()
    for name, report in s.reports().items():
        print(name, report.data)

Attachment is *scoped*, not ambient: the innermost active session is carried
in a :mod:`contextvars` variable, so nested sessions compose (region events
route to the innermost scope) and concurrent sessions — per test, per
serving request, per thread — stay fully isolated.  ``pasta.region`` /
``pasta.start`` / ``pasta.end`` and a handler-less :class:`MemoryPool`
resolve the current session dynamically at emit time.

Emission outside any entered session lands in an implicit, bare *root*
session (handler only).
"""

from __future__ import annotations

import contextvars
import dataclasses
import itertools as _itertools
import json
from typing import Iterator, Mapping

import numpy as np

from .. import probe
from .handler import EventHandler
from .processor import EventProcessor
from .tools.base import resolve_tools


# ---------------------------------------------------------------------------
# Structured reports
# ---------------------------------------------------------------------------

def _json_default(o):
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, set):
        return sorted(o)
    return str(o)


@dataclasses.dataclass
class Report:
    """One tool's ``finalize()`` result, keyed by registry name.

    ``tool`` is the registry key (``"workingset"``), ``tool_class`` the
    implementing class name, ``session`` the owning session's name, and
    ``data`` the tool's report dict.  Mapping-style access delegates to
    ``data`` so existing ``report["working_set_mb"]`` call sites keep
    working.
    """

    tool: str
    tool_class: str
    session: str
    data: dict

    def __getitem__(self, key):
        return self.data[key]

    def __contains__(self, key) -> bool:
        return key in self.data

    def get(self, key, default=None):
        return self.data.get(key, default)

    def keys(self):
        return self.data.keys()

    def asdict(self) -> dict:
        return {"tool": self.tool, "tool_class": self.tool_class,
                "session": self.session, "data": self.data}

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps(self.asdict(), default=_json_default,
                          indent=indent)


class Reports(Mapping):
    """Immutable mapping of registry name → :class:`Report` with JSON and
    JSONL export (one report per line — streamable into any log pipeline)."""

    __slots__ = ("_reports",)

    def __init__(self, reports: dict):
        self._reports = dict(reports)

    def __getitem__(self, key: str) -> Report:
        return self._reports[key]

    def __iter__(self) -> Iterator[str]:
        return iter(self._reports)

    def __len__(self) -> int:
        return len(self._reports)

    def __repr__(self) -> str:
        return f"Reports({list(self._reports)})"

    @property
    def data(self) -> dict:
        """Plain ``{registry_name: report_data_dict}`` view (goldens,
        equality tests)."""
        return {k: r.data for k, r in self._reports.items()}

    def to_json(self, indent: int | None = None) -> str:
        return json.dumps({k: r.asdict() for k, r in self._reports.items()},
                          default=_json_default, indent=indent)

    def to_jsonl(self, dest) -> int:
        """Stream one JSON line per report to ``dest`` (a path or a
        writable file object).  Returns the number of lines written."""
        if hasattr(dest, "write"):
            for rep in self._reports.values():
                dest.write(rep.to_json() + "\n")
        else:
            with open(dest, "w") as f:
                for rep in self._reports.values():
                    f.write(rep.to_json() + "\n")
        return len(self._reports)


# ---------------------------------------------------------------------------
# The session facade
# ---------------------------------------------------------------------------

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "pasta_current_session", default=None)

_root: "Session | None" = None


class Session:
    """One isolated PASTA pipeline: handler → processor → tools + sources.

    Parameters
    ----------
    tools:
        Tool spec — a registry string (``"workingset,locator"``, knobs via
        ``"hotness:n_tbins=8"``), a list mixing instances / classes / names,
        or ``None`` (falls back to the ``PASTA_TOOL`` environment variable).
    buffered / buffer_capacity:
        Ring-buffer coarse events through the handler's SoA ring (flushed at
        capacity, step boundaries, session exit, and ``reports()``).
    hotness / device_analysis / torch_device:
        Forwarded to :class:`EventProcessor` (trace-reduction configuration;
        ``torch_device`` is the torch device the reductions run on —
        ``device`` is the handler's device label, as in the events).
    instrument / fine / stride / pool_chunk / pool_align / time_source:
        When ``instrument=True`` the session owns an
        :class:`~repro_torch.core.instrument.EagerInstrumenter` (entered and
        exited with the session) wired to the session handler.
    forward_to:
        Internal — a parent handler that receives every batch this session
        dispatches (used by :meth:`child` so per-request sessions still feed
        their parent's aggregate tools).

    Entering the session (``with session:``) makes it the *current* session
    for the enclosed scope: ``pasta.region``/``start``/``end``, handler-less
    ``MemoryPool``s resolve to it.  Sessions
    nest — the innermost active one wins — and concurrent sessions in other
    threads/contexts are unaffected (contextvars scoping).
    """

    def __init__(self, tools=None, *, name: str = "session",
                 handler: EventHandler | None = None,
                 buffered: bool = False, buffer_capacity: int = 4096,
                 device: tuple = (), hotness: dict | None = None,
                 device_analysis: bool = True, torch_device="cuda",
                 instrument: bool = False,
                 fine: bool = False, stride: int = 512,
                 pool_chunk: int = 32 * 1024 * 1024,
                 pool_align: int | None = None, time_source=None,
                 forward_to: EventHandler | None = None,
                 _bare: bool = False):
        self.name = name
        self.handler = handler if handler is not None else EventHandler(
            device=device, buffer_capacity=buffer_capacity,
            buffered=buffered)
        self.parent: "Session | None" = None
        self.children: list = []
        self._child_ids = _itertools.count()
        self.closed = False
        self.processor: EventProcessor | None = None
        self.instrumenter = None
        self._hotness = hotness
        self._device_analysis = device_analysis
        self._torch_device = torch_device
        self._tokens: list = []
        self._pool = None
        self._forward_handler = None
        if _bare:
            # implicit root: handler only — the caller hand-wires processors
            self.tools = []
            return
        self.tools = resolve_tools(tools)
        self.processor = EventProcessor(
            self.handler, tools=self.tools,
            device_analysis=device_analysis, hotness=hotness,
            device=torch_device)
        if instrument:
            from .instrument import EagerInstrumenter
            self.instrumenter = EagerInstrumenter(
                self.handler, fine=fine, stride=stride,
                pool_chunk=pool_chunk, pool_align=pool_align,
                time_source=time_source)
        if forward_to is not None:
            if forward_to is self.handler:
                raise ValueError("session cannot forward to its own handler")
            self._forward_handler = forward_to
            # subscribed after the processor: batches forward already
            # normalized, so the parent pipeline never re-normalizes
            self.handler.subscribe_batch(self._forward)

    # ------------------------------------------------------------ scoping
    def __enter__(self) -> "Session":
        if self.closed:
            raise RuntimeError(f"session {self.name!r} is closed")
        self._tokens.append(_CURRENT.set(self))
        if self.instrumenter is not None:
            self.instrumenter.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if self.instrumenter is not None:
            self.instrumenter.__exit__(*exc)
        self.handler.flush()
        if self._tokens:            # close() inside the block already reset
            _CURRENT.reset(self._tokens.pop())

    def child(self, tools=(), *, name: str | None = None,
              forward: bool = True, **kw) -> "Session":
        """A nested session with its own pipeline (isolated tools/reports),
        inheriting this session's processor configuration.  With ``forward=
        True`` (default) every batch the child dispatches is mirrored to
        this session's handler, so parent aggregates still see the events —
        the per-request pattern: one child per served request, parent keeps
        the fleet-wide view.  ``tools`` defaults to *none* (children never
        implicitly inherit the ``PASTA_TOOL`` environment default).  Closing
        a child drops it from ``children``, so long-lived parents don't
        accumulate request pipelines."""
        c = Session(
            tools=tools,
            name=name or f"{self.name}/child{next(self._child_ids)}",
            buffered=kw.pop("buffered", self.handler.buffered),
            device=kw.pop("device", self.handler.device),
            hotness=kw.pop("hotness", self._hotness),
            device_analysis=kw.pop("device_analysis", self._device_analysis),
            torch_device=kw.pop("torch_device", self._torch_device),
            forward_to=self.handler if forward else None, **kw)
        c.parent = self
        self.children.append(c)
        return c

    def _forward(self, batch) -> None:
        self._forward_handler.emit_batch(batch)

    # ------------------------------------------------------------- sources
    @property
    def pool(self):
        """The session's memory pool: the instrumenter's when instrumenting,
        else a lazily-created pool bound to the session handler."""
        if self.instrumenter is not None:
            return self.instrumenter.pool
        if self._pool is None:
            from .pool import MemoryPool
            self._pool = MemoryPool(self.handler)
        return self._pool

    def capture_compiled(self, artifact_or_fn, label: str = "",
                         default_trip: int = 1, steps: int = 1,
                         cost_analysis: dict | None = None):
        """Compiled-step capture through this session's handler."""
        return self.handler.capture_compiled(
            artifact_or_fn, label=label, default_trip=default_trip,
            steps=steps, cost_analysis=cost_analysis)

    def add_tool(self, tool) -> None:
        if self.processor is None:
            raise RuntimeError("bare (root) session has no "
                               "processor; construct pasta.Session(...) "
                               "instead")
        self.processor.add_tool(tool)
        self.tools = self.processor.tools

    # ------------------------------------------------------------- reports
    @probe.wrap("session reports")
    def reports(self) -> Reports:
        """Flush pending events and collect every tool's report, keyed by
        registry name (``REGISTRY_NAME``; class name for unregistered
        tools, ``#2``-suffixed on collisions)."""
        from .tools.base import TOOL_REGISTRY
        self.handler.flush()
        out: dict = {}
        for t in (self.processor.tools if self.processor is not None else ()):
            base = getattr(t, "REGISTRY_NAME", None)
            if base is None or TOOL_REGISTRY.get(base) is not type(t):
                # unregistered subclasses inherit REGISTRY_NAME from their
                # registered base — key those by their own class name
                base = type(t).__name__
            key, i = base, 2
            while key in out:
                key = f"{base}#{i}"
                i += 1
            out[key] = Report(tool=key, tool_class=type(t).__name__,
                              session=self.name, data=t.finalize())
        return Reports(out)

    # ----------------------------------------------------------- lifecycle
    def close(self) -> None:
        """Detach the pipeline.  Idempotent — any ``with`` + explicit-close
        pattern may close a session that already
        exited its context, or close it twice.  Pending ring rows flush
        BEFORE the processor detaches, so a buffered session closed without
        exiting its context still delivers every event to its tools (and
        forwards them to its parent).  Reports stay readable after close;
        closed children drop out of their parent's ``children`` list
        (long-lived parents never accumulate per-request pipelines)."""
        if self.closed:
            return
        self.handler.flush()
        while self._tokens:
            _CURRENT.reset(self._tokens.pop())
        if self._forward_handler is not None:
            self.handler.unsubscribe(self._forward)
        if self.processor is not None:
            self.processor.close()
        if self.parent is not None and self in self.parent.children:
            self.parent.children.remove(self)
        self.closed = True

    def __repr__(self) -> str:
        state = "closed" if self.closed else "open"
        return (f"Session({self.name!r}, tools="
                f"{[type(t).__name__ for t in self.tools]}, {state})")


# ---------------------------------------------------------------------------
# Current-session resolution (contextvars-scoped)
# ---------------------------------------------------------------------------

def active_session() -> Session | None:
    """The innermost active session, or ``None`` when no session is
    entered in this context (no implicit-root fallback)."""
    s = _CURRENT.get()
    return None if s is None or s.closed else s


def root_session() -> Session:
    """The process's implicit root session (created on first use).  It is
    *bare*: handler only, no processor."""
    global _root
    if _root is None:
        _root = Session(name="root", _bare=True)
    return _root


def current_session() -> Session:
    """The innermost active session, falling back to the implicit root."""
    return active_session() or root_session()


def current_handler() -> EventHandler:
    """The current session's handler — what ``pasta.region``/``start``/
    ``end`` and handler-less ``MemoryPool``s emit through."""
    return current_session().handler


def _attach_root(handler: EventHandler | None = None) -> EventHandler:
    """Back-end of the deprecated ``pasta.attach()``: replace the implicit
    root session with a bare one wrapping ``handler``."""
    global _root
    if _root is not None:
        _root.close()
    _root = Session(name="root", handler=handler, _bare=True)
    return _root.handler


def reset_state() -> None:
    """Drop the implicit root session and any leaked current-session
    binding (test isolation)."""
    global _root
    if _root is not None:
        _root.close()
    _root = None
    if _CURRENT.get() is not None:
        _CURRENT.set(None)
