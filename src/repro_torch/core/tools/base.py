"""PASTA tool-collection template + string-keyed tool registry.

A tool is written by subclassing :class:`PastaTool` and overriding only the
``on_<event-kind>`` methods it cares about — the paper's "simply overriding
functions in the PASTA tool collection template".  ``EVENTS`` narrows which
kinds are routed to the tool at all (low-overhead: uninteresting events never
reach user code).  ``KNOBS`` is the paper's predefined-knob mechanism for the
inefficiency-location utilities (e.g. ``MAX_MEM_REFERENCED_KERNEL``).

Dispatch is columnar: the processor hands each tool a whole
:class:`~repro_torch.core.events.EventBatch` through :meth:`PastaTool.on_batch`.
The default implementation is a loop-over-rows fallback that materializes
scalar Events and dispatches to the ``on_<kind>`` hooks, so existing
subclasses keep working unchanged; hot tools override ``on_batch`` with true
vectorized consumption (``np.bincount`` / ``np.add.at`` over the columns).

Tools register under a string key with the :func:`register` decorator::

    @register("launch_bytes")
    class LaunchBytesTool(PastaTool): ...

and are then selectable by spec string anywhere a tool list is accepted
(``pasta.Session(tools="workingset,hotness")``, the ``PASTA_TOOL``
environment variable).  A spec entry
may carry constructor knobs: ``"name:knob=val,knob2=val2"`` — values parse
as int/float/bool where possible, else string.
"""

from __future__ import annotations

import os

from ..events import Event, EventBatch, EventKind


class PastaTool:
    #: event kinds of interest; ("*",) means all
    EVENTS: tuple = ("*",)
    #: named knobs (environment-overridable selective controls)
    KNOBS: dict = {}

    def __init__(self, **knobs):
        self.knobs = dict(self.KNOBS)
        self.knobs.update(knobs)
        self.processor = None       # set by EventProcessor.add_tool

    # ------------------------------------------------------------- routing
    def wants(self, kind: EventKind) -> bool:
        return "*" in self.EVENTS or kind in self.EVENTS \
            or kind.value in self.EVENTS

    def on_batch(self, batch: EventBatch) -> None:
        """Consume a columnar batch.  Default: materialize matching rows and
        dispatch them to the scalar ``on_<kind>`` hooks (compatibility
        fallback).  Vectorized tools override this — but must keep their
        scalar hooks equivalent, because one-row (scalar-emit) dispatch
        takes the ``on_<kind>`` fast path; the golden batch-vs-scalar tests
        pin both paths to identical reports."""
        for ev in batch.iter_events(self.EVENTS):
            self.on_event(ev)

    def on_event(self, ev: Event) -> None:
        fn = getattr(self, f"on_{ev.kind.value}", None)
        if fn is not None:
            fn(ev)

    # ------------------------------------------------------------ template
    def finalize(self) -> dict:
        """Produce the tool's report. Override."""
        return {}

    # default no-op hooks (subset shown; any on_<kind> name is dispatched)
    def on_kernel_launch(self, ev: Event) -> None: ...
    def on_tensor_alloc(self, ev: Event) -> None: ...
    def on_tensor_free(self, ev: Event) -> None: ...
    def on_operator_start(self, ev: Event) -> None: ...
    def on_operator_end(self, ev: Event) -> None: ...
    def on_trace_buffer(self, ev: Event) -> None: ...


# ---------------------------------------------------------------------------
# String-keyed tool registry
# ---------------------------------------------------------------------------

#: registry name -> PastaTool subclass (populated by @register)
TOOL_REGISTRY: dict = {}


def register(name: str):
    """Class decorator: make a tool selectable by ``name`` in tool specs.

    The name becomes the tool's key in :meth:`repro_torch.core.Session.reports`
    (exposed on the class as ``REGISTRY_NAME``).  Re-registering the same
    class under the same name is a no-op; stealing a taken name raises.
    """
    def deco(cls):
        prev = TOOL_REGISTRY.get(name)
        if prev is not None and prev is not cls:
            raise ValueError(
                f"tool name {name!r} is already registered to "
                f"{prev.__name__}")
        TOOL_REGISTRY[name] = cls
        cls.REGISTRY_NAME = name
        return cls
    return deco


def _parse_knob_value(raw: str):
    low = raw.lower()
    if low in ("true", "yes", "on"):
        return True
    if low in ("false", "no", "off"):
        return False
    for cast in (int, float):
        try:
            return cast(raw)
        except ValueError:
            pass
    return raw


def parse_tool_spec(spec: str) -> list:
    """Parse ``"name[:knob=val[,knob=val...]][,name...]"`` into
    ``[(name, {knob: value}), ...]``.

    A ``:`` after a tool name opens its knob list; subsequent ``key=val``
    comma segments bind to that tool until a segment without ``=`` starts
    the next tool.  Values parse as bool/int/float where possible.
    """
    entries: list = []
    open_knobs = False
    for seg in spec.split(","):
        seg = seg.strip()
        if not seg:
            continue
        if ":" in seg:
            name, first = seg.split(":", 1)
            name = name.strip()
            if not name:
                raise ValueError(f"empty tool name in spec segment {seg!r}")
            knobs: dict = {}
            entries.append((name, knobs))
            open_knobs = True
            if first.strip():
                k, eq, v = first.partition("=")
                if not eq:
                    raise ValueError(
                        f"expected knob=value after {name!r}:, got {first!r}")
                knobs[k.strip()] = _parse_knob_value(v.strip())
        elif "=" in seg:
            if not open_knobs:
                raise ValueError(
                    f"knob {seg!r} without a preceding 'tool:' entry")
            k, _eq, v = seg.partition("=")
            entries[-1][1][k.strip()] = _parse_knob_value(v.strip())
        else:
            entries.append((seg, {}))
            open_knobs = False
    return entries


def resolve_tools(spec=None, overrides: dict | None = None) -> list:
    """Instantiate tools from a spec.

    ``spec`` may be ``None`` (falls back to the ``PASTA_TOOL`` environment
    variable, the paper's CLI interface), a spec string (see
    :func:`parse_tool_spec`), or a list mixing :class:`PastaTool` instances,
    classes, registry names, and ``(name, kwargs)`` pairs.  ``overrides``
    optionally maps registry names to extra constructor kwargs.
    """
    if spec is None:
        spec = os.environ.get("PASTA_TOOL", "")
    if isinstance(spec, PastaTool):
        return [spec]
    overrides = overrides or {}

    def build(name: str, knobs: dict):
        if name not in TOOL_REGISTRY:
            raise KeyError(f"unknown PASTA tool {name!r}; "
                           f"known: {sorted(TOOL_REGISTRY)}")
        kw = dict(knobs)
        kw.update(overrides.get(name, {}))
        return TOOL_REGISTRY[name](**kw)

    if isinstance(spec, str):
        return [build(n, k) for n, k in parse_tool_spec(spec)]
    out = []
    for item in spec:
        if isinstance(item, PastaTool):
            out.append(item)
        elif isinstance(item, type) and issubclass(item, PastaTool):
            out.append(item())
        elif isinstance(item, str):
            out.extend(build(n, k) for n, k in parse_tool_spec(item))
        elif isinstance(item, tuple) and len(item) == 2:
            out.append(build(item[0], dict(item[1])))
        else:
            raise TypeError(f"cannot resolve tool spec item {item!r}")
    return out
