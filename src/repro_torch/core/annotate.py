"""Range-specific analysis support (paper §III-F1).

Mirrors the paper's minimal, non-intrusive annotation API::

    import repro_torch.core as pasta

    pasta.start("linear1")
    y = linear1(x)
    pasta.end("linear1")

    with pasta.region("backward"):
        ...

The region stack is recorded into every event emitted while a region is
open, enabling layer-level / forward-vs-backward / custom-range breakdowns.
"""

from __future__ import annotations

import contextlib
import os
import threading

_state = threading.local()


def _stack() -> list:
    if not hasattr(_state, "stack"):
        _state.stack = []
    return _state.stack


def current_region() -> tuple:
    """Snapshot of the open annotation regions, outermost first."""
    return tuple(_stack())


def start(name: str) -> None:
    """Open an analysis region (paper Listing 1, ``pasta.start``).  The
    region event routes to the innermost active :class:`~repro_torch.core.Session`
    (falling back to the implicit root session)."""
    from .session import current_handler
    from .events import Event, EventKind

    _stack().append(name)
    current_handler().emit(Event(EventKind.REGION_START, name=name,
                                 region=current_region()))


def end(name: str | None = None) -> None:
    """Close the innermost analysis region (paper Listing 1, ``pasta.end``)."""
    from .session import current_handler
    from .events import Event, EventKind

    stack = _stack()
    if not stack:
        raise RuntimeError("pasta.end() without matching pasta.start()")
    top = stack[-1]
    if name is not None and name != top:
        raise RuntimeError(f"pasta.end({name!r}) does not match open region {top!r}")
    stack.pop()
    current_handler().emit(Event(EventKind.REGION_END, name=top,
                                 region=current_region()))


@contextlib.contextmanager
def region(name: str):
    """Context-manager convenience over start/end."""
    start(name)
    try:
        yield
    finally:
        end(name)


class GridIdFilter:
    """Restrict analysis to a subset of kernel launches.

    Reads ``START_GRID_ID`` / ``END_GRID_ID`` (inclusive range), matching the
    paper's environment-variable interface for standard GPU applications.
    """

    def __init__(self, start_id: int | None = None, end_id: int | None = None):
        env_s = os.environ.get("START_GRID_ID")
        env_e = os.environ.get("END_GRID_ID")
        self.start_id = start_id if start_id is not None else (
            int(env_s) if env_s else 0)
        self.end_id = end_id if end_id is not None else (
            int(env_e) if env_e else 2 ** 62)

    def __call__(self, grid_id: int) -> bool:
        return self.start_id <= grid_id <= self.end_id
