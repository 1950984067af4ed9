"""Inefficiency-location utilities (paper §III-F2, Fig. 4).

Cross-level context: the knob-selected kernel (e.g. the most
memory-referenced one) is reported together with

  * its low-level ``op_name`` metadata, when the KERNEL_LAUNCH event
    carries one;
  * the high-level Python stack captured at the enclosing operator/region —
    the paper's CPython-frame side of the cross-layer stack.

KERNEL_LAUNCH events come from compiled-artifact capture, which the port
does not have yet; until then the report stays empty.

Knobs: ``MAX_MEM_REFERENCED_KERNEL`` (default) and ``MAX_CALLED_KERNEL``;
users add custom knobs by overriding :meth:`score`.

NOTE: this tool captures the live Python stack at operator/region dispatch,
so it should run against an *unbuffered* handler (the default).  Under ring
buffering the batch reaches the tool at flush time and the captured stack
would reflect the flush site, not the emitting frame — the template's
loop-over-rows ``on_batch`` fallback still dispatches correctly, but the
cross-layer context is weaker.
"""

from __future__ import annotations

import traceback

from ... import probe
from ..events import EventKind
from .base import PastaTool, register


@register("locator")
class LocatorTool(PastaTool):
    EVENTS = (EventKind.KERNEL_LAUNCH, EventKind.OPERATOR_START,
              EventKind.REGION_START)
    KNOBS = {"MAX_MEM_REFERENCED_KERNEL": True, "MAX_CALLED_KERNEL": False,
             "capture_python_stack": True}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self.best = None          # (score, event attrs snapshot)
        self._last_py_stack: list = []

    # custom knobs override this
    def score(self, ev) -> float:
        if self.knobs.get("MAX_CALLED_KERNEL"):
            return float(ev.attrs.get("count", 1))
        # default: most memory-referenced = bytes moved × invocations
        return float(ev.attrs.get("bytes", 0)) * float(ev.attrs.get("count", 1))

    def on_region_start(self, ev):
        self._capture_stack()

    def on_operator_start(self, ev):
        self._capture_stack()

    @probe.wrap("locator stack capture")
    def _capture_stack(self):
        if self.knobs.get("capture_python_stack"):
            self._last_py_stack = [
                f"{f.filename}:{f.lineno} {f.name}"
                for f in traceback.extract_stack()[:-3]
                if "/repro_torch/core/" not in f.filename.replace("\\", "/")
            ][-12:]

    def on_kernel_launch(self, ev):
        s = self.score(ev)
        if self.best is None or s > self.best[0]:
            self.best = (s, {
                "kernel": ev.name,
                "score": s,
                "count": ev.attrs.get("count", 1),
                "bytes": ev.attrs.get("bytes", 0),
                "hlo_op_name": ev.attrs.get("op_name", ""),
                "python_stack": list(self._last_py_stack),
                "region": list(ev.region),
            })

    def finalize(self) -> dict:
        return self.best[1] if self.best else {}
