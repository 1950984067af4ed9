"""Eager-execution instrumentation — the DL-framework-callback event source.

The GPU PASTA hooks PyTorch's ``reportMemoryUsage``/``RecordFunction``;
here the model code reports its operators and this module tracks *real
tensor lifetimes*: every tensor first seen at an operator boundary is
registered in the virtual :class:`~repro_torch.core.pool.MemoryPool`
(TENSOR_ALLOC), and a ``weakref`` finalizer frees its pool block when Python
drops the tensor (TENSOR_FREE) — lifetimes mirror the framework's actual
deallocations, which is what makes the ramp-up/peak/ramp-down timelines
(Fig. 14) and working sets (Table V) faithful.  The instrumented forward
runs under ``torch.inference_mode()``: no autograd graph holds inputs alive,
and views keep no reference to their base, so a tensor dies exactly when
its last Python reference goes.

Fine-grained mode additionally emits access-record TRACE_BUFFERs (addresses
sampled every ``stride`` bytes of each touched tensor) that the event
processor aggregates on device (Fig. 2b) or host (Fig. 2a baseline).

Model code calls :func:`op_hook` at operator boundaries; it is a no-op while
``torch.compile`` or FX traces the model, while a compiled step is captured
(:func:`capturing`) and when no instrumenter is installed, so the hot path
costs one global check.
"""

from __future__ import annotations

import contextlib
import time
import weakref

import numpy as np
import torch
import torch.fx

from .events import Event, EventKind
from .pool import MemoryPool

ACTIVE: "EagerInstrumenter | None" = None
_capture_depth = 0


class EagerInstrumenter:
    def __init__(self, handler=None, pool: MemoryPool | None = None,
                 fine: bool = False, stride: int = 512,
                 max_records_per_op: int = 65536,
                 pool_chunk: int = 32 * 1024 * 1024,
                 pool_align: int | None = None,
                 time_source=None, buffered: bool = False):
        from .pool import CHUNK_ALIGN
        if handler is None:
            from .session import current_handler
            handler = current_handler()
        self.handler = handler
        self.pool = pool or MemoryPool(
            handler, chunk_size=pool_chunk,
            align=pool_align if pool_align is not None else CHUNK_ALIGN)
        self.fine = fine
        self.stride = stride
        self.max_records = max_records_per_op
        self._tensors: dict = {}          # id(tensor) -> TensorHandle
        self.t0 = time.perf_counter()
        self.time_source = time_source
        #: batch operator/tensor/trace events through the handler's SoA ring
        #: (flushed at step boundaries and capacity); leave off for tools
        #: that need synchronous per-event context (e.g. LocatorTool's
        #: Python-stack capture at emit time).
        self.buffered = buffered
        self._prev_buffered = False

    # ------------------------------------------------------------ lifetime
    def tensor(self, arr, name: str = ""):
        key = id(arr)
        h = self._tensors.get(key)
        if h is not None:
            return h
        h = self.pool.alloc(arr.nbytes, name or f"t{key & 0xffff:x}")
        self._tensors[key] = h
        weakref.finalize(arr, self._on_free, key)
        return h

    def _on_free(self, key) -> None:
        h = self._tensors.pop(key, None)
        if h is not None and h.live:
            self.pool.free(h)

    # ------------------------------------------------------------------ op
    def op(self, name: str, inputs, outputs) -> None:
        handles = [self.tensor(a, f"{name}.in{i}")
                   for i, a in enumerate(inputs)]
        handles += [self.tensor(a, f"{name}.out{i}")
                    for i, a in enumerate(outputs)]
        tensors = [(h.addr, h.size) for h in handles]
        self.handler.operator_start(name, tensors=tensors, traced=self.fine)
        if self.fine:
            self._emit_trace(name, handles)
        self.handler.operator_end(name)

    def _emit_trace(self, name: str, handles) -> None:
        recs = []
        for h in handles:
            n = max(1, min(h.size // self.stride,
                           self.max_records // max(len(handles), 1)))
            recs.append(h.addr + (np.arange(n, dtype=np.int64)
                                  * self.stride) % h.size)
        addrs = np.concatenate(recs)
        # access-verified granularity = live TENSOR ranges (the paper's
        # object-to-access map at allocator granularity), NOT pool chunks —
        # this is exactly the tensor-vs-object distinction of §V-C1.
        objs = sorted(t.addr_range() for t in self.pool.live_tensors())
        self.handler.trace_buffer(
            addrs, name=name, kernel=name, objects=objs,
            object_sizes=[e - s for s, e in objs],
            time=(self.time_source() if self.time_source
                  else time.perf_counter() - self.t0))

    # ------------------------------------------------------------- control
    def __enter__(self):
        global ACTIVE
        self._prev = ACTIVE
        ACTIVE = self
        self._prev_buffered = self.handler.buffered
        if self.buffered:
            self.handler.set_buffered(True)
        return self

    def __exit__(self, *exc):
        global ACTIVE
        ACTIVE = self._prev
        if self.buffered:
            self.handler.flush()
            self.handler.set_buffered(self._prev_buffered)


def tracing() -> bool:
    """True while ``torch.compile`` (dynamo) or FX symbolic tracing runs the
    model (the tensors seen then are proxies, not real allocations), and
    while a compiled step is captured."""
    if _capture_depth:
        return True
    fx = torch.fx._symbolic_trace
    # newer torch splits symbolic tracing out of the (warning) catch-all
    fx_tracing = getattr(fx, "is_fx_symbolic_tracing", fx.is_fx_tracing)
    return torch.compiler.is_compiling() or fx_tracing()


@contextlib.contextmanager
def capturing():
    """The span of a compiled-step capture
    (:func:`repro_torch.core.capture.capture_step`).  Its operators belong
    to the compiled tier, which the reference traces and so never hooks:
    ``op_hook`` stays silent inside."""
    global _capture_depth
    _capture_depth += 1
    try:
        yield
    finally:
        _capture_depth -= 1


def op_hook(name: str, inputs, outputs) -> None:
    """Call at operator boundaries in model code. No-op under tracing."""
    inst = ACTIVE
    if inst is None or tracing():
        return
    inst.op(name, [a for a in inputs if hasattr(a, "nbytes")],
            [a for a in outputs if hasattr(a, "nbytes")])
