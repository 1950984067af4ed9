"""Memory-characterization / working-set tool (paper §V-B2, Table V).

Working set of a workload = max over kernels of the bytes *actually accessed*
by that kernel.  Two sources, in fidelity order:

  1. TRACE_BUFFER events whose aggregated ``object_counts`` prove which
     tensors were touched (the paper's access-verified path — operands passed
     but never read are excluded);
  2. OPERATOR_START events carrying declared operand tensors (fallback when
     fine-grained tracing is off).

Footprint (pool bytes obtained from the driver) comes from ALLOC events, and
live-tensor accounting from TENSOR_ALLOC/FREE.
"""

from __future__ import annotations

import numpy as np

from ..events import EventKind, KIND_CODE
from .base import PastaTool, register

_KC_KERNEL = int(KIND_CODE[EventKind.KERNEL_LAUNCH])
_KC_ALLOC = int(KIND_CODE[EventKind.ALLOC])


@register("workingset")
class WorkingSetTool(PastaTool):
    EVENTS = (EventKind.TENSOR_ALLOC, EventKind.TENSOR_FREE, EventKind.ALLOC,
              EventKind.OPERATOR_START, EventKind.OPERATOR_END,
              EventKind.TRACE_BUFFER, EventKind.KERNEL_LAUNCH)
    KNOBS = {"MAX_MEM_REFERENCED_KERNEL": True, "MAX_CALLED_KERNEL": False}

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self.live: dict = {}           # tensor_id -> (addr, size, name)
        self.footprint = 0             # driver-level pool bytes
        self.peak_live = 0
        self.cur_live = 0
        self.kernel_ws: list = []      # per-kernel accessed bytes
        self.kernel_names: list = []
        self.kernel_count = 0
        self._max_ref = (None, -1)     # (kernel, bytes) — locator knob

    # ------------------------------------------------------------- memory
    def on_alloc(self, ev):
        self.footprint += ev.size

    def on_tensor_alloc(self, ev):
        self.live[ev.attrs["tensor_id"]] = (ev.addr, ev.size, ev.name)
        self.cur_live += ev.size
        self.peak_live = max(self.peak_live, self.cur_live)

    def on_tensor_free(self, ev):
        t = self.live.pop(ev.attrs["tensor_id"], None)
        if t is not None:
            self.cur_live -= t[1]

    # ------------------------------------------------------------ kernels
    def on_kernel_launch(self, ev):
        self.kernel_count += int(ev.attrs.get("count", 1))

    # ------------------------------------------------------------ batched
    def on_batch(self, batch):
        """Vectorized consumption of the hot columns (kernel invocation
        totals via the normalized ``counts`` column, pool footprint via a
        masked size sum); the attr-dependent memory/operator/trace rows are
        rare and fall back to ordered per-row dispatch (their peak/live
        accounting is order-sensitive)."""
        kinds = batch.kinds
        kmask = kinds == _KC_KERNEL
        if kmask.any():
            if batch.counts is not None:
                self.kernel_count += int(batch.counts[kmask].sum())
            else:
                self.kernel_count += int(kmask.sum())
        amask = kinds == _KC_ALLOC
        if amask.any():
            self.footprint += int(batch.sizes[amask].sum())
        for ev in batch.iter_events((EventKind.TENSOR_ALLOC,
                                     EventKind.TENSOR_FREE,
                                     EventKind.OPERATOR_START,
                                     EventKind.TRACE_BUFFER)):
            self.on_event(ev)

    def on_operator_start(self, ev):
        tensors = ev.attrs.get("tensors")
        if tensors is None or ev.attrs.get("traced"):
            return          # fine-grained trace supersedes declared operands
        ws = sum(sz for (_a, sz) in tensors)
        self._record(ev.name, ws)

    def on_trace_buffer(self, ev):
        counts = ev.attrs.get("object_counts")
        obj_sizes = ev.attrs.get("object_sizes")
        if counts is None or obj_sizes is None:
            return
        touched = int(np.sum(np.where(np.asarray(counts) > 0,
                                      np.asarray(obj_sizes), 0)))
        self._record(ev.attrs.get("kernel", ev.name), touched)

    def _record(self, name: str, ws: int) -> None:
        self.kernel_ws.append(ws)
        self.kernel_names.append(name)
        if self.knobs.get("MAX_MEM_REFERENCED_KERNEL") and ws > self._max_ref[1]:
            self._max_ref = (name, ws)

    # ------------------------------------------------------------ report
    def finalize(self) -> dict:
        ws = np.asarray(self.kernel_ws, dtype=np.float64)
        if ws.size == 0:
            ws = np.zeros(1)
        mb = 1024.0 ** 2
        return {
            "kernel_count": self.kernel_count or len(self.kernel_ws),
            "operator_count": len(self.kernel_ws),
            "footprint_mb": self.footprint / mb,
            "peak_live_mb": self.peak_live / mb,
            "working_set_mb": float(ws.max()) / mb,
            "min_ws_mb": float(ws.min()) / mb,
            "avg_ws_mb": float(ws.mean()) / mb,
            "median_ws_mb": float(np.median(ws)) / mb,
            "p90_ws_mb": float(np.percentile(ws, 90)) / mb,
            "max_mem_referenced_kernel": self._max_ref[0],
        }
