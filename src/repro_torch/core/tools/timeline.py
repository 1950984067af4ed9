"""Memory-timeline tool (paper §V-D, Figs. 14–15).

Tracks live bytes over event order, per device, with region context — the
ramp-up / peak / ramp-down picture of a training iteration, and the per-device
asymmetries under DP/TP/PP that the paper's multi-GPU case study shows.

Batch consumption is vectorized: per-device live-byte series come from one
``np.cumsum`` over the signed size deltas (alloc +, free −) instead of a
Python callback per event; the resulting series/peaks are identical to the
scalar path because cumsum preserves row order.
"""

from __future__ import annotations

import collections

import numpy as np

from ..events import EventKind, KIND_CODE
from .base import PastaTool, register

_KC_TA = int(KIND_CODE[EventKind.TENSOR_ALLOC])
_KC_TF = int(KIND_CODE[EventKind.TENSOR_FREE])


@register("timeline")
class MemoryTimelineTool(PastaTool):
    EVENTS = (EventKind.TENSOR_ALLOC, EventKind.TENSOR_FREE,
              EventKind.ALLOC, EventKind.FREE, EventKind.STEP_START,
              EventKind.STEP_END)

    def __init__(self, **knobs):
        super().__init__(**knobs)
        self.live: dict = collections.defaultdict(int)      # device -> bytes
        self.series: dict = collections.defaultdict(list)   # device -> [(seq, bytes, region)]
        self.alloc_events: dict = collections.defaultdict(int)
        self.free_events: dict = collections.defaultdict(int)
        self.peak: dict = collections.defaultdict(int)

    # ------------------------------------------------------------- scalar
    def _mark(self, dev, seq, region):
        self.series[dev].append((seq, self.live[dev], "/".join(region)))
        self.peak[dev] = max(self.peak[dev], self.live[dev])

    def on_tensor_alloc(self, ev):
        self.live[ev.device] += ev.size
        self.alloc_events[ev.device] += 1
        self._mark(ev.device, ev.seq, ev.region)

    def on_tensor_free(self, ev):
        self.live[ev.device] -= ev.size
        self.free_events[ev.device] += 1
        self._mark(ev.device, ev.seq, ev.region)

    # ------------------------------------------------------------ batched
    def on_batch(self, batch):
        kinds = batch.kinds
        sel = (kinds == _KC_TA) | (kinds == _KC_TF)
        idx = np.nonzero(sel)[0]
        if idx.size == 0:
            return
        deltas = np.where(kinds[idx] == _KC_TA, batch.sizes[idx],
                          -batch.sizes[idx])
        if isinstance(batch.devices, tuple):
            groups = [(batch.devices, np.arange(idx.size))]
        else:
            by_dev: dict = {}
            for j, i in enumerate(idx):
                by_dev.setdefault(batch.devices[i], []).append(j)
            groups = [(d, np.asarray(js)) for d, js in by_dev.items()]
        for dev, js in groups:
            rows = idx[js]
            lives = self.live[dev] + np.cumsum(deltas[js])
            self.live[dev] = int(lives[-1])
            n_alloc = int((kinds[rows] == _KC_TA).sum())
            self.alloc_events[dev] += n_alloc
            self.free_events[dev] += rows.size - n_alloc
            if isinstance(batch.regions, tuple):
                rg = "/".join(batch.regions)
                regions = [rg] * rows.size
            else:
                regions = ["/".join(batch.regions[i]) for i in rows]
            self.series[dev].extend(
                zip(batch.seqs[rows].tolist(), lives.tolist(), regions))
            self.peak[dev] = max(self.peak[dev], int(lives.max()))

    def finalize(self) -> dict:
        devs = sorted(self.series)
        return {
            "devices": [str(d) for d in devs],
            "peak_bytes": {str(d): self.peak[d] for d in devs},
            "alloc_events": {str(d): self.alloc_events[d] for d in devs},
            "free_events": {str(d): self.free_events[d] for d in devs},
            "series": {str(d): self.series[d] for d in devs},
        }
