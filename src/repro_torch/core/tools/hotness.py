"""Time-series hotness tool (paper §V-C2, Fig. 13).

Accumulates access hotness in (time-bin × 2 MiB virtual-memory block) space.
The heavy reduction happens on device (event processor, Fig. 2b model); the
tool only sums the small per-buffer aggregates and classifies blocks:

  * long-lived hot blocks (accessed across most of the run — e.g. params):
    pin / prefetch candidates;
  * bursty blocks (hot in narrow windows — e.g. activations, KV blocks):
    proactive-eviction candidates.
"""

from __future__ import annotations

import numpy as np

from ..events import EventKind
from .base import PastaTool, register


@register("hotness")
class HotnessTool(PastaTool):
    EVENTS = (EventKind.TRACE_BUFFER,)

    def __init__(self, n_tbins: int = 64, n_blocks: int = 1024,
                 hot_frac: float = 0.5, **knobs):
        super().__init__(**knobs)
        self.n_tbins = n_tbins
        self.n_blocks = n_blocks
        self.hot_frac = hot_frac
        self.hot = np.zeros((n_tbins, n_blocks), dtype=np.int64)

    def on_trace_buffer(self, ev):
        h = ev.attrs.get("hotness_map")
        if h is None:
            return
        h = np.asarray(h)
        tb, nb = h.shape
        self.hot[:tb, :nb] += h

    def on_batch(self, batch):
        """Sum the per-buffer device aggregates straight off the attrs side
        table — no scalar Event materialization on the batch path."""
        for i in batch.rows(EventKind.TRACE_BUFFER):
            a = batch.attrs_at(int(i))
            h = None if a is None else a.get("hotness_map")
            if h is None:
                continue
            h = np.asarray(h)
            tb, nb = h.shape
            self.hot[:tb, :nb] += h

    def classify(self, hot_frac: float = 0.5):
        """Split blocks into persistent-hot vs bursty vs cold."""
        touched = self.hot > 0
        presence = touched.mean(axis=0)            # fraction of time bins hot
        total = self.hot.sum(axis=0)
        persistent = np.where((presence >= hot_frac) & (total > 0))[0]
        bursty = np.where((presence < hot_frac) & (total > 0))[0]
        return {"persistent_blocks": persistent.tolist(),
                "bursty_blocks": bursty.tolist(),
                "cold_blocks": int((total == 0).sum())}

    def finalize(self) -> dict:
        out = self.classify(self.hot_frac)
        out["total_accesses"] = int(self.hot.sum())
        out["hot_matrix_shape"] = list(self.hot.shape)
        out["peak_bin"] = (int(np.argmax(self.hot.max(axis=1)))
                           if self.hot.size else -1)
        return out
