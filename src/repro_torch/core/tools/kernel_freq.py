"""Kernel-invocation frequency tool (paper §V-B1, Fig. 7).

Counts executed kernels from KERNEL_LAUNCH events (each carries its
invocation ``count``).  The paper's insight — a small subset of kernels dominates invocation
counts — falls out of ``finalize()['top']``.

Batch consumption is vectorized: per-batch invocation sums come from one
``np.bincount`` over the dictionary-encoded name column; the Counter is then
updated per *unique* name in first-appearance order, which reproduces the
scalar path's insertion order exactly (so ``most_common`` tie-breaks — and
therefore the report — are byte-identical under scalar and batched emission).
"""

from __future__ import annotations

import collections

import numpy as np

from ..events import EventKind
from .base import PastaTool, register


@register("kernel_freq")
class KernelFrequencyTool(PastaTool):
    EVENTS = (EventKind.KERNEL_LAUNCH,)

    def __init__(self, top_k: int = 20, **knobs):
        super().__init__(**knobs)
        self.top_k = top_k
        self.counts: collections.Counter = collections.Counter()
        self.by_label: dict = collections.defaultdict(collections.Counter)

    # ------------------------------------------------------------- scalar
    def on_kernel_launch(self, ev):
        n = int(ev.attrs.get("count", 1))
        # collapse ssa suffixes: fusion.123 -> fusion ; keep op_name flavor
        base = ev.name.split(".")[0]
        self.counts[base] += n
        self.counts[ev.name] += 0      # keep exact names discoverable
        label = ev.attrs.get("label", "")
        if label:
            self.by_label[label][base] += n

    # ------------------------------------------------------------ batched
    def on_batch(self, batch):
        idx = batch.rows(EventKind.KERNEL_LAUNCH)
        if idx.size == 0:
            return
        nid = batch.name_ids[idx]
        cnt = (batch.counts[idx] if batch.counts is not None
               else np.ones(idx.size, dtype=np.int64))
        sums = np.bincount(nid, weights=cnt,
                           minlength=len(batch.name_table)).astype(np.int64)
        uniq, first = np.unique(nid, return_index=True)
        for t in uniq[np.argsort(first)]:
            name = batch.name_table[t]
            self.counts[name.split(".")[0]] += int(sums[t])
            self.counts[name] += 0
        if batch.attrs is not None:
            for i in idx:
                a = batch.attrs[i]
                if a:
                    label = a.get("label", "")
                    if label:
                        base = batch.name_table[batch.name_ids[i]].split(
                            ".")[0]
                        self.by_label[label][base] += int(a.get("count", 1))

    def finalize(self) -> dict:
        total = sum(self.counts.values())
        top = self.counts.most_common(self.top_k)
        return {
            "total_invocations": total,
            "distinct_kernels": sum(1 for c in self.counts.values() if c > 0),
            "top": top,
            "by_label": {k: dict(v.most_common(self.top_k))
                         for k, v in self.by_label.items()},
        }
