"""PASTA event processor (paper §III-B) — normalize, preprocess, dispatch.

Two trace-analysis execution models, mirroring the paper's Fig. 2:

  * **host-resident** (Fig. 2a, the conventional baseline): raw access
    records are copied to the host and folded one-by-one by a single Python
    thread — the model used by Compute-Sanitizer-MemoryTracker / NVBit
    MemTrace style tools.  Kept as the overhead-comparison baseline.
  * **device-resident** (Fig. 2b, PASTA's contribution): records are reduced
    on the GPU by the hand-written CUDA kernels in
    :mod:`repro_torch.kernels` (their plain PyTorch versions when the caller
    asks for ``device="cpu"``), and only O(#objects) aggregates come back.
    When both per-object counts and the hotness map are requested, the fused
    ``trace_aggregate`` kernel produces both in a single stream over the
    trace (one device round-trip).  Records are built on the host, so the
    measured ``analysis_s`` includes the copy to the device and the copy of
    the aggregates back, which synchronises.

The coarse-grained tier is columnar end-to-end: the processor subscribes a
*batch* callback, ``normalize_batch`` fixes cross-backend inconsistencies
with masked vector ops (the paper's example: deallocation sizes reported as
negative deltas), and tools consume whole batches through their ``on_batch``
template method.
"""

from __future__ import annotations

import bisect
import time

import numpy as np

from .. import probe
from .events import (Event, EventBatch, EventKind, KIND_CODE, _SIGNED_CODES,
                     _SIGNED_SIZE_KINDS)
from .handler import EventHandler

_KC_KERNEL = int(KIND_CODE[EventKind.KERNEL_LAUNCH])
_KC_TRACE = int(KIND_CODE[EventKind.TRACE_BUFFER])
_TOOL_SPANS: dict = {}     # tool class -> its probe span's name


def _tool_span(tool) -> str:
    """``tool <registry name>`` (the class name for an unregistered
    tool): the probe's span around each call into ``tool``."""
    name = _TOOL_SPANS.get(type(tool))
    if name is None:
        key = getattr(tool, "REGISTRY_NAME", type(tool).__name__)
        name = _TOOL_SPANS[type(tool)] = f"tool {key}"
    return name


class EventProcessor:
    def __init__(self, handler: EventHandler | None = None, tools=(),
                 device_analysis: bool = True, hotness: dict | None = None,
                 device="cuda"):
        """``hotness``: optional {"base","n_blocks","n_tbins","t_max"} — when
        set, trace buffers are additionally reduced to time×block hotness
        maps (Fig. 13) alongside per-object counts.  ``device``: the torch
        device the device-resident reductions run on."""
        if handler is None:
            from .session import current_handler
            handler = current_handler()
        self.handler = handler
        self.tools = list(tools)
        self.device_analysis = device_analysis
        self.hotness = hotness
        self.device = device
        self.closed = False
        self.handler.subscribe_batch(self._on_batch)
        for t in self.tools:
            t.processor = self

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        """Detach from the handler (undo the ``__init__`` subscription).
        Without this, constructing two processors against the process-global
        handler double-dispatches every event."""
        if not self.closed:
            self.handler.unsubscribe(self._on_batch)
            self.closed = True

    def __enter__(self) -> "EventProcessor":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ------------------------------------------------------------ normalize
    @staticmethod
    def normalize(ev: Event) -> Event:
        """Scalar normalization (compatibility path for direct callers)."""
        if ev.normalized:
            return ev
        # sign conventions: some runtimes report frees as negative deltas
        if ev.kind in _SIGNED_SIZE_KINDS and ev.size < 0:
            ev.size = -ev.size
        # kernel-launch metadata extraction (grid config normalization)
        if ev.kind is EventKind.KERNEL_LAUNCH and "count" not in ev.attrs:
            ev.attrs["count"] = 1
        if ev.kind is EventKind.MEMCPY:
            ev.attrs.setdefault("direction", "d2d")
        ev.normalized = True
        return ev

    @staticmethod
    def normalize_batch(batch: EventBatch) -> EventBatch:
        """Vectorized normalization over a columnar batch: masked negation
        for the signed-size kinds and a materialized ``counts`` column for
        kernel launches.  Fully columnar — one ``attr_column`` gather
        instead of per-row attrs loops (this sits on the hot dispatch path
        for every batch that carries attrs); default attrs (``count``,
        memcpy ``direction``) are supplied by :meth:`EventBatch.event` at
        scalar materialization rather than written back per row."""
        if batch.normalized:
            return batch
        kinds = batch.kinds
        signed = np.isin(kinds, _SIGNED_CODES)
        if signed.any():
            batch.sizes = np.where(signed & (batch.sizes < 0),
                                   -batch.sizes, batch.sizes)
        counts = np.ones(len(batch), dtype=np.int64)
        kidx = np.nonzero(kinds == _KC_KERNEL)[0]
        if kidx.size and batch.attrs is not None:
            counts[kidx] = batch.attr_column("count", 1, rows=kidx,
                                             dtype=np.int64)
        batch.counts = counts
        batch.normalized = True
        return batch

    # -------------------------------------------------------------- dispatch
    @probe.wrap("processor")
    def _on_batch(self, batch: EventBatch) -> None:
        if len(batch) == 1:
            # scalar fast path: one-row batches (the ``emit`` compat shim)
            # skip the vectorized machinery and use the per-event hooks —
            # the golden equivalence tests pin both paths to the same output
            ev = batch.event(0)
            self.normalize(ev)
            batch.sizes[0] = ev.size
            # keep the columnar view consistent with normalize_batch: batch
            # consumers must see the counts column on normalized batches
            batch.counts = np.asarray([int(ev.attrs.get("count", 1))],
                                      dtype=np.int64)
            batch.normalized = True
            if ev.kind is EventKind.TRACE_BUFFER:
                self._preprocess_trace(ev)
            for tool in self.tools:
                if tool.wants(ev.kind):
                    with probe.span(_tool_span(tool)):
                        tool.on_event(ev)
            return
        self.normalize_batch(batch)
        tmask = batch.kinds == _KC_TRACE
        if tmask.any():
            for i in np.nonzero(tmask)[0]:
                self._preprocess_trace(batch.event(int(i)))
        if not self.tools:
            return
        present = batch.present_kinds()
        for tool in self.tools:
            if any(tool.wants(k) for k in present):
                with probe.span(_tool_span(tool)):
                    tool.on_batch(batch)

    def _on_event(self, ev: Event) -> None:
        """Scalar compatibility shim — wraps a one-row batch."""
        self._on_batch(EventBatch.from_events((ev,)))

    def add_tool(self, tool) -> None:
        tool.processor = self
        self.tools.append(tool)

    def finalize(self) -> dict:
        self.handler.flush()
        return {type(t).__name__: t.finalize() for t in self.tools}

    # ------------------------------------------------------- trace analysis
    @probe.wrap("trace reduction")
    def _preprocess_trace(self, ev: Event) -> None:
        """Aggregate a raw access-record buffer; attach the aggregate to the
        event so tools see small, structured data (never raw records)."""
        records = ev.attrs.get("records")
        objects = ev.attrs.get("objects")
        if records is None:
            return
        mode = "device" if self.device_analysis else "host"
        elapsed = 0.0
        hp = self.hotness
        fusable = False
        if objects is not None and hp is not None and mode == "device":
            from ..kernels import ops as kops
            fusable = kops.can_fuse(len(objects), hp["n_blocks"],
                                    hp["n_tbins"], device=self.device)
        if fusable:
            # fused path: per-object counts AND the hotness map in one
            # device round-trip over the shared trace stream
            t = ev.attrs.get("time", 0.0)
            times = np.full(len(records), t)
            counts, hot, elapsed = analyze_trace_fused(
                records, times, objects, hp["base"], hp["n_blocks"],
                hp["n_tbins"], hp["t_max"],
                block_shift=hp.get("block_shift"), device=self.device)
            ev.attrs["object_counts"] = counts
            ev.attrs["hotness_map"] = hot
        else:
            if objects is not None:
                counts, elapsed = analyze_access_trace(records, objects,
                                                       mode=mode,
                                                       device=self.device)
                ev.attrs["object_counts"] = counts
            if hp is not None:
                t = ev.attrs.get("time", 0.0)
                times = np.full(len(records), t)
                hot, el2 = analyze_hotness_trace(
                    records, times, hp["base"], hp["n_blocks"],
                    hp["n_tbins"], hp["t_max"], mode=mode,
                    block_shift=hp.get("block_shift"), device=self.device)
                ev.attrs["hotness_map"] = hot
                elapsed += el2
        ev.attrs["analysis_s"] = elapsed
        ev.attrs["analysis_mode"] = mode
        ev.attrs.pop("records", None)   # aggregates only past this point


# ---------------------------------------------------------------------------
# Trace-analysis execution models
# ---------------------------------------------------------------------------

def analyze_access_trace(addrs, objects, mode: str = "device",
                         device="cuda"):
    """Fold raw access records into per-object access counts.

    ``addrs``: int64 array of accessed byte addresses (one record per access).
    ``objects``: list of (start, end) half-open address ranges, sorted.
    Returns ``(counts ndarray[len(objects)], elapsed_seconds)``.
    """
    starts = np.asarray([o[0] for o in objects], dtype=np.int64)
    ends = np.asarray([o[1] for o in objects], dtype=np.int64)
    t0 = time.perf_counter()
    if mode == "host":
        counts = _host_analyze(addrs, starts, ends)
    elif mode == "device":
        from ..kernels import ops as kops
        counts = kops.object_histogram(np.asarray(addrs), starts, ends,
                                       device=device)
    else:
        raise ValueError(f"unknown analysis mode {mode!r}")
    return counts, time.perf_counter() - t0


def _host_analyze(addrs, starts, ends) -> np.ndarray:
    """Fig. 2a baseline: one host thread, one record at a time."""
    counts = np.zeros(len(starts), dtype=np.int64)
    starts_l = starts.tolist()
    ends_l = ends.tolist()
    for a in np.asarray(addrs).tolist():
        i = bisect.bisect_right(starts_l, a) - 1
        if i >= 0 and a < ends_l[i]:
            counts[i] += 1
    return counts


def analyze_hotness_trace(addrs, times, base_addr: int, n_blocks: int,
                          n_tbins: int, t_max: float, mode: str = "device",
                          block_shift: int | None = None, device="cuda"):
    """Fold (addr, time) records into a [time_bin, block] hotness map
    (default block = 2 MiB, the UVM page-group granularity)."""
    from ..kernels import ops as kops
    if block_shift is None:
        block_shift = kops.BLOCK_SHIFT
    t0 = time.perf_counter()
    if mode == "host":
        hot = np.zeros((n_tbins, n_blocks), dtype=np.int64)
        block = 512 << block_shift
        for a, t in zip(np.asarray(addrs).tolist(), np.asarray(times).tolist()):
            b = (a - base_addr) // block
            tb = min(int(t / t_max * n_tbins), n_tbins - 1)
            if 0 <= b < n_blocks:
                hot[tb, b] += 1
    else:
        hot = kops.hotness_histogram(
            np.asarray(addrs), np.asarray(times), base_addr, n_blocks,
            n_tbins, t_max, block_shift=block_shift, device=device)
    return hot, time.perf_counter() - t0


def analyze_trace_fused(addrs, times, objects, base_addr: int, n_blocks: int,
                        n_tbins: int, t_max: float,
                        block_shift: int | None = None, device="cuda"):
    """Fused device-resident reduction: per-object counts and the
    [time_bin, block] hotness map from ONE pass over the trace (the
    ``trace_aggregate`` kernel — shared addr tiles, two accumulators).
    Returns ``(counts, hotness, elapsed_seconds)``."""
    from ..kernels import ops as kops
    if block_shift is None:
        block_shift = kops.BLOCK_SHIFT
    starts = np.asarray([o[0] for o in objects], dtype=np.int64)
    ends = np.asarray([o[1] for o in objects], dtype=np.int64)
    t0 = time.perf_counter()
    counts, hot = kops.trace_aggregate(
        np.asarray(addrs), np.asarray(times), starts, ends, base_addr,
        n_blocks, n_tbins, t_max, block_shift=block_shift, device=device)
    return counts, hot, time.perf_counter() - t0
