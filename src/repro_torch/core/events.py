"""PASTA event vocabulary — the paper's Table II.

The paper's event taxonomy has three tiers:

  * coarse-grained host-called API events (kernel launch, memcpy, sync, ...)
  * fine-grained device-side operations (per-thread memory accesses, ...)
  * high-level DL framework events (operator begin/end, tensor alloc, ...)

The fine-grained tier is carried by *trace buffers* (structured arrays of
access records that are aggregated on the GPU — see
``repro_torch.kernels``) rather than one Python object per access.

The coarse-grained tier itself is columnar: the canonical in-flight
representation is :class:`EventBatch`, a structure-of-arrays batch (parallel
numpy columns for kind/step/time/size/addr/seq, dictionary-encoded names, and
a side table for attrs/device/region).  :class:`Event` remains the scalar
view — one row — kept for authoring convenience and API compatibility; the
handler wraps scalar emits into one-row batches.
"""

from __future__ import annotations

import dataclasses
import enum
import time as _time
from typing import Any, Iterable, Iterator

import numpy as np


class EventKind(enum.Enum):
    # --- low-level, coarse-grained (host-called API analogues) -------------
    KERNEL_LAUNCH = "kernel_launch"
    MEMCPY = "memcpy"
    MEMSET = "memset"
    SYNC = "sync"
    ALLOC = "alloc"                        # device memory object (pool chunk)
    FREE = "free"
    COLLECTIVE = "collective"              # all-reduce / all-gather / ...
    COMPILE = "compile"
    # --- low-level, fine-grained (device-side) -----------------------------
    TRACE_BUFFER = "trace_buffer"          # handle to a device access-record
                                           # buffer; aggregated by processor
    # --- high-level DL framework events -------------------------------------
    OPERATOR_START = "operator_start"
    OPERATOR_END = "operator_end"
    TENSOR_ALLOC = "tensor_alloc"
    TENSOR_FREE = "tensor_free"
    REGION_START = "region_start"          # pasta.start()/pasta.end()
    REGION_END = "region_end"
    STEP_START = "step_start"
    STEP_END = "step_end"
    FINDING = "finding"                    # static-analysis lint finding


#: stable integer codes for the columnar ``kind`` column
KIND_LIST = list(EventKind)
KIND_CODE = {k: np.int16(i) for i, k in enumerate(KIND_LIST)}

#: kinds whose ``size`` field is known to arrive with inconsistent sign
#: conventions across backends (the paper's normalization example: some
#: runtimes report deallocation sizes as negative deltas).
_SIGNED_SIZE_KINDS = (EventKind.FREE, EventKind.TENSOR_FREE)
_SIGNED_CODES = np.asarray([int(KIND_CODE[k]) for k in _SIGNED_SIZE_KINDS],
                           dtype=np.int16)


class _SeqCounter:
    """Monotone event sequence counter with O(1) bulk reservation for
    columnar producers (``take(n)`` hands out a contiguous id range)."""

    __slots__ = ("n",)

    def __init__(self, start: int = 0):
        self.n = start

    def __next__(self) -> int:
        v = self.n
        self.n += 1
        return v

    def take(self, count: int) -> np.ndarray:
        v = self.n
        self.n += count
        return np.arange(v, v + count, dtype=np.int64)


_seq = _SeqCounter()


def reset_seq() -> None:
    """Reset the global sequence counter (test isolation)."""
    global _seq
    _seq = _SeqCounter()


def take_seqs(count: int) -> np.ndarray:
    """Reserve ``count`` contiguous sequence numbers (columnar emit path)."""
    return _seq.take(count)


def next_seq() -> int:
    """Reserve one sequence number (for producers that need the seq before
    emitting, e.g. to stamp their own bookkeeping first)."""
    return next(_seq)


def _intern(name: str, table: list, index: dict) -> int:
    """Dictionary-encode ``name`` against table/index (shared by every
    batch/ring producer so the encoded column stays consistent)."""
    nid = index.get(name)
    if nid is None:
        nid = index[name] = len(table)
        table.append(name)
    return nid


@dataclasses.dataclass
class Event:
    """A single normalized-or-raw PASTA event (scalar row view)."""

    kind: EventKind
    name: str = ""
    step: int = -1
    time: float = dataclasses.field(default_factory=_time.perf_counter)
    device: tuple = ()            # mesh coordinates, e.g. (pod, data, model)
    size: int = 0                 # bytes (sign-normalized by the processor)
    addr: int = 0                 # virtual address (pool-modelled)
    region: tuple = ()            # annotation stack snapshot
    attrs: dict = dataclasses.field(default_factory=dict)
    seq: int = dataclasses.field(default_factory=lambda: next(_seq))
    normalized: bool = False

    def with_attrs(self, **kw: Any) -> "Event":
        self.attrs.update(kw)
        return self


def codes_for(kinds: Iterable) -> np.ndarray | None:
    """Map a tool-style EVENTS tuple (EventKinds, value strings, or "*") to
    an int16 code array; ``None`` means "all kinds"."""
    out = []
    for k in kinds:
        if k == "*":
            return None
        out.append(int(KIND_CODE[k if isinstance(k, EventKind)
                                 else EventKind(k)]))
    return np.asarray(out, dtype=np.int16)


class EventBatch:
    """Structure-of-arrays batch of events — the columnar event backbone.

    Numeric per-row state lives in parallel numpy columns; names are
    dictionary-encoded against ``name_table``; rarely-populated state (attrs
    dicts) lives in an optional side table (``attrs is None`` ⇒ no row in the
    batch carries attrs — the fast path).  ``devices``/``regions`` are either
    a single tuple shared by every row (the common case) or per-row lists.
    """

    __slots__ = ("kinds", "steps", "times", "sizes", "addrs", "seqs",
                 "name_ids", "name_table", "attrs", "devices", "regions",
                 "counts", "normalized", "_events")

    def __init__(self, kinds, steps, times, sizes, addrs, seqs, name_ids,
                 name_table, attrs=None, devices=(), regions=(), counts=None,
                 normalized=False, events=None):
        self.kinds = kinds
        self.steps = steps
        self.times = times
        self.sizes = sizes
        self.addrs = addrs
        self.seqs = seqs
        self.name_ids = name_ids
        self.name_table = name_table
        self.attrs = attrs
        self.devices = devices
        self.regions = regions
        self.counts = counts          # filled by EventProcessor.normalize_batch
        self.normalized = normalized
        self._events = events         # scalar-origin Event rows (identity)

    # ------------------------------------------------------------- builders
    @classmethod
    def of(cls, kind, n: int | None = None, names=None, name_ids=None,
           name_table=None, steps=None, times=None, sizes=None, addrs=None,
           seqs=None, attrs=None, device=(), region=()) -> "EventBatch":
        """Vectorized batch construction for columnar producers.

        ``kind`` is one EventKind (broadcast) or a per-row code array.
        Names are passed either as a per-row string list (``names``) or
        pre-encoded as ``name_ids`` + ``name_table``.  Omitted columns get
        cheap defaults; ``seqs`` defaults to a fresh contiguous reservation
        from the global counter.
        """
        cols = (("kind", None if isinstance(kind, EventKind) else kind),
                ("names", names), ("name_ids", name_ids), ("steps", steps),
                ("times", times), ("sizes", sizes), ("addrs", addrs),
                ("seqs", seqs), ("attrs", attrs))
        for _label, col in cols:
            if col is not None:
                n = len(col)
                break
        else:
            if n is None:
                raise ValueError("cannot infer batch length; pass n=")
        for label, col in cols:
            if col is not None and len(col) != n:
                raise ValueError(
                    f"column {label!r} has length {len(col)}, expected {n}")
        if isinstance(kind, EventKind):
            kinds = np.full(n, KIND_CODE[kind], dtype=np.int16)
        else:
            kinds = np.asarray(kind, dtype=np.int16)
        if name_ids is None:
            if names is None:
                name_ids = np.zeros(n, dtype=np.int32)
                name_table = [""]
            elif n == 0:
                name_ids = np.zeros(0, dtype=np.int32)
                name_table = []
            else:
                # vectorized dictionary encoding: one np.unique pass over a
                # fixed-width string array instead of a per-row _intern loop
                # (the table comes out sorted rather than
                # first-appearance-ordered — ids are opaque)
                uniq, inverse = np.unique(np.asarray(names),
                                          return_inverse=True)
                name_table = uniq.tolist()
                name_ids = inverse.astype(np.int32)
        else:
            name_ids = np.asarray(name_ids, dtype=np.int32)
            name_table = list(name_table if name_table is not None else [])
        mk = lambda col, dtype, fill: (  # noqa: E731
            np.full(n, fill, dtype=dtype) if col is None
            else np.asarray(col, dtype=dtype))
        return cls(
            kinds=kinds,
            steps=mk(steps, np.int64, -1),
            times=(np.full(n, _time.perf_counter(), dtype=np.float64)
                   if times is None else np.asarray(times, np.float64)),
            sizes=mk(sizes, np.int64, 0),
            addrs=mk(addrs, np.int64, 0),
            seqs=(take_seqs(n) if seqs is None
                  else np.asarray(seqs, np.int64)),
            name_ids=name_ids, name_table=name_table, attrs=attrs,
            devices=device, regions=region)

    @classmethod
    def from_events(cls, events) -> "EventBatch":
        """Wrap scalar :class:`Event` rows (compatibility path).  Keeps the
        original objects so scalar subscribers observe identical instances
        (attrs dicts are shared, normalization writes back)."""
        events = list(events)
        n = len(events)
        kinds = np.empty(n, dtype=np.int16)
        steps = np.empty(n, dtype=np.int64)
        times = np.empty(n, dtype=np.float64)
        sizes = np.empty(n, dtype=np.int64)
        addrs = np.empty(n, dtype=np.int64)
        seqs = np.empty(n, dtype=np.int64)
        name_ids = np.empty(n, dtype=np.int32)
        name_table: list = []
        index: dict = {}
        attrs = [None] * n
        devices = [()] * n
        regions = [()] * n
        for i, ev in enumerate(events):
            kinds[i] = KIND_CODE[ev.kind]
            steps[i] = ev.step
            times[i] = ev.time
            sizes[i] = ev.size
            addrs[i] = ev.addr
            seqs[i] = ev.seq
            name_ids[i] = _intern(ev.name, name_table, index)
            attrs[i] = ev.attrs
            devices[i] = ev.device
            regions[i] = ev.region
        return cls(kinds, steps, times, sizes, addrs, seqs, name_ids,
                   name_table, attrs=attrs, devices=devices, regions=regions,
                   events=events)

    # ------------------------------------------------------------ accessors
    def __len__(self) -> int:
        return len(self.kinds)

    def name_of(self, i: int) -> str:
        return self.name_table[self.name_ids[i]]

    def device_at(self, i: int) -> tuple:
        d = self.devices
        return d if isinstance(d, tuple) else d[i]

    def region_at(self, i: int) -> tuple:
        r = self.regions
        return r if isinstance(r, tuple) else r[i]

    def attrs_at(self, i: int):
        return None if self.attrs is None else self.attrs[i]

    def attr_column(self, key: str, default=0, rows=None,
                    dtype=None) -> np.ndarray:
        """Gather one attrs key across the side table as a dense column.

        Returns an ndarray aligned with ``rows`` (all rows when ``None``),
        filling ``default`` for rows without attrs or without ``key``.  The
        ``attrs is None`` fast path is a single ``np.full`` — tools never
        need to special-case batches that carry no side table, and per-row
        ``attrs_at`` loops collapse to one vectorized gather + array op.
        """
        n = len(self) if rows is None else len(rows)
        if self.attrs is None:
            return np.full(n, default, dtype=dtype)
        if rows is None:
            src = self.attrs
        else:
            src = (self.attrs[int(i)] for i in rows)
        return np.asarray([default if a is None else a.get(key, default)
                           for a in src], dtype=dtype)

    def mask(self, *kinds) -> np.ndarray:
        codes = codes_for(kinds)
        if codes is None:
            return np.ones(len(self), dtype=bool)
        if len(codes) == 1:
            return self.kinds == codes[0]
        return np.isin(self.kinds, codes)

    def rows(self, *kinds) -> np.ndarray:
        """Row indices whose kind is one of ``kinds`` (vectorized filter)."""
        return np.nonzero(self.mask(*kinds))[0]

    def present_kinds(self) -> list:
        return [KIND_LIST[c] for c in np.unique(self.kinds)]

    # -------------------------------------------------------- materialization
    def event(self, i: int) -> Event:
        """Materialize row ``i`` as a scalar :class:`Event` (compat view).
        Scalar-origin rows return the *original* object with normalized
        columns written back; columnar rows build a fresh Event sharing the
        side-table attrs dict (so preprocessing results stay visible)."""
        kind = KIND_LIST[self.kinds[i]]
        ev = self._events[i] if self._events is not None else None
        if ev is not None:
            ev.step = int(self.steps[i])
            ev.size = int(self.sizes[i])
            ev.normalized = self.normalized
        else:
            a = self.attrs[i] if self.attrs is not None else None
            ev = Event(kind, name=self.name_table[self.name_ids[i]],
                       step=int(self.steps[i]), time=float(self.times[i]),
                       device=self.device_at(i), size=int(self.sizes[i]),
                       addr=int(self.addrs[i]), region=self.region_at(i),
                       attrs=a if a is not None else {},
                       seq=int(self.seqs[i]), normalized=self.normalized)
        if self.normalized:
            if kind is EventKind.KERNEL_LAUNCH:
                ev.attrs.setdefault(
                    "count", int(self.counts[i]) if self.counts is not None
                    else 1)
            elif kind is EventKind.MEMCPY:
                ev.attrs.setdefault("direction", "d2d")
        return ev

    def iter_events(self, kinds=("*",)) -> Iterator[Event]:
        """Loop-over-rows fallback: yield scalar Events for matching rows."""
        codes = codes_for(kinds)
        if codes is None:
            idx = range(len(self))
        else:
            idx = np.nonzero(np.isin(self.kinds, codes))[0]
        for i in idx:
            yield self.event(int(i))


class EventRing:
    """Preallocated SoA ring buffer that accumulates emitted rows until a
    flush boundary (capacity, step edge, or explicit ``flush()``), then
    surfaces them as one :class:`EventBatch`."""

    def __init__(self, capacity: int = 4096):
        self.capacity = capacity
        self.n = 0
        self._kinds = np.empty(capacity, dtype=np.int16)
        self._steps = np.empty(capacity, dtype=np.int64)
        self._times = np.empty(capacity, dtype=np.float64)
        self._sizes = np.empty(capacity, dtype=np.int64)
        self._addrs = np.empty(capacity, dtype=np.int64)
        self._seqs = np.empty(capacity, dtype=np.int64)
        self._name_ids = np.empty(capacity, dtype=np.int32)
        self._name_table: list = []
        self._name_index: dict = {}
        self._attrs: list = []
        self._devices: list = []
        self._regions: list = []
        self._events: list = []
        self._any_event = False
        self._any_attrs = False

    def __len__(self) -> int:
        return self.n

    @property
    def full(self) -> bool:
        return self.n >= self.capacity

    def append(self, code, name, step, time, size, addr, seq, attrs,
               device, region, event: Event | None = None) -> bool:
        """Append one row; returns True when the ring reached capacity."""
        i = self.n
        self._kinds[i] = code
        self._steps[i] = step
        self._times[i] = time
        self._sizes[i] = size
        self._addrs[i] = addr
        self._seqs[i] = seq
        self._name_ids[i] = _intern(name, self._name_table,
                                    self._name_index)
        self._attrs.append(attrs)
        self._devices.append(device)
        self._regions.append(region)
        self._events.append(event)
        if event is not None:
            self._any_event = True
        if attrs:
            self._any_attrs = True
        self.n = i + 1
        return self.n >= self.capacity

    def flush(self) -> EventBatch | None:
        """Drain the ring into an EventBatch (or None when empty)."""
        n = self.n
        if n == 0:
            return None
        batch = EventBatch(
            self._kinds[:n].copy(), self._steps[:n].copy(),
            self._times[:n].copy(), self._sizes[:n].copy(),
            self._addrs[:n].copy(), self._seqs[:n].copy(),
            self._name_ids[:n].copy(), list(self._name_table),
            # attrs=None is the vectorized fast path — only surface the side
            # table when some appended row actually carried attrs
            attrs=self._attrs if self._any_attrs else None,
            devices=self._devices, regions=self._regions,
            events=self._events if self._any_event else None)
        self.n = 0
        self._name_table = []
        self._name_index = {}
        self._attrs = []
        self._devices = []
        self._regions = []
        self._events = []
        self._any_event = False
        self._any_attrs = False
        return batch


#: The reference's collective opcodes: the names COLLECTIVE events carry
#: (``attrs["opcode"]``).  ``capture`` maps NCCL kernels onto them by name
#: fragment and ``trace`` maps the dispatched collectives (DTensor's
#: functional collectives, the c10d calls of ``dist.collectives``).
COLLECTIVE_OPCODES = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
    "ragged-all-to-all",
    "collective-broadcast",
)
