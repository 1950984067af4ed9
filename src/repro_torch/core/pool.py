"""Virtual caching allocator — the pool-based memory model (paper §V-C1).

DL frameworks allocate large *memory objects* from the driver and sub-allocate
individual *tensors* inside them (PyTorch's caching allocator).  PASTA's key UVM insight is that
object granularity != tensor granularity: one object holds many tensors with
different lifetimes, so object-level prefetch/offload decisions are suboptimal
under memory pressure.

This module models that address space faithfully: a best-fit free-list
sub-allocator inside 2 MiB-aligned chunks, emitting ALLOC / TENSOR_ALLOC /
TENSOR_FREE events.  It does *not* allocate device memory — PyTorch owns the
real buffers — it mirrors their lifetimes so the analysis tools can reason
about addresses, blocks, and reuse exactly the way the paper's tools do.
Addresses are virtual (never ``data_ptr()``), so object ranges and hotness
blocks do not depend on where the caching allocator happens to place a
tensor.

Deliberate quirk kept from real runtimes: TENSOR_FREE events are emitted with
a *negative* size delta (some runtimes report deallocations that way, per the
paper's normalization discussion); the event processor normalizes the sign.
"""

from __future__ import annotations

import bisect
import dataclasses
import itertools

from .. import probe
from .events import EventKind, next_seq

CHUNK_ALIGN = 2 * 1024 * 1024        # 2 MiB — UVM/hotness block granularity
TENSOR_ROUND = 512                   # PyTorch-style 512 B rounding


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclasses.dataclass
class TensorHandle:
    tid: int
    name: str
    addr: int
    size: int            # rounded, bytes
    nbytes: int          # requested, bytes
    object_id: int
    alloc_seq: int
    free_seq: int = -1

    @property
    def live(self) -> bool:
        return self.free_seq < 0

    def addr_range(self) -> tuple:
        return (self.addr, self.addr + self.size)


@dataclasses.dataclass
class MemoryObject:
    """One pool chunk (a ``cudaMalloc``-analogue memory object)."""

    oid: int
    base: int
    size: int
    # free blocks as sorted list of (addr, size)
    free_blocks: list = dataclasses.field(default_factory=list)
    used: int = 0

    def __post_init__(self):
        if not self.free_blocks:
            self.free_blocks = [(self.base, self.size)]

    def fit(self, size: int) -> int | None:
        """Best-fit block address or None."""
        best = None
        for addr, bsz in self.free_blocks:
            if bsz >= size and (best is None or bsz < best[1]):
                best = (addr, bsz)
        return best[0] if best else None

    def carve(self, addr: int, size: int) -> None:
        for i, (a, bsz) in enumerate(self.free_blocks):
            if a == addr:
                assert bsz >= size
                self.free_blocks.pop(i)
                if bsz > size:
                    self.free_blocks.append((a + size, bsz - size))
                    self.free_blocks.sort()
                self.used += size
                return
        raise ValueError("carve from non-free address")

    def release(self, addr: int, size: int) -> None:
        bisect.insort(self.free_blocks, (addr, size))
        self.used -= size
        # coalesce neighbours
        merged = []
        for a, s in self.free_blocks:
            if merged and merged[-1][0] + merged[-1][1] == a:
                merged[-1] = (merged[-1][0], merged[-1][1] + s)
            else:
                merged.append((a, s))
        self.free_blocks = [tuple(b) for b in merged]


class MemoryPool:
    """Caching allocator model emitting PASTA memory events."""

    def __init__(self, handler=None, chunk_size: int = 32 * 1024 * 1024,
                 device: tuple = (), align: int = CHUNK_ALIGN):
        self._handler = handler
        self.chunk_size = chunk_size
        self.align = align
        self.device = device
        self.objects: dict[int, MemoryObject] = {}
        self.tensors: dict[int, TensorHandle] = {}
        self._next_addr = CHUNK_ALIGN          # never hand out address 0
        self._oid = itertools.count()
        self._tid = itertools.count()
        self.peak_bytes = 0
        self.live_bytes = 0

    @property
    def handler(self):
        """The pool's event sink.  A pool constructed without an explicit
        handler resolves the innermost active session *at emit time*, so one
        pool composes with nested/scoped sessions."""
        if self._handler is not None:
            return self._handler
        from .session import current_handler
        return current_handler()

    # ----------------------------------------------------------------- chunks
    def _new_object(self, min_size: int) -> MemoryObject:
        size = _round_up(max(min_size, self.chunk_size), self.align)
        base = self._next_addr
        self._next_addr += size + self.align    # guard gap between objects
        obj = MemoryObject(next(self._oid), base, size)
        self.objects[obj.oid] = obj
        self.handler.emit_row(EventKind.ALLOC, name=f"object{obj.oid}",
                              size=size, addr=base, device=self.device,
                              attrs={"object_id": obj.oid})
        return obj

    # ---------------------------------------------------------------- tensors
    @probe.wrap("pool alloc")
    def alloc(self, nbytes: int, name: str = "") -> TensorHandle:
        size = _round_up(max(nbytes, 1), TENSOR_ROUND)
        obj = None
        for o in self.objects.values():
            if o.fit(size) is not None:
                obj = o
                break
        if obj is None:
            obj = self._new_object(size)
        addr = obj.fit(size)
        obj.carve(addr, size)
        t = TensorHandle(next(self._tid), name, addr, size, nbytes, obj.oid,
                         alloc_seq=0)
        self.tensors[t.tid] = t
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        # seq is reserved (and the handle stamped) BEFORE dispatch so
        # subscribers that query the pool during dispatch see a consistent
        # handle state
        t.alloc_seq = next_seq()
        self.handler.emit_row(
            EventKind.TENSOR_ALLOC, name=name or f"tensor{t.tid}",
            size=size, addr=addr, device=self.device, seq=t.alloc_seq,
            attrs={"tensor_id": t.tid, "object_id": obj.oid,
                   "requested": nbytes})
        return t

    def free(self, t: TensorHandle) -> None:
        if not t.live:
            raise ValueError(f"double free of tensor {t.tid}")
        self.objects[t.object_id].release(t.addr, t.size)
        self.live_bytes -= t.size
        # NOTE: raw size is negative on purpose — normalization test surface.
        t.free_seq = next_seq()          # stamp before dispatch (see alloc)
        self.handler.emit_row(
            EventKind.TENSOR_FREE, name=t.name, size=-t.size, addr=t.addr,
            device=self.device, seq=t.free_seq,
            attrs={"tensor_id": t.tid, "object_id": t.object_id})

    # ------------------------------------------------------------------ views
    def live_tensors(self) -> list:
        probe.count("pool handles scanned", len(self.tensors))
        return [t for t in self.tensors.values() if t.live]

    def object_of(self, addr: int) -> MemoryObject | None:
        for o in self.objects.values():
            if o.base <= addr < o.base + o.size:
                return o
        return None

    def tensor_at(self, addr: int) -> TensorHandle | None:
        for t in self.tensors.values():
            if t.live and t.addr <= addr < t.addr + t.size:
                return t
        return None

    @property
    def footprint(self) -> int:
        """Total bytes of pool objects obtained from the 'driver'."""
        return sum(o.size for o in self.objects.values())
