"""Host-offload planner — the paper's tensor-aware UVM prefetcher (paper
§V-C1, Figs. 11–12) as a simulation of scheduled host-DRAM offload over the
host link.  The planning question is the paper's: *at which granularity*
(pool memory object vs. individual tensor) should data be
prefetched/evicted, and the answer flips with memory pressure exactly as in
the paper:

  * no oversubscription → object-level slightly wins (fewer, larger DMAs;
    per-transfer latency amortized);
  * oversubscription (footprint > capacity) → object-level thrashes (objects
    carry never-accessed tensors that evict hot data), tensor-level wins.

The simulator executes a kernel schedule against an LRU-resident device
memory with a lookahead-1 prefetcher overlapped with compute, under an
analytic DMA cost model.  Inputs come from the working-set/trace analyses
(which tensors each kernel *actually* accesses — the access-verified sets).
"""

from __future__ import annotations

import collections
import dataclasses

# host-link cost model (per-direction); tuned to PCIe-4 x16-class links used
# by the paper's systems.
LINK_BW = 16e9                 # bytes/s
XFER_LAT = 30e-6               # per-DMA fixed latency (fault/driver overhead)
PAGE = 2 * 1024 * 1024


@dataclasses.dataclass
class KernelAccess:
    """One kernel's access-verified data needs."""
    name: str
    compute_s: float
    tensors: list              # [(tensor_id, size, object_id)]

    def tensor_units(self):
        return [(("t", tid), sz) for tid, sz, _oid in self.tensors]

    def object_units(self, object_sizes):
        oids = {oid for _t, _s, oid in self.tensors}
        return [(("o", oid), object_sizes[oid]) for oid in sorted(oids)]


class _Resident:
    """LRU-managed device residency at arbitrary unit granularity."""

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.units: collections.OrderedDict = collections.OrderedDict()
        self.used = 0
        self.evicted_bytes = 0

    def touch(self, unit, size) -> bool:
        """Ensure unit resident; return True if it was already present."""
        if unit in self.units:
            self.units.move_to_end(unit)
            return True
        self._make_room(size)
        self.units[unit] = size
        self.used += size
        return False

    def _make_room(self, size):
        while self.used + size > self.capacity and self.units:
            _u, s = self.units.popitem(last=False)
            self.used -= s
            self.evicted_bytes += s


def _xfer_time(nbytes: int, n_xfers: int = 1) -> float:
    return nbytes / LINK_BW + n_xfers * XFER_LAT


def simulate(schedule, object_sizes, capacity: int,
             policy: str = "none") -> dict:
    """Run the schedule under one residency policy.

    policy:
      * ``none``   — on-demand migration (paper baseline): misses stall.
      * ``object`` — lookahead-1 prefetch of whole memory objects, overlapped.
      * ``tensor`` — lookahead-1 prefetch of accessed tensors, overlapped.
    """
    res = _Resident(capacity)
    total = 0.0
    stall = 0.0
    migrated = 0
    inflight = 0.0             # prefetch time still outstanding

    def units_for(k: KernelAccess):
        if policy == "object":
            return k.object_units(object_sizes)
        return k.tensor_units()

    for i, k in enumerate(schedule):
        # 1) whatever this kernel needs and is absent must migrate NOW (stall)
        miss_bytes = 0
        miss_n = 0
        for unit, size in units_for(k):
            if not res.touch(unit, size):
                miss_bytes += size
                miss_n += 1
        demand = _xfer_time(miss_bytes, miss_n) if miss_bytes else 0.0
        migrated += miss_bytes
        # outstanding prefetch must finish before dependent compute (if the
        # missed units were being prefetched we already charged them; model
        # keeps it simple: demand migration and prefetch share the link)
        t_step = k.compute_s + demand + max(0.0, inflight - k.compute_s)
        stall += demand + max(0.0, inflight - k.compute_s)
        inflight = 0.0
        # 2) overlap: prefetch next kernel's units during this one
        if policy in ("object", "tensor") and i + 1 < len(schedule):
            nxt = schedule[i + 1]
            pf_bytes = 0
            pf_n = 0
            for unit, size in units_for(nxt):
                if not res.touch(unit, size):
                    pf_bytes += size
                    pf_n += 1
            migrated += pf_bytes
            inflight = _xfer_time(pf_bytes, pf_n) if pf_bytes else 0.0
        total += t_step
    return {"policy": policy, "time_s": total, "stall_s": stall,
            "migrated_bytes": migrated, "evicted_bytes": res.evicted_bytes}


def plan(schedule, object_sizes, footprint: int,
         oversubscription: float = 1.0) -> dict:
    """Compare policies at ``capacity = footprint / oversubscription``."""
    min_unit = max((sz for k in schedule for _t, sz, _o in k.tensors),
                   default=PAGE)
    capacity = max(min_unit, int(footprint / max(oversubscription, 1e-9)))
    out = {"capacity_bytes": capacity, "oversubscription": oversubscription}
    for policy in ("none", "object", "tensor"):
        out[policy] = simulate(schedule, object_sizes, capacity, policy)
    base = out["none"]["time_s"]
    for policy in ("object", "tensor"):
        out[policy]["speedup_vs_none"] = (
            base / out[policy]["time_s"] if out[policy]["time_s"] else 0.0)
    return out
