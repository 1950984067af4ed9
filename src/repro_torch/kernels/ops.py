"""Dispatch wrappers for the PASTA analysis kernels.

Two levels:

  * the host API — :func:`object_histogram`, :func:`hotness_histogram`,
    :func:`trace_aggregate`, :func:`can_fuse` — takes byte addresses as
    int64 numpy arrays and returns int64 numpy counts.  It converts to
    512-byte int32 units and bins times on the host, copies the columns to
    ``device``, runs the reduction there and copies the aggregates back;
  * the tensor wrappers — :func:`object_histogram_t`,
    :func:`hotness_histogram_t`, :func:`trace_aggregate_t` — take int32
    unit tensors.  On a CUDA tensor they launch the hand-written kernel
    (built by :mod:`repro_torch.kernels.build`) or raise; on a CPU tensor
    they run the plain version in :mod:`repro_torch.kernels.ref`.  There
    is no fallback from the kernel to the plain version.

Every kernel launch adds one to ``launches[<kernel>]``; each launch of
``instrumented_matmul`` also adds one to ``bodies[<body>]``.  The host
API's copies, which wait for the stream's queued work, add their host time
to the probe's ``reduction wait ns`` counter (:mod:`repro_torch.probe`).

Addresses in 512-byte units are lossless because the pool rounds tensors
to 512 B.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from .. import probe
from . import build, ref

UNIT_SHIFT = 9                 # 512-byte address units
BLOCK_SHIFT = 12               # 2 MiB blocks = 4096 units = 2**12
THREADS = 256                  # threads per block of the GLOBAL kernels
RECORDS_PER_THREAD = 8         # their grid sizing: records each thread takes
TILE_THREADS = 512             # threads per block of the hotness TILES kernel
#: how a histogram kernel keeps its accumulator (records.cuh's Kind, by
#: index): one copy per block of clusters that share the records, one tile
#: of the map per block, or global atomics
KINDS = ("cluster", "tiles", "global")
# the fused kernel (csrc/trace_aggregate.cu): clusters of FUSED_CLUSTER
# blocks (the portable maximum) of one of FUSED_THREADS threads, each
# thread loading FUSED_RECORDS records a round (the kernel's RECORDS)
FUSED_CLUSTER = 8
FUSED_THREADS = (512, 1024)
FUSED_RECORDS = 8
FUSED_ROUNDS = 4               # rounds one cluster takes before another joins

#: kernel name -> number of launches (the CPU path never counts)
launches = {"object_histogram": 0, "hotness_histogram": 0,
            "trace_aggregate": 0, "instrumented_matmul": 0}
#: body of instrumented_matmul -> number of launches
bodies = {"wgmma": 0, "simt": 0}


def reset_launches() -> None:
    for counter in (launches, bodies):
        for k in counter:
            counter[k] = 0


# ---------------------------------------------------------------- host side
@probe.wrap("reduce prep")
def _to_units(addrs_bytes) -> np.ndarray:
    a = np.asarray(addrs_bytes, dtype=np.int64) >> UNIT_SHIFT
    assert a.max(initial=0) < 2**31, "address space exceeds int32 units"
    return a.astype(np.int32)


@probe.wrap("reduce prep")
def _time_bins(times, t_max: float, n_tbins: int) -> np.ndarray:
    t = np.asarray(times, dtype=np.float64)
    tb = (t / max(t_max, 1e-12) * n_tbins).astype(np.int32)
    return np.minimum(tb, np.int32(n_tbins - 1))


@probe.wrap("reduce copies")
def _on(x: np.ndarray, device) -> torch.Tensor:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           "available; pass device='cpu' for the plain "
                           "version")
    t0 = time.perf_counter_ns()
    out = torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    # a copy from pageable memory waits for the stream's queued work
    probe.count("reduction wait ns", time.perf_counter_ns() - t0)
    return out


@probe.wrap("reduce copies")
def _host(t: torch.Tensor) -> np.ndarray:
    t0 = time.perf_counter_ns()
    out = t.cpu().numpy().astype(np.int64)
    probe.count("reduction wait ns", time.perf_counter_ns() - t0)
    return out


def object_histogram(addrs_bytes, starts_bytes, ends_bytes, device="cuda"):
    """Per-object access counts. Returns int64[K]."""
    a = _to_units(addrs_bytes)
    s = _to_units(starts_bytes)
    e = _to_units(ends_bytes)
    assert a.shape[0] < 2**24, "split traces >16M records"
    return _host(object_histogram_t(_on(a, device), _on(s, device),
                                    _on(e, device)))


def hotness_histogram(addrs_bytes, times, base_addr: int, n_blocks: int,
                      n_tbins: int, t_max: float,
                      block_shift: int = BLOCK_SHIFT, device="cuda"):
    """[time-bin × block] hotness (block = 2^block_shift 512-B units; default
    2 MiB, the UVM page-group size). Returns int64[n_tbins, n_blocks]."""
    a = _to_units(addrs_bytes)
    tb = _time_bins(times, t_max, n_tbins)
    base = int(_to_units([base_addr])[0])
    return _host(hotness_histogram_t(_on(a, device), _on(tb, device), base,
                                     n_blocks, n_tbins, block_shift))


def can_fuse(n_objects: int, n_blocks: int, n_tbins: int,
             device="cuda") -> bool:
    """Whether the fused counts+hotness kernel can host this problem: its
    object table, counts and hotness map all live in one block's shared
    memory, so they must fit the device's opt-in limit.  Callers fall back
    to the two separate kernels when this returns False.  The plain CPU
    version has no such limit."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return True
    return fused_smem_bytes(n_objects, n_blocks, n_tbins) <= _smem_optin(dev)


def trace_aggregate(addrs_bytes, times, starts_bytes, ends_bytes,
                    base_addr: int, n_blocks: int, n_tbins: int,
                    t_max: float, block_shift: int = BLOCK_SHIFT,
                    device="cuda"):
    """Fused per-object counts AND [time-bin × block] hotness from ONE pass
    over the trace.  Returns ``(int64[K] counts, int64[n_tbins, n_blocks]
    hotness)`` identical to running :func:`object_histogram` and
    :func:`hotness_histogram` separately."""
    a = _to_units(addrs_bytes)
    s = _to_units(starts_bytes)
    e = _to_units(ends_bytes)
    tb = _time_bins(times, t_max, n_tbins)
    base = int(_to_units([base_addr])[0])
    assert a.shape[0] < 2**24, "split traces >16M records"
    counts, hist = trace_aggregate_t(
        _on(a, device), _on(tb, device), _on(s, device), _on(e, device),
        base, n_blocks, n_tbins, block_shift)
    return _host(counts), _host(hist)


# ----------------------------------------------------------- tensor wrappers
def fused_smem_bytes(k: int, n_blocks: int, n_tbins: int) -> int:
    """Shared memory of the fused kernel: object table (starts, ends),
    counts and the hotness map, all int32."""
    return 4 * 3 * k + 4 * n_tbins * n_blocks


def _smem_optin(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).shared_memory_per_block_optin


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def global_grid(n: int, sms: int) -> int:
    """Blocks of a GLOBAL kernel for ``n`` records on a card of ``sms``
    SMs: RECORDS_PER_THREAD records a thread, at most two blocks an SM."""
    per_block = THREADS * RECORDS_PER_THREAD
    return max(1, min(-(-n // per_block), 2 * sms))


def fused_plan(n: int, sms: int):
    """(clusters, threads) of the fused kernel for ``n`` records on a card
    of ``sms`` SMs.  One cluster while its blocks take ``n`` in
    FUSED_ROUNDS rounds of loads: the launch then writes its outputs in
    full.  Beyond that as many as fill the card, merging into outputs
    zeroed by one fill.  Blocks of the fewest threads that take a block's
    share in one round: smaller blocks start and set up sooner."""
    per_round = FUSED_CLUSTER * FUSED_THREADS[-1] * FUSED_RECORDS
    want = -(-n // (per_round * FUSED_ROUNDS))
    clusters = max(1, min(want, sms // FUSED_CLUSTER))
    share = fused_shares(n, clusters * FUSED_CLUSTER)[0][1]
    threads = next((t for t in FUSED_THREADS if share <= t * FUSED_RECORDS),
                   FUSED_THREADS[-1])
    return clusters, threads


def fused_shares(n: int, blocks: int) -> list:
    """[lo, hi) of the records each of ``blocks`` blocks takes, as the
    fused kernel computes them: even shares in whole rounds of
    FUSED_RECORDS, the last ones shorter or empty."""
    per_block = -(-n // blocks)
    share = -(-per_block // FUSED_RECORDS) * FUSED_RECORDS
    return [(min(n, b * share), min(n, b * share + share))
            for b in range(blocks)]


class Plan(NamedTuple):
    """One launch of a histogram kernel: its kind (one of KINDS), blocks,
    blocks per cluster (0: no clusters), threads per block and dynamic
    shared memory in bytes."""
    kind: str
    blocks: int
    cluster: int
    threads: int
    smem: int

    @property
    def fills(self) -> bool:
        """Whether the output must be zeroed before the launch: the kernel
        adds into it (GLOBAL, or several clusters) instead of writing every
        value itself."""
        return self.kind == "global" or (self.kind == "cluster"
                                         and self.blocks > self.cluster)


def _cluster_plan(n: int, sms: int, smem: int) -> Plan:
    clusters, threads = fused_plan(n, sms)
    return Plan("cluster", clusters * FUSED_CLUSTER, FUSED_CLUSTER, threads,
                smem)


def object_plan(n: int, k: int, sms: int, smem_optin: int) -> Plan:
    """The object histogram's launch for ``n`` records and ``k`` objects on
    a card of ``sms`` SMs whose blocks may opt into ``smem_optin`` bytes of
    shared memory: clusters with the table and the counts in each block's
    shared memory while their 12*K bytes fit (as many clusters as
    :func:`fused_plan` gives, one for every buffer of the main path), else
    global atomics."""
    if 12 * k <= smem_optin:
        return _cluster_plan(n, sms, 12 * k)
    return Plan("global", global_grid(n, sms), 0, THREADS, 0)


def hotness_plan(n: int, n_tbins: int, n_blocks: int, sms: int,
                 smem_optin: int) -> Plan:
    """The hotness histogram's launch for ``n`` records over an
    ``n_tbins`` x ``n_blocks`` map on a card of ``sms`` SMs whose blocks
    may opt into ``smem_optin`` bytes of shared memory:

    * ``cluster`` while the whole map fits one block (as the fused kernel);
    * ``tiles``, one block per tile of the map, each at most the opt-in:
      as many tiles as SMs, fewer where re-reading the trace once per tile
      (8 B a record) would move more bytes than the map (4 B a cell);
    * ``global`` where even the fewest tiles would."""
    cells = n_tbins * n_blocks
    if 4 * cells <= smem_optin:
        return _cluster_plan(n, sms, 4 * cells)
    cap = smem_optin // 16 * 4          # cells of the largest tile
    fewest = -(-cells // cap)
    tiles = max(fewest, sms)
    if n:
        tiles = min(tiles, cells // (2 * n))
    if tiles < fewest:
        return Plan("global", global_grid(n, sms), 0, THREADS, 0)
    tile = -(-cells // tiles)
    tile = -(-tile // 4) * 4            # whole 16-byte groups
    return Plan("tiles", -(-cells // tile), 0, TILE_THREADS, 4 * tile)


def tile_cells(cells: int, plan: Plan) -> list:
    """[lo, hi) of the map cells each block of a ``tiles`` plan owns, as the
    TILES kernel computes them."""
    tile = plan.smem // 4
    return [(b * tile, min(cells, (b + 1) * tile))
            for b in range(plan.blocks)]


def _check(name: str, *tensors: torch.Tensor) -> str:
    """The device type the tensors share; raises on what no path takes."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous 1-D int32, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _check_hot(base: int, n_blocks: int, n_tbins: int,
               block_shift: int) -> None:
    if not -2**31 <= base < 2**31:
        raise ValueError(f"base {base} does not fit int32 units")
    if not 0 <= block_shift < 31:
        raise ValueError(f"block_shift {block_shift} outside [0, 31)")
    if n_blocks < 1 or n_tbins < 1 or n_blocks * n_tbins >= 2**31:
        raise ValueError(f"hotness map {n_tbins}x{n_blocks} out of range")


def _launch(name: str, dev: torch.device, *args) -> None:
    lib = build.load(name)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = getattr(lib, f"{name}_launch")(index, *args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{lib.pasta_error_string(err).decode()}")
    launches[name] += 1


def _output(plan: Plan, shape, dev: torch.device) -> torch.Tensor:
    """The int32 output of a histogram launch: zeroed by one fill only
    where the kernel adds into it."""
    alloc = torch.zeros if plan.fills else torch.empty
    return alloc(shape, dtype=torch.int32, device=dev)


def _plan_args(plan: Plan) -> tuple:
    return (KINDS.index(plan.kind), plan.blocks, plan.cluster, plan.threads,
            plan.smem)


@probe.wrap("reduce launch")
def object_histogram_t(addrs: torch.Tensor, starts: torch.Tensor,
                       ends: torch.Tensor) -> torch.Tensor:
    """int32 unit tensors → int32[K] counts."""
    if _check("object_histogram", addrs, starts, ends) == "cpu":
        return ref.object_histogram_ref(addrs, starts, ends)
    dev, n, k = addrs.device, addrs.shape[0], starts.shape[0]
    if k == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    plan = object_plan(n, k, _sms(dev), _smem_optin(dev))
    counts = _output(plan, k, dev)
    _launch("object_histogram", dev, addrs.data_ptr(), n, starts.data_ptr(),
            ends.data_ptr(), k, counts.data_ptr(), *_plan_args(plan))
    return counts


@probe.wrap("reduce launch")
def hotness_histogram_t(addrs: torch.Tensor, tbins: torch.Tensor, base: int,
                        n_blocks: int, n_tbins: int,
                        block_shift: int) -> torch.Tensor:
    """int32 unit addresses and time bins → int32[n_tbins, n_blocks]."""
    _check_hot(base, n_blocks, n_tbins, block_shift)
    if _check("hotness_histogram", addrs, tbins) == "cpu":
        return ref.hotness_histogram_ref(addrs, tbins, base, n_blocks,
                                         n_tbins, block_shift)
    dev, n = addrs.device, addrs.shape[0]
    plan = hotness_plan(n, n_tbins, n_blocks, _sms(dev), _smem_optin(dev))
    hist = _output(plan, (n_tbins, n_blocks), dev)
    _launch("hotness_histogram", dev, addrs.data_ptr(), tbins.data_ptr(), n,
            base, block_shift, n_blocks, n_tbins, hist.data_ptr(),
            *_plan_args(plan))
    return hist


@probe.wrap("reduce launch")
def trace_aggregate_t(addrs: torch.Tensor, tbins: torch.Tensor,
                      starts: torch.Tensor, ends: torch.Tensor, base: int,
                      n_blocks: int, n_tbins: int, block_shift: int):
    """Fused: → (int32[K] counts, int32[n_tbins, n_blocks] hotness).  On
    the card the problem must pass :func:`can_fuse`."""
    _check_hot(base, n_blocks, n_tbins, block_shift)
    if _check("trace_aggregate", addrs, tbins, starts, ends) == "cpu":
        return ref.trace_aggregate_ref(addrs, tbins, starts, ends, base,
                                       n_blocks, n_tbins, block_shift)
    dev, n, k = addrs.device, addrs.shape[0], starts.shape[0]
    smem = fused_smem_bytes(k, n_blocks, n_tbins)
    if smem > _smem_optin(dev):
        raise ValueError(f"fused problem (K={k}, {n_tbins}x{n_blocks}) "
                         f"needs {smem} B of shared memory; check can_fuse")
    clusters, threads = fused_plan(n, _sms(dev))
    # one buffer for both outputs, the map first (16-byte aligned for the
    # kernel's vector stores): written in full by one cluster, zeroed by
    # one fill when several clusters merge into it
    cells = n_tbins * n_blocks
    alloc = torch.empty if clusters == 1 else torch.zeros
    out = alloc(cells + k, dtype=torch.int32, device=dev)
    _launch("trace_aggregate", dev, addrs.data_ptr(), tbins.data_ptr(), n,
            starts.data_ptr(), ends.data_ptr(), k, base, block_shift,
            n_blocks, n_tbins, out.data_ptr() + 4 * cells, out.data_ptr(),
            clusters, FUSED_CLUSTER, threads, smem)
    return out[cells:], out[:cells].view(n_tbins, n_blocks)
