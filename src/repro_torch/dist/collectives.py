"""Compressed + async cross-pod collectives on ``torch.distributed``.

Cross-pod gradient sync is the one collective that crosses the slow
inter-pod links, so it gets a compressed variant and an async (split)
variant:

* :func:`compressed_psum` — quantized **reduce-scatter + all-gather**: each
  participant quantizes its payload to int8 with per-group absmax scales,
  an all-to-all delivers every peer's contribution for the local output
  shard (wire: ~1× int8 payload regardless of pod count), the shard is
  summed locally, re-quantized, and all-gathered (wire: ~1× int8 payload).
  Per-device wire bytes are therefore O(1) in pod count.
* :func:`psum_start` / :func:`psum_wait` — the bucketed async primitives:
  ``psum_start`` issues the reduce half (``reduce_scatter_tensor``, or the
  quantized ``all_to_all_single`` + local sum) with ``async_op=True`` and
  returns a :class:`PsumHandle`; ``psum_wait`` waits for it and completes
  it with the all-gather.  Compute placed between a start and its wait
  overlaps the in-flight collective.

All of them act on a rank's local tensor (a DTensor's ``to_local()``), as
the reference's run inside ``shard_map``, over ``axis``: a dimension of
the registered mesh (``"pod"`` → ``mesh.get_group("pod")``) or a process
group.  The arithmetic is the
reference's, step for step, in float32; :func:`simulate_compressed_psum`
is its numpy mirror.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

#: quantization group size for the wire layout — one f32 scale per GROUP
#: int8 payload bytes (+6% scale overhead, enough resolution for the <1%
#: round-trip bound through both quantization stages)
GROUP = 64


# ------------------------------------------------------------- quantization
def quantize_int8(x: torch.Tensor):
    """Symmetric int8 with per-row (last-axis) absmax scales.

    Returns ``(q, scale)`` with ``q`` int8 of ``x``'s shape and ``scale``
    f32 of shape ``(*x.shape[:-1], 1)``.  Rounds half to even, as
    ``jnp.round`` does."""
    xf = x.to(torch.float32)
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    # a true division: CUDA multiplies by the reciprocal of a Python
    # scalar divisor, one ulp off the reference's scale at times
    scale = torch.clamp_min(amax, float(np.float32(1e-20))) / amax.new_full((), 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def _quantize_groups(flat: torch.Tensor, group: int = GROUP):
    """Quantize a flat f32 payload (length divisible by ``group``) to int8
    with one f32 absmax scale per contiguous group of ``group`` elements.
    Returns ``(q int8 [L], scales f32 [L // group])``."""
    q, scale = quantize_int8(flat.reshape(-1, group))
    return q.reshape(-1), scale.reshape(-1)


def _dequantize_groups(q, scales, group: int = GROUP):
    g = q.reshape(-1, group).to(torch.float32)
    return (g * scales.reshape(-1, 1)).reshape(-1)


def _flatten_pad(x: torch.Tensor, multiple: int):
    """Flatten ``x`` to f32 1-D, zero-padded to a multiple of ``multiple``.
    Returns ``(flat, pad)``."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat, pad


# ----------------------------------------------------------- async handles
@dataclasses.dataclass
class PsumHandle:
    """In-flight bucketed psum: the reduced local shard (plus scales when
    compressed), the collective's ``Work`` handles still to wait for, and
    the metadata needed to finish and unflatten it."""

    payload: torch.Tensor         # (chunk,) f32, or int8 when compressed
    scales: torch.Tensor | None   # (chunk // group,) f32, compressed only
    shape: tuple
    dtype: torch.dtype
    pad: int
    compressed: bool
    group: int = GROUP
    works: list = dataclasses.field(default_factory=list)
    #: compressed: the received (int8, scales) chunks, reduced at wait
    received: tuple | None = None


def _pg(axis):
    """The process group of ``axis``: a dimension name of the registered
    mesh, or a process group (None: the default group)."""
    if not isinstance(axis, str):
        return axis
    from .sharding import get_mesh
    mesh = get_mesh()
    if mesh is None:
        raise ValueError(f"axis {axis!r} needs a registered mesh")
    return mesh.get_group(axis)


def psum_start(x: torch.Tensor, axis="pod", compressed: bool = False,
               group: int = GROUP) -> PsumHandle:
    """Issue the *reduce* half of a bucketed psum over ``axis``.

    Plain: one ``reduce_scatter_tensor`` — each rank ends up holding the
    fully reduced 1/N shard of the flattened payload.  Compressed:
    quantize, then ``all_to_all_single`` of the int8 chunks and of their
    scales; the received chunks are dequantized, summed and re-quantized
    when the handle is waited on.  Either way the wire transfer is in
    flight from this point (``async_op=True``); schedule independent
    compute before calling :func:`psum_wait`.
    """
    pg = _pg(axis)
    n = dist.get_world_size(pg)
    if not compressed:
        flat, pad = _flatten_pad(x, n)
        shard = flat.new_empty(flat.numel() // n)
        work = dist.reduce_scatter_tensor(shard, flat, group=pg,
                                          async_op=True)
        return PsumHandle(shard, None, tuple(x.shape), x.dtype, pad, False,
                          group, [work])
    flat, pad = _flatten_pad(x, n * group)
    q, s = _quantize_groups(flat, group)
    q_in, s_in = torch.empty_like(q), torch.empty_like(s)
    works = [dist.all_to_all_single(q_in, q, group=pg, async_op=True),
             dist.all_to_all_single(s_in, s, group=pg, async_op=True)]
    return PsumHandle(q, s, tuple(x.shape), x.dtype, pad, True, group,
                      works, (q_in, s_in))


def _reduce_received(handle: PsumHandle, n: int) -> None:
    """Compressed: dequantize the N received chunks, sum them in rank
    order and re-quantize the reduced shard into the handle."""
    q_in, s_in = handle.received
    shard = _dequantize_groups(q_in, s_in, handle.group).reshape(n, -1)
    total = shard[0]
    for i in range(1, n):
        total = total + shard[i]
    handle.payload, handle.scales = _quantize_groups(total, handle.group)
    handle.received = None


def psum_wait(handle: PsumHandle, axis="pod") -> torch.Tensor:
    """Finish a bucketed psum: wait for the reduce half, all-gather the
    reduced shards and restore the original shape and dtype."""
    pg = _pg(axis)
    n = dist.get_world_size(pg)
    for work in handle.works:
        work.wait()
    handle.works = []
    if handle.compressed:
        _reduce_received(handle, n)
        q = handle.payload.new_empty(handle.payload.numel() * n)
        s = handle.scales.new_empty(handle.scales.numel() * n)
        works = [dist.all_gather_into_tensor(q, handle.payload, group=pg,
                                             async_op=True),
                 dist.all_gather_into_tensor(s, handle.scales, group=pg,
                                             async_op=True)]
        for work in works:
            work.wait()
        flat = _dequantize_groups(q, s, handle.group)
    else:
        flat = handle.payload.new_empty(handle.payload.numel() * n)
        dist.all_gather_into_tensor(flat, handle.payload, group=pg)
    if handle.pad:
        flat = flat[:flat.numel() - handle.pad]
    return flat.reshape(handle.shape).to(handle.dtype)


# -------------------------------------------------------------- collectives
def plain_psum(x: torch.Tensor, axis="pod") -> torch.Tensor:
    """Uncompressed all-reduce over ``axis`` (baseline); returns a new
    tensor."""
    out = x.clone()
    dist.all_reduce(out, group=_pg(axis))
    return out


def compressed_psum(x: torch.Tensor, axis="pod") -> torch.Tensor:
    """int8-compressed all-reduce over ``axis``: a quantized reduce-scatter
    (all-to-all + local sum) followed by a quantized all-gather.  The
    result matches :func:`plain_psum` within quantization error (<1%
    relative through both quantization stages)."""
    squeeze = x.dim() == 0
    if squeeze:
        x = x.reshape(1)
    pg = _pg(axis)
    out = psum_wait(psum_start(x, pg, compressed=True), pg)
    return out[0] if squeeze else out


# ------------------------------------------------------------ numpy mirror
def _np_quantize_groups(flat: np.ndarray, group: int = GROUP):
    g = flat.reshape(-1, group)
    amax = np.max(np.abs(g), axis=-1, keepdims=True)
    scale = np.maximum(amax, np.float32(1e-20)) / np.float32(127.0)
    q = np.clip(np.round(g / scale), -127, 127).astype(np.int8)
    return q.reshape(-1), scale.reshape(-1).astype(np.float32)


def _np_dequantize_groups(q, scales, group: int = GROUP):
    g = q.reshape(-1, group).astype(np.float32)
    return (g * scales.reshape(-1, 1)).reshape(-1)


def simulate_compressed_psum(stacked: np.ndarray) -> np.ndarray:
    """Deterministic numpy mirror of :func:`compressed_psum`:
    ``stacked[i]`` is participant *i*'s payload; returns what every
    participant holds after the quantized reduce-scatter + all-gather
    (the data movement is a no-op on a host array)."""
    n = stacked.shape[0]
    flats = []
    pad = 0
    for x in stacked:
        flat = np.asarray(x, np.float32).reshape(-1)
        pad = (-flat.size) % (n * GROUP)
        flats.append(np.concatenate([flat, np.zeros(pad, np.float32)]))
    # stage A: per-participant quantization, exchange, local shard sum
    chunks = [_np_dequantize_groups(*_np_quantize_groups(f)).reshape(n, -1)
              for f in flats]
    shards = []
    for d in range(n):
        total = chunks[0][d]
        for c in chunks[1:]:
            total = total + c[d]
        shards.append(total)
    # stage B: re-quantize reduced shards, gather
    flat = np.concatenate([_np_dequantize_groups(*_np_quantize_groups(s))
                           for s in shards])
    if pad:
        flat = flat[:flat.size - pad]
    return flat.reshape(stacked.shape[1:])


# ------------------------------------------------------------- pod sync
def make_pod_sync(mesh, compressed: bool = False, axis: str = "pod",
                  mean: bool = False):
    """Cross-pod gradient synchronizer: tree of tensors → tree, psum over
    the mesh dimension ``axis``.

    This is the *blocking* baseline — one synchronous all-reduce per leaf
    at the point of call (the overlapped, bucketed variant is
    ``repro_torch.train.trainer.make_overlapped_pod_sync``).  Float leaves
    are all-reduced over the pod dimension (int8 reduce-scatter +
    all-gather when ``compressed=True``); non-float leaves (step counters,
    ...) pass through.  ``mean=True`` divides by the pod count.  Identity
    when the mesh has no pod dimension of size above 1.

    A DTensor leaf syncs its local block (each rank its own shard over the
    other dimensions) and comes back with its placements; a leaf must be
    replicated over ``axis`` itself.
    """
    from torch.distributed.tensor import DTensor
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return lambda grads: grads
    pg = mesh.get_group(axis)
    op = compressed_psum if compressed else plain_psum
    inv_n = 1.0 / mesh.size(names.index(axis))

    def sync_one(g):
        if not g.is_floating_point():
            return g
        local = g.to_local() if isinstance(g, DTensor) else g
        out = op(local, pg)
        if mean:
            out = (out * inv_n).to(local.dtype)
        if isinstance(g, DTensor):
            return DTensor.from_local(out, g.device_mesh, g.placements,
                                      run_check=False)
        return out

    def sync(grads):
        if isinstance(grads, dict):
            return {k: sync(v) for k, v in grads.items()}
        return sync_one(grads)

    return sync
