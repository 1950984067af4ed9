"""Plain PyTorch versions of the PASTA analysis kernels.

They are the CPU backend of :mod:`repro_torch.kernels.ops` and the
reference the CUDA kernels are held against on the card.  All inputs are
int32 tensors in 512-byte address units; outputs are int32 counts.
"""

from __future__ import annotations

import torch


def object_histogram_ref(addrs: torch.Tensor, starts: torch.Tensor,
                         ends: torch.Tensor) -> torch.Tensor:
    """Per-object access counts.

    addrs: int32[N] — accessed addresses (any unit, consistent with ranges).
    starts/ends: int32[K] — sorted, disjoint half-open object ranges.
    A record counts for the last object whose start is <= its address
    (``searchsorted(side="right") - 1``) when it lies below that object's
    end.  Returns int32[K].
    """
    k = starts.shape[0]
    if k == 0:
        return torch.zeros(0, dtype=torch.int32, device=addrs.device)
    idx = torch.searchsorted(starts, addrs, right=True) - 1
    idx_c = idx.clamp(0, k - 1)
    valid = (idx >= 0) & (addrs < ends[idx_c]) & (addrs >= starts[idx_c])
    return torch.bincount(idx_c[valid], minlength=k).to(torch.int32)


def hotness_histogram_ref(addrs: torch.Tensor, tbins: torch.Tensor,
                          base: int, n_blocks: int, n_tbins: int,
                          block_shift: int) -> torch.Tensor:
    """[time-bin × block] access hotness.

    addrs: int32[N] (512 B units); tbins: int32[N] pre-binned time indices.
    base: base address (512 B units); block granularity 2^block_shift
    units (2 MiB blocks = 4096 units → shift 12).  A record is dropped when
    its block ``(addr - base) >> block_shift`` (int32, arithmetic shift) is
    outside [0, n_blocks) or its time bin outside [0, n_tbins).
    Returns int32[n_tbins, n_blocks].
    """
    b = (addrs - base) >> block_shift
    valid = (b >= 0) & (b < n_blocks) & (tbins >= 0) & (tbins < n_tbins)
    flat = tbins[valid].long() * n_blocks + b[valid]
    hist = torch.bincount(flat, minlength=n_tbins * n_blocks)
    return hist.to(torch.int32).reshape(n_tbins, n_blocks)


def trace_aggregate_ref(addrs: torch.Tensor, tbins: torch.Tensor,
                        starts: torch.Tensor, ends: torch.Tensor, base: int,
                        n_blocks: int, n_tbins: int, block_shift: int):
    """Fused version: per-object counts AND the [time-bin × block] hotness
    map over the same trace columns."""
    return (object_histogram_ref(addrs, starts, ends),
            hotness_histogram_ref(addrs, tbins, base, n_blocks, n_tbins,
                                  block_shift))
