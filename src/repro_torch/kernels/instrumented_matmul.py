"""Instrumented compute kernel — in-kernel device-side event recording.

Table II's fine-grained tier (thread-block entry/exit, per-access events) is
reached by *opt-in kernel instrumentation*: the kernel itself writes records
to a trace buffer on the device as it runs (paper Fig. 2b: produce events
where the data is).

:func:`matmul_traced` is a blocked matmul that writes, per 128×128 output
tile (i, j), one record ``[block_i, block_j, bytes_read, bytes_written]``
into a trace that stays on the device; ``handler.trace_buffer`` then hands
it to the PASTA processor.  On a CUDA tensor it launches the hand-written
Hopper kernel ``csrc/instrumented_matmul.cu`` or raises; on a CPU tensor it
runs the plain version :func:`matmul_traced_ref`.  Each launch adds one to
``ops.launches["instrumented_matmul"]`` and one to ``bodies[<body>]``, the
body :func:`_plan` picked: ``"wgmma"`` (tensor cores fed by TMA, K split
over a cluster when the tiles are too few to fill the card) or ``"simt"``
(float32 FMA, the body of float32 operands).  The simt body is bound by its
operations (2·M·N·K at 67 TFLOP/s of float32); :func:`_simt_plan` splits
its K where the tiles leave SMs idle, the partials summed in split order by
a second kernel of the same launch (so two calls give the same bits), and
names its loader: ``"async"`` (a ring of ``cp.async`` stages) where both
operands' rows can be described in 16 bytes, else ``"scalar"``.
"""

from __future__ import annotations

import ctypes

import torch

from . import build, ops
from .ops import _launch

BM = 128
BN = 128
BK = 64                        # K depth of one stage of the wgmma body
SPLITS = (8, 4, 2, 1)          # cluster sizes of the split-K wgmma body
SIMT_BK = 32                   # K depth of one stage of the simt body
LOADERS = ("scalar", "async")  # the simt body's loaders, by the C entry's index
_DTYPES = (torch.float32, torch.bfloat16)
#: body -> launches, reset by ops.reset_launches
bodies = ops.bodies
_resident_cache: dict = {}     # device index -> {split: clusters held at once}


def _plan(m: int, k: int, n: int, dtype: torch.dtype, resident: dict,
          aligned: bool = True):
    """(body, split) of a product; ``resident[S]`` is how many clusters of
    S blocks of the wgmma body the card holds at once (:func:`_resident`).

    ``"simt"`` for float32 operands (the tensor cores would round them to
    TF32), for bf16 with K not a multiple of 8 or not 16-byte aligned
    operands (TMA cannot describe those rows) and for K = 0; its own split
    and loader come from :func:`_simt_plan`.  Otherwise
    ``"wgmma"`` with K split S ways: the largest S of SPLITS whose
    clusters, one per output tile, the card holds all at once and that
    leaves no split without a K slab of its own; S = 1 when none does."""
    if dtype != torch.bfloat16 or k % 8 or not k or not aligned:
        return "simt", 1
    tiles = (m // BM) * (n // BN)
    for s in SPLITS[:-1]:
        if tiles <= resident[s] and all(a < b for a, b in _slabs(k, s)):
            return "wgmma", s
    return "wgmma", 1


def _slabs(k: int, split: int) -> list:
    """[first, last) K slab of each of the ``split`` blocks of a tile, as
    the wgmma body computes them: an even share of ceil(K / BK) slabs."""
    slabs = -(-k // BK)
    per = -(-slabs // split)
    return [(min(slabs, r * per), min(slabs, r * per + per))
            for r in range(split)]


def _simt_plan(m: int, k: int, n: int, sms: int, dtype: torch.dtype,
               aligned: bool = True):
    """(split, loader) of a product on the simt body, on a card of ``sms``
    SMs.

    The split S is the smallest that gives the card at least 90% of one
    wave of blocks, tiles · S ≥ 0.9 · sms, where the tiles alone leave more
    than half the SMs idle; S = 1 where they do not (S = 2 would then need a
    second wave, as long as the first: no gain for the partials' bytes) and
    where K has fewer SIMT_BK slabs than S (a product that small cannot
    fill the card).  ``"async"`` where both operands' rows can be described
    in 16 bytes: float32, K a multiple of 4, both operands 16-byte aligned;
    ``"scalar"`` otherwise."""
    loader = "async" if (dtype == torch.float32 and k % 4 == 0
                         and aligned) else "scalar"
    tiles = (m // BM) * (n // BN)
    split = 1
    if 0 < 2 * tiles <= sms:
        need = -(-9 * sms // 10)               # ceil(0.9 * sms) blocks
        split = -(-need // tiles)
        if split > -(-k // SIMT_BK):
            split = 1
    return split, loader


def _simt_slabs(k: int, split: int) -> list:
    """[first, last) K slab of each of the ``split`` blocks of a tile, as
    the simt body computes them: slabs ``z·slabs/S`` to ``(z+1)·slabs/S``
    of ceil(K / SIMT_BK), none empty while S ≤ slabs."""
    slabs = -(-k // SIMT_BK)
    return [(z * slabs // split, (z + 1) * slabs // split)
            for z in range(split)]


def _resident(dev: torch.device) -> dict:
    """{split: clusters of the wgmma body the card holds at once}, asked
    of the CUDA occupancy API once per device."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    if index not in _resident_cache:
        fn = build.load("instrumented_matmul").instrumented_matmul_resident
        fn.argtypes = [ctypes.c_int, ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        held = {}
        for s in SPLITS:
            count = ctypes.c_int(0)
            err = fn(index, s, ctypes.byref(count))
            if err:
                raise RuntimeError(f"instrumented_matmul: occupancy query "
                                   f"for clusters of {s} failed ({err})")
            held[s] = count.value
        _resident_cache[index] = held
    return _resident_cache[index]


def _simt_info(dev: torch.device, dtype: torch.dtype, loader: str) -> dict:
    """What the compiler and the occupancy API say of the simt body's
    instance for ``dtype`` and ``loader`` on this card."""
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    fn = build.load("instrumented_matmul").instrumented_matmul_simt_info
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    err = fn(index, int(dtype == torch.bfloat16), LOADERS.index(loader), info)
    if err:
        raise RuntimeError(f"instrumented_matmul: simt query failed ({err})")
    return dict(zip(("registers", "spill_bytes", "smem_bytes",
                     "blocks_per_sm"), info))


def _shapes(x: torch.Tensor, w: torch.Tensor):
    """(m, k, n) of a valid product; raises on what no path takes."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"matmul_traced: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} do not chain")
    m, k = x.shape
    n = w.shape[1]
    if m % BM or n % BN:
        raise ValueError(f"matmul_traced: M={m} and N={n} must be multiples "
                         f"of {BM} (one record per {BM}x{BN} output tile)")
    if x.dtype != w.dtype or x.dtype not in _DTYPES:
        raise ValueError(f"matmul_traced: operands {x.dtype} and {w.dtype}; "
                         "both must be float32 or both bfloat16")
    if x.device != w.device:
        raise ValueError(f"matmul_traced: operands on {x.device} and "
                         f"{w.device}")
    return m, k, n


def _record_bytes(k: int, x: torch.Tensor, w: torch.Tensor):
    """(bytes_read, bytes_written) of one output tile."""
    return BM * k * x.itemsize + k * BN * w.itemsize, BM * BN * 4


def matmul_traced(x: torch.Tensor, w: torch.Tensor):
    """(M,K)@(K,N) with an on-device access-record trace.

    Returns (out f32[M,N], trace int32[M/128 * N/128, 4]); row
    ``i * (N/128) + j`` of the trace is ``[i, j, bytes_read,
    bytes_written]`` of output tile (i, j)."""
    m, k, n = _shapes(x, w)
    if x.device.type == "cpu":
        return matmul_traced_ref(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"matmul_traced: no kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("matmul_traced: operands must be contiguous")
    br, bw = _record_bytes(k, x, w)
    if br >= 2**31 or m // BM >= 2**16:
        raise ValueError(f"matmul_traced: K={k} or M={m} too large for the "
                         "int32 record and the grid")
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    body, split = _plan(m, k, n, x.dtype, _resident(x.device), aligned)
    loader, workspace = "scalar", None
    if body == "simt":
        split, loader = _simt_plan(m, k, n, ops._sms(x.device), x.dtype,
                                   aligned)
        if split > 1:
            # the partials, ordered by the caching allocator on this stream
            workspace = torch.empty((split, m, n), dtype=torch.float32,
                                    device=x.device)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    trace = torch.empty((m // BM * (n // BN), 4), dtype=torch.int32,
                        device=x.device)
    _launch("instrumented_matmul", x.device, x.data_ptr(), w.data_ptr(),
            out.data_ptr(), trace.data_ptr(),
            workspace.data_ptr() if workspace is not None else None, m, k, n,
            int(x.dtype == torch.bfloat16), int(body == "wgmma"), split,
            LOADERS.index(loader), br, bw)
    bodies[body] += 1
    return out, trace


def matmul_traced_ref(x: torch.Tensor, w: torch.Tensor):
    """Plain version: float32 matmul + analytically derived trace."""
    m, k, n = _shapes(x, w)
    gi, gj = m // BM, n // BN
    ij = torch.stack(torch.meshgrid(torch.arange(gi), torch.arange(gj),
                                    indexing="ij"), -1).reshape(-1, 2)
    br, bw = _record_bytes(k, x, w)
    trace = torch.cat([ij.to(torch.int32),
                       torch.full((gi * gj, 1), br, dtype=torch.int32),
                       torch.full((gi * gj, 1), bw, dtype=torch.int32)],
                      dim=1).to(x.device)
    return x.float() @ w.float(), trace
