"""The benchmark's yardstick arithmetic: the model FLOPs of the layer
kinds, from which a configuration's reference (``configs/<name>.py``,
``step_flops``) counts a step; the bytes and operations one launch of a
trace kernel needs; and the table of peaks (``peaks.json``).

Model FLOPs count matrix-shaped work, two FLOPs a multiply-add, as the
port performs it:

* a linear layer, per token: 2 * d_in * d_out;
* causal attention, per sequence and layer: 2 * H * D * S**2 (the
  scores and the weighted sum, each over half of the S**2 pairs).

Embedding lookups, norms and activations are left out.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

PEAKS = Path(__file__).with_name("peaks.json")


def peaks(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name``, or None for a card the
    table does not have."""
    return json.loads(PEAKS.read_text()).get(device_name)


def attn_token(cfg) -> int:
    """An attention block's Q, K, V and output projections, per token."""
    d, q, kv = cfg.d_model, cfg.n_heads * cfg.head_dim, \
        cfg.n_kv_heads * cfg.head_dim
    return 2 * d * (q + 2 * kv) + 2 * q * d


def mlp_token(cfg) -> int:
    """A gated MLP's three projections, per token."""
    return 2 * 3 * cfg.d_model * cfg.d_ff


def head_token(cfg) -> int:
    """The output head, per token."""
    return 2 * cfg.d_model * cfg.vocab_size


def attn_sequence(cfg, seq: int) -> int:
    """Causal attention's scores and weighted sum, per sequence."""
    return 2 * cfg.n_heads * cfg.head_dim * seq * seq


def trace_launch_cost(n: int, k: int, cells: int) -> tuple:
    """(bytes, operations) that one launch of a trace kernel needs for
    ``n`` records (int32 addresses; with a hotness map, int32 time bins
    too), ``k`` objects (int32 starts and ends; int32 counts out) and a
    map of ``cells`` int32 cells (0 without one): each input read once,
    each output written once.  Operations: a binary search over the
    objects and one add for each record, one bin and add for the map."""
    read = 4 * n + 8 * k + (4 * n if cells else 0)
    written = 4 * k + 4 * cells
    ops = n * (math.ceil(math.log2(k + 1)) + 1) if k else 0
    if cells:
        ops += 2 * n
    return read + written, ops


def least_seconds(n: int, k: int, cells: int, peak: dict) -> float:
    """The least time of one trace-kernel launch on a card of ``peak``:
    bytes over HBM bandwidth, or operations over the INT32 rate where
    that is larger."""
    nbytes, ops = trace_launch_cost(n, k, cells)
    return max(nbytes / peak["hbm_bytes_per_s"], ops / peak["int32_ops_per_s"])
