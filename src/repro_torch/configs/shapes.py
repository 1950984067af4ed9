"""Assigned input shapes (per-arch cells = arch × shape).

``decode_*`` / ``long_*`` trace ``decode_step`` (one new token against a
KV/SSM cache of ``seq_len``); ``train_*`` trace ``train_step``;
``prefill_*`` trace ``prefill_step``.  ``long_500k`` requires
sub-quadratic attention: it runs for ssm/hybrid archs and is skipped
(recorded, not hidden) for pure full-attention archs per the assignment.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Shape:
    name: str
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1  # grad-accum microbatches (train only)


SHAPES = {
    "train_4k": Shape("train_4k", "train", 4096, 256, microbatches=8),
    "prefill_32k": Shape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Shape("decode_32k", "decode", 32768, 128),
    "long_500k": Shape("long_500k", "decode", 524288, 1),
}


def get_shape(name: str) -> Shape:
    return SHAPES[name]


def cells_for(cfg) -> list:
    """All (shape) names applicable to an arch config."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.supports_long_context:
        out.append("long_500k")
    return out
