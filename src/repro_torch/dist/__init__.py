"""``repro_torch.dist`` — the distribution subsystem on
``torch.distributed``.

Three orthogonal layers, consumed by models / trainer / the train launcher:

``sharding``
    Logical-axis rule table + process-global ``DeviceMesh`` registry.
    Model code annotates tensors with logical names ("p_embed", "seq_sp",
    "expert_ff", ...); :data:`~repro_torch.dist.sharding.DEFAULT_RULES`
    maps them to mesh dimensions (FSDP "data" × TP "model", optional
    "pod"), :func:`~repro_torch.dist.sharding.logical` resolves an
    annotation into DTensor placements (dropping absent / size-1 /
    non-dividing / duplicate dimensions), and
    :func:`~repro_torch.dist.sharding.shard` redistributes a DTensor to
    them — a no-op without a registered mesh.

``collectives``
    int8-compressed + async cross-pod gradient sync: ``quantize_int8`` /
    ``dequantize_int8``, ``plain_psum`` / ``compressed_psum`` (quantized
    reduce-scatter + all-gather, O(1) wire bytes in pod count), the
    bucketed async primitives ``psum_start`` / ``psum_wait``, and
    ``make_pod_sync(mesh, compressed=)`` over the "pod" dimension (the
    blocking baseline; the overlapped pipeline lives in
    ``repro_torch.train.trainer.make_overlapped_pod_sync``).

``pipeline``
    GPipe-style microbatch pipeline parallelism over a "pipe" dimension
    (a ``batch_isend_irecv`` ring whose backward is the reverse ring;
    numerics match sequential execution).
"""

from . import collectives, pipeline, sharding
from .collectives import (PsumHandle, compressed_psum, dequantize_int8,
                          make_pod_sync, plain_psum, psum_start, psum_wait,
                          quantize_int8)
from .pipeline import make_pipelined_fn
from .sharding import (DEFAULT_RULES, ShardingRules, get_mesh, get_rules,
                       logical, mesh_axis_size, set_mesh, shard)

__all__ = [
    "collectives", "pipeline", "sharding",
    "DEFAULT_RULES", "ShardingRules", "get_mesh", "get_rules", "logical",
    "mesh_axis_size", "set_mesh", "shard",
    "quantize_int8", "dequantize_int8", "plain_psum", "compressed_psum",
    "PsumHandle", "psum_start", "psum_wait",
    "make_pod_sync", "make_pipelined_fn",
]
