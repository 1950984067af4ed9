"""Capture of one compiled step — the port's counterpart of
``repro/core/hlo.py``.

The reference walks a compiled XLA executable's HLO text and rolls its
instructions up into :class:`HloStats`.  A torch step has no such text, so
the port profiles one real call of the step and rolls up what ran:

* **kernel records** — on the card, the device kernels that
  ``torch.profiler`` records with CUDA activity (their names and launch
  counts: the paper's CUPTI tier); on the CPU, which has no kernels, the
  leaf aten operators (views left out, as the reference leaves out its
  free opcodes);
* **bytes** — each kernel carries the operand and result bytes of the aten
  operator that launched it, recorded by a ``TorchDispatchMode`` over the
  same call (the reference's ``_instr_hbm_bytes`` counts a fusion's
  operands and outputs the same way); an operator that launches several
  kernels gives its bytes to the first, so the step's ``hbm_bytes`` is the
  sum over operators;
* **FLOPs** — ``torch.utils.flop_counter.FlopCounterMode`` over the same
  call (matmuls, convolutions, attention), plus one FLOP per output element
  of each pointwise operator, the reference's rule for elementwise
  opcodes;
* **collectives** — the NCCL kernels, by name, with the reference's wire
  bytes.  One device has none.

The model's operator hooks stay silent during the call, as the reference's
do while XLA traces the step.

A profiled run has real trip counts, so ``analyze``'s ``default_trip`` is
accepted for the reference's signature and unused.
"""

from __future__ import annotations

import dataclasses
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .instrument import capturing

#: name prefix of the profiler ranges that tie a kernel to its operator
_TAG = "pasta.op#"

#: CUDA API calls that put one operation on the device
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaMemcpyAsync",
                 "cudaMemsetAsync")

#: NCCL kernel-name fragment -> the reference's collective opcode
_NCCL_OPCODES = (("AllReduce", "all-reduce"), ("AllGather", "all-gather"),
                 ("ReduceScatter", "reduce-scatter"),
                 ("Broadcast", "collective-permute"),
                 ("SendRecv", "collective-permute"))


@dataclasses.dataclass
class OpRecord:
    """One aten operator of the captured call."""
    name: str                 # schema name, e.g. "aten::mm"
    in_bytes: int
    out_bytes: int
    is_view: bool
    pointwise: bool
    out_numel: int


@dataclasses.dataclass
class StepArtifact:
    """What one profiled call of a step leaves behind."""
    device: str                              # "cuda" or "cpu"
    ops: list                                # OpRecord per aten call
    launches: list                           # (kernel, op index or -1)
    matmul_flops: float
    seconds: float                           # wall time of the call
    result: object = None                    # what the call returned
    lost: int = 0                            # launches without a record


@dataclasses.dataclass
class CaptureStats:
    """The reference's ``HloStats`` schema, from a profiled step."""
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: dict = dataclasses.field(default_factory=dict)
    collective_wire_bytes: dict = dataclasses.field(default_factory=dict)
    collective_instances: list = dataclasses.field(default_factory=list)
    kernel_counts: dict = dataclasses.field(default_factory=dict)
    kernel_meta: dict = dataclasses.field(default_factory=dict)
    hw: dict = dataclasses.field(default_factory=dict)
    warnings: dict = dataclasses.field(default_factory=dict)


def collective_wire_bytes(opcode: str, op_bytes: float, out_bytes: float,
                          group_size: int | None) -> float:
    """Per-device *wire* bytes of one collective — what actually crosses the
    interconnect, unlike the raw operand-bytes proxy.  Ring algorithms:
    all-reduce moves ~2× payload, all-gather / reduce-scatter move the
    shards they receive / retire, all-to-all keeps (N−1)/N of the payload
    on the wire."""
    frac = (group_size - 1) / group_size if group_size else 1.0
    if opcode == "all-gather":
        return max(out_bytes - op_bytes, 0.0)
    if opcode == "reduce-scatter":
        return max(op_bytes - out_bytes, 0.0)
    if opcode == "all-reduce":
        return 2.0 * op_bytes * frac
    if opcode in ("all-to-all", "ragged-all-to-all"):
        return op_bytes * frac
    return float(op_bytes)          # collective-permute / broadcast


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


class _OpRecorder(TorchDispatchMode):
    """Records every aten call (bytes, view-ness, pointwise-ness); with
    ``tag`` set, wraps each in a profiler range named after its index."""

    def __init__(self, tag: bool):
        super().__init__()
        self.tag = tag
        self.ops: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        i = len(self.ops)
        if self.tag:
            with torch.profiler.record_function(f"{_TAG}{i}"):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        self.ops.append(OpRecord(
            name=func._schema.name, in_bytes=_bytes((args, kwargs)),
            out_bytes=_bytes(outs), is_view=func.is_view,
            pointwise=torch.Tag.pointwise in func.tags,
            out_numel=sum(t.numel() for t in outs)))
        return out


def _device_launches(prof):
    """``(launches, lost)``: (kernel name, op index or -1) per device
    operation (kernels, copies, fills), in the order their launching CPU
    events start; and the launch calls of the CUDA API whose correlation
    id has no device record (the profiler lost them).  The profiler files
    each device operation under the innermost CPU event that launched it;
    the operator's index is the nearest enclosing ``_TAG`` range."""
    events = prof.events()
    out = []
    cpu = sorted((e for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.kernels), key=lambda e: e.time_range.start)
    for e in cpu:
        parent, idx = e, -1
        while parent is not None:
            if parent.name.startswith(_TAG):
                idx = int(parent.name[len(_TAG):])
                break
            parent = parent.cpu_parent
        out.extend((k.name, idx) for k in e.kernels)
    recorded = {e.id for e in events
                if e.device_type == torch.autograd.DeviceType.CUDA}
    lost = sum(1 for e in events
               if e.device_type == torch.autograd.DeviceType.CPU
               and e.name.startswith(_LAUNCH_CALLS) and e.id not in recorded)
    return out, lost


def capture_step(fn, *args, **kwargs) -> StepArtifact:
    """Run ``fn(*args, **kwargs)`` once and return its artifact.

    The step runs where its tensors lie: on the card when a CUDA tensor is
    among the arguments or there is no tensor among them (a closure), else
    on the CPU.  On the card the call runs under ``torch.profiler`` with
    CUDA activity and the records are the device kernels; on the CPU they
    are the leaf aten operators."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    tensors = [t for t in tree_leaves((args, kwargs))
               if isinstance(t, torch.Tensor)]
    card = not tensors or any(t.is_cuda for t in tensors)
    rec = _OpRecorder(tag=card)
    flops = FlopCounterMode(display=False)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) \
        if card else None
    if card:
        torch.cuda.synchronize()
        prof.start()
    t0 = time.perf_counter()
    try:
        with capturing(), flops, rec:
            result = fn(*args, **kwargs)
        if card:
            torch.cuda.synchronize()
    finally:
        seconds = time.perf_counter() - t0
        if card:
            prof.stop()
    lost = 0
    if card:
        launches, lost = _device_launches(prof)
    else:
        launches = [(op.name, i) for i, op in enumerate(rec.ops)
                    if not op.is_view]
    return StepArtifact(device="cuda" if card else "cpu", ops=rec.ops,
                        launches=launches,
                        matmul_flops=float(flops.get_total_flops()),
                        seconds=seconds, result=result, lost=lost)


def _default_hw() -> dict:
    from .tools.roofline import H100
    return H100


def _nccl_opcode(name: str):
    if "nccl" not in name.lower():
        return None
    return next((op for frag, op in _NCCL_OPCODES if frag in name),
                "collective-permute")


def analyze(artifact: StepArtifact, default_trip: int = 1,
            hw: dict | None = None) -> CaptureStats:
    """Roll a captured step up into the reference's ``HloStats`` fields.

    Kernels are keyed ``"<name>.<i>"``, one key per distinct (kernel,
    operator, bytes), in first-launch order — as HLO instruction names are
    (``fusion.12``), so the kernel_freq tool folds them back onto the
    kernel's name.  ``default_trip`` is unused: the profiled call ran its
    real trip counts."""
    del default_trip
    stats = CaptureStats(hw=dict(hw if hw is not None else _default_hw()))
    stats.flops = artifact.matmul_flops + float(sum(
        op.out_numel for op in artifact.ops if op.pointwise))
    group = (torch.distributed.get_world_size()
             if torch.distributed.is_available()
             and torch.distributed.is_initialized() else None)
    keys: dict = {}
    per_name: dict = {}
    seen_ops: set = set()
    for name, idx in artifact.launches:
        op = artifact.ops[idx] if idx >= 0 else None
        op_name = op.name if op is not None else ""
        coll = _nccl_opcode(name)
        if coll is not None:
            op_b = op.in_bytes if op is not None else 0
            out_b = op.out_bytes if op is not None else 0
            wire = collective_wire_bytes(coll, op_b, out_b, group)
            stats.collective_bytes[coll] = \
                stats.collective_bytes.get(coll, 0.0) + op_b
            stats.collective_wire_bytes[coll] = \
                stats.collective_wire_bytes.get(coll, 0.0) + wire
            # a profiled run measures overlap rather than models it: no
            # hidden time is credited
            stats.collective_instances.append({
                "opcode": coll, "name": name, "bytes": op_b, "mult": 1.0,
                "group_size": group, "wire_bytes": wire, "op_name": op_name,
                "hidden_s": 0.0, "exposed_bytes": wire,
                "overlapped": False})
            continue
        # an operator's bytes go to the first kernel it launches
        nbytes = 0
        if op is not None and idx not in seen_ops:
            seen_ops.add(idx)
            nbytes = op.in_bytes + op.out_bytes
        sig = (name, op_name, nbytes)
        key = keys.get(sig)
        if key is None:
            n = per_name[name] = per_name.get(name, -1) + 1
            key = keys[sig] = f"{name}.{n}"
            stats.kernel_meta[key] = {"opcode": name, "op_name": op_name,
                                      "bytes": nbytes}
        stats.kernel_counts[key] = stats.kernel_counts.get(key, 0) + 1
        stats.hbm_bytes += nbytes
    if not artifact.launches:
        stats.warnings["no-kernels"] = 1
    if artifact.lost:
        stats.warnings["lost-device-records"] = artifact.lost
    return stats
