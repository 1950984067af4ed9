"""Step traces — the static counterpart of ``repro/core/hlo.py``.

The reference lowers a step and walks the compiled HLO; a torch step has
no compiled text.  :func:`trace_step` instead runs the step once under
``FakeTensorMode`` (shapes and dtypes, no storage, nothing executed) on a
fake process group of the mesh's size, and records every aten call one
device would make: the local ops of each DTensor op (the DTensor op
itself is let through to DTensor's own dispatch, so implicit
redistributions show up as the collectives they issue), and the
collectives with their groups and waits.  :func:`analyze_trace` rolls the
records up into the reference's ``HloStats`` schema
(:class:`~repro_torch.core.capture.CaptureStats`) with the reference's
overlap model; ``core/capture.py`` stays the dynamic counterpart.

A record carries what the lint passes need: schema name, input and output
shapes, dtypes and storage ids (def-use and liveness), whether each input
is rooted at a parameter, and for a collective the reference's opcode,
its group's ranks, the mesh axes they span and the index of its wait.

Trip counts.  Running every DTensor op costs host time, so a full-depth,
many-microbatch production cell is cut: a loop written
``for i in trace.loop("layers", n)`` runs ``k < n`` iterations under a
trace that cuts it (``cuts={"layers": k}``), and each record of those
iterations — forward ops by the loop they run in, backward ops by the loop
their autograd node was created in — carries ``mult = n / k``: the
reference's ``mult`` field.  The cut is stated in the trace
(``layers_traced``, ``microbatches_traced``).
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re
import sys
import time
import warnings
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_leaves, tree_map

from .capture import (CaptureStats, collective_wire_bytes,
                      indexed_write_bytes)

#: dispatched collectives -> the reference's opcode: DTensor's
#: redistributions (functional collectives; a shard-to-shard move on a
#: non-CPU mesh is ``_dtensor.shard_dim_alltoall``, on a CPU mesh an
#: all-gather and a chunk) and the c10d calls of ``dist.collectives``
_COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": "all-gather",
    "_c10d_functional.reduce_scatter_tensor": "reduce-scatter",
    "_c10d_functional.all_reduce": "all-reduce",
    "_dtensor.shard_dim_alltoall": "all-to-all",
    "c10d.allreduce_": "all-reduce",
    "c10d._allgather_base_": "all-gather",
    "c10d._reduce_scatter_base_": "reduce-scatter",
    "c10d.alltoall_base_": "all-to-all",
}
_WAIT = "_c10d_functional.wait_tensor"
_FRAME_RE = re.compile(r'File "([^"]+)", line \d+, in (\S+)')
#: c10d ops whose first argument is a separate output buffer
_C10D_OUT_FIRST = {"c10d._allgather_base_", "c10d._reduce_scatter_base_",
                   "c10d.alltoall_base_"}

#: ops a value passes through and stays "the same value" for parameter
#: provenance: layout and dtype changes (the reference's
#: ``_PROVENANCE_CHAIN``: convert, bitcast, reshape, copy, transpose,
#: slice)
_CHAIN = {"aten._to_copy", "aten.clone", "aten.copy_", "aten.copy",
          "aten.contiguous", "aten.alias", "aten.lift_fresh",
          "aten._unsafe_view", "aten.detach", "aten.split",
          "aten.split_with_sizes", "aten.chunk", "aten.unbind"}

#: data-dependent-shape ops: the recorder sizes their output at the most
#: it could be and records a host sync
_DATA_DEPENDENT = {"aten.nonzero", "aten.masked_select"}

_HLO_DTYPE = {torch.float32: "f32", torch.float64: "f64",
              torch.bfloat16: "bf16", torch.float16: "f16",
              torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
              torch.int32: "s32", torch.int64: "s64", torch.bool: "pred",
              torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2"}


def hlo_dtype(dtype: torch.dtype) -> str:
    """The reference's HLO name of a torch dtype (``torch.bfloat16`` ->
    ``"bf16"``)."""
    return _HLO_DTYPE.get(dtype, str(dtype).replace("torch.", ""))


@dataclasses.dataclass
class TraceRecord:
    """One aten call of the traced step, as one device makes it."""
    op: str                       # overload, e.g. "aten.mm.default"
    name: str = ""                # schema name, e.g. "aten::mm"
    in_shapes: tuple = ()
    in_dtypes: tuple = ()         # HLO dtype names ("bf16", "f32", ...)
    out_shapes: tuple = ()
    out_dtypes: tuple = ()
    in_ids: tuple = ()            # storage id per tensor input
    out_ids: tuple = ()           # storage id per tensor output
    in_bytes: int = 0
    out_bytes: int = 0
    flops: float = 0.0            # matmul-class FLOPs (flop_counter rules)
    is_view: bool = False
    pointwise: bool = False
    out_numel: int = 0
    param_rooted: tuple = ()      # per tensor input
    mult: float = 1.0             # trip multiplier of a cut loop
    op_name: str = ""             # "module.function" that issued it
    backward: bool = False        # run by the autograd engine
    opcode: str = ""              # the reference's collective opcode
    group: tuple = ()             # this device's group's ranks
    axes: tuple | None = None     # mesh axes the groups span (sorted)
    crosses_pods: bool = False
    wait: int | None = None       # index of the record that waits for it
    is_wait: bool = False
    host_sync: str = ""           # "item", "data-dependent", "d2h"

    @property
    def base(self) -> str:
        """The overload packet, e.g. ``"aten.mm"``."""
        return self.op.rsplit(".", 1)[0] if self.op.count(".") >= 2 \
            else self.op

    @property
    def is_collective(self) -> bool:
        return bool(self.opcode)


@dataclasses.dataclass
class StepTrace:
    """One traced call of a step."""
    records: list = dataclasses.field(default_factory=list)
    mesh_axes: dict = dataclasses.field(default_factory=dict)
    n_devices: int = 1
    device_type: str = "cuda"
    #: storage id -> bytes, for every storage the trace saw
    storage_bytes: dict = dataclasses.field(default_factory=dict)
    #: storages that existed before the call (the arguments)
    persistent: set = dataclasses.field(default_factory=set)
    #: storages the call returned
    outputs: set = dataclasses.field(default_factory=set)
    #: (dtype, shape, storage id) of each argument and result leaf
    arg_leaves: list = dataclasses.field(default_factory=list)
    out_leaves: list = dataclasses.field(default_factory=list)
    #: loop iterations as (name, first record, end record, mult)
    iterations: list = dataclasses.field(default_factory=list)
    #: the step's marked regions as (name, first record, end record)
    regions: list = dataclasses.field(default_factory=list)
    #: the live-storage high-water mark of the fake run itself (bytes)
    measured_peak_bytes: float = 0.0
    layers_traced: int | None = None
    layers_total: int | None = None
    microbatches_traced: int | None = None
    microbatches_total: int | None = None
    seconds: float = 0.0
    result: object = None

    @property
    def pods(self) -> int:
        return int(self.mesh_axes.get("pod", 1))


# ---------------------------------------------------------------------------
# hooks the port's code calls (no-ops when no trace is active)
# ---------------------------------------------------------------------------

_ACTIVE = None          # the recording _Recorder, if any


@contextlib.contextmanager
def scope(name: str):
    """Name the collectives issued inside (the pod sync's
    ``psum_start``/``psum_wait``): the counterpart of the JAX primitive
    name the reference reads from an instruction's ``op_name``."""
    rec = _ACTIVE
    if rec is None or rec.paused:
        yield
        return
    rec.scopes.append(name)
    try:
        yield
    finally:
        rec.scopes.pop()


@contextlib.contextmanager
def region(name: str):
    """Mark the records issued inside as the step's region ``name`` (the
    train step's ``"update"``, which the peak estimate reads)."""
    rec = _ACTIVE
    if rec is None or rec.paused:
        yield
        return
    first = len(rec.records)
    try:
        yield
    finally:
        rec.regions.append((name, first, len(rec.records)))


def mark_wait(*tensors) -> None:
    """Record the wait of an async c10d collective whose output is among
    ``tensors`` (``Work.wait()`` is not a dispatched op)."""
    rec = _ACTIVE
    if rec is not None:
        rec.wait_for(tensors)


def loop(name: str, n: int):
    """``range(n)`` — or, under a trace that cuts loop ``name`` to ``k``,
    ``range(min(k, n))`` with each record of those iterations scaled by
    ``n / min(k, n)``."""
    rec = _ACTIVE
    if rec is None:
        return range(n)
    if name not in rec.cuts:
        rec.seen[name] = (n, n)
        return range(n)
    rec.seen[name] = (max(1, min(int(rec.cuts[name]), n)), n)
    return rec.loop(name, n)


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):
        return None


def _site(frames) -> str:
    """``module.function`` of the innermost of ``frames`` (``(file,
    function)`` pairs, innermost first) in the port's code outside
    ``dist/`` and ``core/trace``; a ``dist/`` frame when there is no
    other; ``""`` when none is the port's."""
    fallback = ""
    for fn, name in frames:
        fn = fn.replace("\\", "/")
        if "/repro_torch/" not in fn or fn.endswith("core/trace.py"):
            continue
        here = f"{fn.rsplit('/', 1)[-1][:-3]}.{name}"
        if "/repro_torch/dist/" not in fn:
            return here
        fallback = fallback or here
    return fallback


def _caller() -> str:
    """The port's code that issued the current op: the Python stack for a
    forward op; for a backward op, the stack that created its autograd
    node (kept by anomaly mode while a trace records), plus
    ``"/backward"``."""
    node = torch._C._current_autograd_node()
    if node is not None:
        tb = node.metadata.get("traceback_") or []
        frames = []
        for line in reversed(tb):
            m = _FRAME_RE.search(line)
            if m:
                frames.append((m.group(1), m.group(2)))
        return (_site(frames) or "step") + "/backward"
    f = sys._getframe(2)
    frames = []
    while f is not None:
        frames.append((f.f_code.co_filename, f.f_code.co_name))
        f = f.f_back
    return _site(frames)


class _Recorder(TorchDispatchMode):
    """Records the local aten calls of one device (DTensor ops are let
    through to DTensor, whose local ops come back here)."""

    def __init__(self, mesh, cuts: dict):
        super().__init__()
        self.cuts = dict(cuts or {})
        self.seen: dict = {}         # loop name -> (traced, total)
        self.records: list = []
        self.scopes: list = []
        self.ids: dict = {}          # storage _cdata -> id
        self.nbytes: dict = {}       # id -> bytes
        self.live: dict = {}         # id -> live tensor count
        self.tracked: set = set()    # id(tensor) already tracked
        self.live_bytes = 0.0
        self.peak = 0.0
        self.param_ids: set = set()
        self.rooted: set = set()     # param-rooted storage ids
        self.pending: dict = {}      # storage id -> async collective index
        self.mults: list = [1.0]     # stack of loop multipliers
        self.loops: list = [(1, 1)]  # stack of (n, k) of the cut loops
        self.param_shapes: set = set()
        # autograd sequence numbers where a loop iteration starts or a loop
        # ends, and the (mult, (n, k)) of the nodes made from there on
        self.seq_marks: list = []
        self.seq_mults: list = []
        self.iterations: list = []
        self.regions: list = []
        self.paused = False
        self._groups: dict = {}
        self.names, self.sizes, self.coords = [], [], {}
        if mesh is not None:
            import itertools
            self.names = list(mesh.mesh_dim_names or ())
            self.sizes = [int(x) for x in mesh.shape]
            ranks = mesh.mesh.reshape(-1).tolist()
            for r, c in zip(ranks, itertools.product(
                    *(range(x) for x in self.sizes))):
                self.coords[int(r)] = c
        from torch.distributed.tensor import DTensor
        self._dtensor = DTensor

    # ------------------------------------------------------------ storages
    def sid(self, t: torch.Tensor) -> int:
        """The id of ``t``'s storage (a new one at first sight), tracking
        the live tensors on it for the high-water mark."""
        st = _storage(t)
        if st is None:
            return -1
        key = st._cdata
        i = self.ids.get(key)
        if i is None:
            i = len(self.nbytes)
            self.ids[key] = i
            self.nbytes[i] = int(st.nbytes())
            self.live[i] = 0
            self.live_bytes += self.nbytes[i]
            self.peak = max(self.peak, self.live_bytes)
        if id(t) not in self.tracked:
            self.tracked.add(id(t))
            self.live[i] += 1
            weakref.finalize(t, self._release, i, key, id(t))
        return i

    def _release(self, i: int, key: int, tid: int) -> None:
        self.tracked.discard(tid)
        self.live[i] -= 1
        if self.live[i] == 0:
            self.live_bytes -= self.nbytes[i]
            if self.ids.get(key) == i:
                del self.ids[key]

    # --------------------------------------------------------------- loops
    def _seq_nr(self) -> int:
        """The autograd sequence number the next node will take."""
        from torch.utils._python_dispatch import _disable_current_modes
        with _disable_current_modes(), torch.enable_grad():
            probe = torch.zeros((), requires_grad=True)
            return probe.mul(1).grad_fn._sequence_nr() + 1

    def _mark(self) -> None:
        self.seq_marks.append(self._seq_nr())
        self.seq_mults.append((self.mults[-1], self.loops[-1]))

    def loop(self, name: str, n: int):
        k = max(1, min(int(self.cuts[name]), n))
        m = n / k
        if self.paused:
            yield from range(k)
            return
        self.mults.append(self.mults[-1] * m)
        self.loops.append((n, k))
        try:
            for i in range(k):
                self._mark()
                first = len(self.records)
                yield i
                self.iterations.append((name, first, len(self.records), m))
        finally:
            self.mults.pop()
            self.loops.pop()
            self._mark()

    def current_mult(self, base: str, outs) -> tuple:
        """``(mult, backward)`` of the op being recorded: a forward op's
        from the cut loops it runs in, a backward op's from those its
        autograd node was created in.  The autograd engine sums the
        gradients a tensor read by every iteration of a cut loop receives
        (a stacked weight, the hybrid's shared block): ``n - 1`` sums for
        ``n`` iterations, so ``(n - 1) / (k - 1)`` for ``k`` traced."""
        node = torch._C._current_autograd_node()
        if node is None:
            return self.mults[-1], False
        seq = node._sequence_nr()
        j = bisect.bisect_right(self.seq_marks, seq) - 1
        if j < 0:
            return 1.0, True
        mult, (n, k) = self.seq_mults[j]
        if k > 1 and base in ("aten.add", "aten.add_") and outs \
                and tuple(outs[0].shape) in self.param_shapes:
            mult = mult / (n / k) * ((n - 1) / (k - 1))
        return mult, True

    # --------------------------------------------------------- collectives
    def _group(self, pg_arg) -> tuple:
        """The ranks of a collective's group: a group name (functional
        collectives) or a boxed ``ProcessGroup`` (c10d ops)."""
        import torch.distributed as dist
        from torch.distributed import ProcessGroup
        from torch.distributed.distributed_c10d import _resolve_process_group
        if isinstance(pg_arg, str):
            key = pg_arg
        else:
            pg = pg_arg if isinstance(pg_arg, ProcessGroup) \
                else ProcessGroup.unbox(pg_arg)
            key = pg.group_name
        if key not in self._groups:
            self._groups[key] = tuple(dist.get_process_group_ranks(
                _resolve_process_group(key)))
        return self._groups[key]

    def _axes(self, group: tuple):
        """``group_axes`` of every group of the same split as ``group``."""
        if not self.coords or not group:
            return None, False
        cs = [self.coords[r] for r in group]
        vary = {d for d in range(len(self.sizes))
                if len({c[d] for c in cs}) > 1}
        groups: dict = {}
        for r, c in sorted(self.coords.items()):
            key = tuple(x for d, x in enumerate(c) if d not in vary)
            groups.setdefault(key, []).append(r)
        return group_axes(list(groups.values()),
                          dict(zip(self.names, self.sizes)))

    def wait_for(self, tensors) -> None:
        if self.paused:
            return
        for t in tree_leaves(tensors):
            if not isinstance(t, torch.Tensor):
                continue
            s = self.sid(t)
            j = self.pending.pop(s, None)
            if j is None:
                continue
            i = len(self.records)
            self.records.append(TraceRecord(
                op="c10d.wait", name="c10d::wait", in_ids=(s,),
                is_wait=True, mult=self.records[j].mult,
                op_name=self.records[j].op_name))
            self.records[j].wait = i

    # ------------------------------------------------------------ dispatch
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._dtensor) for t in types):
            return NotImplemented          # DTensor's dispatch, then back
        if self.paused or func.namespace == "prim":
            return func(*args, **kwargs)
        base = str(func.overloadpacket)
        if base in ("aten._local_scalar_dense", "aten.item"):
            return self._host_scalar(func, args, kwargs)
        try:
            out = func(*args, **kwargs)
            sync = ""
        except Exception as e:                              # noqa: BLE001
            if base not in _DATA_DEPENDENT:
                raise
            out = _upper_bound(base, args)
            sync = f"data-dependent ({type(e).__name__})"
        self._record(func, base, args, kwargs, out, sync)
        return out

    def _host_scalar(self, func, args, kwargs):
        """A scalar read: of a constant made from Python data the fake
        mode knows the value (no sync); of anything else, a host sync,
        recorded, and the trace goes on with a zero."""
        from torch._subclasses.fake_tensor import DataDependentOutputException
        try:
            out = func(*args, **kwargs)
        except DataDependentOutputException:
            pass
        else:
            self._record(func, str(func.overloadpacket), args, kwargs, out,
                         "")
            return out
        t = args[0]
        self._record(func, str(func.overloadpacket), args, kwargs, None,
                     "item")
        return False if t.dtype == torch.bool else (
            0.0 if t.is_floating_point() else 0)

    def _record(self, func, base, args, kwargs, out, sync) -> None:
        from torch.utils.flop_counter import flop_registry
        schema = func._schema
        flat_in, _ = tree_flatten((args, kwargs))
        ins = [t for t in flat_in if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        opcode = _COLLECTIVES.get(base, "")
        if not opcode and base != _WAIT and func.namespace in (
                "c10d", "_c10d_functional"):
            raise NotImplementedError(
                f"{base}: a collective the step trace does not know")
        srcs = ins
        if base.startswith("c10d."):
            # a c10d op writes its result into its first argument: a
            # separate buffer, or the input itself (all-reduce, broadcast)
            first = [t for t in tree_leaves(args[0])
                     if isinstance(t, torch.Tensor)]
            outs = first
            if base in _C10D_OUT_FIRST:
                srcs = [t for t in tree_leaves(args[1])
                        if isinstance(t, torch.Tensor)]
            else:
                srcs = first
        in_ids = tuple(self.sid(t) for t in srcs)
        out_ids = tuple(self.sid(t) for t in outs)
        mult, backward = self.current_mult(base, outs)
        flops = 0.0
        fn = flop_registry.get(func._overloadpacket)
        if fn is not None:
            flops = float(fn(*args, **kwargs, out_val=out))
        rooted = tuple(s in self.rooted for s in in_ids)
        if base in _CHAIN or func.is_view:
            if any(rooted):
                self.rooted.update(s for s in out_ids if s >= 0)
        if not sync and base in ("aten._to_copy", "aten.copy_") and outs \
                and srcs and srcs[0].device.type != "cpu" \
                and outs[0].device.type == "cpu":
            sync = "d2h"
        written = indexed_write_bytes(schema.name, args)
        rec = TraceRecord(
            op=str(func), name=schema.name,
            in_shapes=tuple(tuple(t.shape) for t in srcs),
            in_dtypes=tuple(hlo_dtype(t.dtype) for t in srcs),
            out_shapes=tuple(tuple(t.shape) for t in outs),
            out_dtypes=tuple(hlo_dtype(t.dtype) for t in outs),
            in_ids=in_ids, out_ids=out_ids,
            in_bytes=written[0] if written else sum(
                t.numel() * t.element_size()
                for t in (srcs if opcode else ins)),
            out_bytes=written[1] if written else sum(
                t.numel() * t.element_size() for t in outs),
            flops=flops, is_view=func.is_view,
            pointwise=torch.Tag.pointwise in func.tags,
            out_numel=sum(t.numel() for t in outs),
            param_rooted=rooted, mult=mult, backward=backward,
            host_sync=sync)
        if opcode or sync:
            rec.op_name = "/".join([*self.scopes, _caller()])
        if opcode:
            rec.opcode = opcode
            pg = _group_arg(schema, args, kwargs)
            rec.group = self._group(pg) if pg is not None else ()
            rec.axes, rec.crosses_pods = self._axes(rec.group)
            if base.startswith("c10d."):
                # async c10d calls are waited through mark_wait
                for s in out_ids:
                    self.pending[s] = len(self.records)
        elif base == _WAIT:
            rec.is_wait = True
            rec.op_name = "/".join([*self.scopes, _caller()])
            for s in in_ids:
                j = self.pending.pop(s, None)
                if j is not None:
                    self.records[j].wait = len(self.records)
        if base.startswith("_c10d_functional.") and opcode:
            for s in out_ids:
                self.pending[s] = len(self.records)
        self.records.append(rec)


def group_axes(groups, mesh_axes: dict) -> tuple:
    """``(axes, crosses_pods)`` of a collective's replica groups (ranks in
    the row-major order of the mesh ``mesh_axes``): the sorted mesh axes
    they span (``dist.sharding.axes_of_replica_groups``; ``None`` when
    they are no sub-grid of the mesh) and whether a group spans two pods
    (pod = the leading ``"pod"`` axis)."""
    from repro_torch.dist.sharding import axes_of_replica_groups
    axes = axes_of_replica_groups([list(g) for g in groups], mesh_axes)
    n = 1
    for v in mesh_axes.values():
        n *= int(v)
    per_pod = max(n // int(mesh_axes.get("pod", 1)), 1)
    crosses = any(len({r // per_pod for r in g}) > 1 for g in groups)
    return (tuple(sorted(axes)) if axes is not None else None), crosses


def _group_arg(schema, args, kwargs):
    """The group argument of a collective (``group_name`` or
    ``process_group``)."""
    for i, a in enumerate(schema.arguments):
        if a.name in ("group_name", "process_group", "group"):
            return args[i] if i < len(args) else kwargs.get(a.name)
    return None


def _upper_bound(base: str, args):
    """The largest output a data-dependent-shape op could give."""
    x = args[0]
    if base == "aten.nonzero":
        return torch.empty((x.numel(), x.dim()), dtype=torch.int64,
                           device=x.device)
    return torch.empty((x.numel(),), dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# trace_step
# ---------------------------------------------------------------------------

def _fake_group(world: int) -> None:
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError(
            "trace_step makes its own fake process group and will not run "
            "inside an initialized default group; trace in a child process")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _leaf_info(tree, rec: _Recorder) -> list:
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, rec._dtensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            out.append((hlo_dtype(t.dtype), tuple(t.shape), rec.sid(t)))
    return out


def trace_step(fn, *args, mesh_shape: tuple = (), mesh_dims: tuple = (),
               device_type: str = "cuda", setup=None, params_at: int = 0,
               cuts: dict | None = None, rules=None,
               make_mesh=None) -> StepTrace:
    """Run ``fn(*args)`` once under fake tensors and return its trace.

    The call runs inside a fake default process group of ``prod(mesh_shape)``
    ranks that this function creates and destroys (it refuses to run inside
    an initialized group), as rank 0, with the ``DeviceMesh``
    ``mesh_shape``/``mesh_dims`` on ``device_type`` registered through
    ``dist.sharding.set_mesh`` (with ``rules``).  ``setup(mesh)``, called
    under the fake mode, returns further arguments (DTensors need the
    mesh); tensor arguments are made fake.  ``params_at`` names the
    argument whose tensors are the parameters (provenance roots).
    ``cuts`` maps a :func:`loop` name to the iterations traced.
    ``make_mesh(device_type)`` builds the mesh instead (e.g.
    ``launch.mesh.make_production_mesh``); it must be of ``mesh_shape``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    import torch.distributed as dist
    from repro_torch.dist import sharding
    global _ACTIVE
    world = 1
    for s in mesh_shape:
        world *= int(s)
    _fake_group(world)
    saved = (sharding.get_mesh(), sharding.get_rules())
    t0 = time.perf_counter()
    try:
        mesh = None
        if make_mesh is not None:
            mesh = make_mesh(device_type)
            if tuple(mesh.shape) != tuple(mesh_shape):
                raise ValueError(f"make_mesh built {tuple(mesh.shape)}, "
                                 f"not {tuple(mesh_shape)}")
        elif mesh_shape:
            mesh = init_device_mesh(device_type, tuple(mesh_shape),
                                    mesh_dim_names=tuple(mesh_dims))
        sharding.set_mesh(mesh, rules)
        fake = FakeTensorMode(allow_non_fake_inputs=False)
        rec = _Recorder(mesh, cuts)
        warm = _Recorder(mesh, cuts)
        warm.paused = True
        with fake:
            args = tree_map(lambda a: fake.from_tensor(a)
                            if isinstance(a, torch.Tensor)
                            and not isinstance(a, rec._dtensor) else a,
                            tuple(args))
            if setup is not None:
                args = args + tuple(setup(mesh))
            arg_leaves = _leaf_info(args, rec)
            params = _leaf_info(args[params_at], rec) \
                if len(args) > params_at else []
            rec.param_ids = {s for _d, _s, s in params}
            rec.param_shapes = {shape for _d, shape, _s in params}
            rec.rooted = set(rec.param_ids)
            persistent = {s for _d, _s, s in arg_leaves}
            # DTensor's first call of an op propagates its sharding by
            # running it on fake tensors; a warm-up call fills those caches
            # so the recorded call holds the step's own ops only
            try:
                _ACTIVE = warm
                with warm:
                    fn(*args)
                del warm
                _ACTIVE = rec
                # anomaly mode keeps each autograd node's creation stack:
                # a backward collective is named after the forward code
                with warnings.catch_warnings():
                    warnings.filterwarnings("ignore",
                                            message="Anomaly Detection")
                    with torch.autograd.detect_anomaly(check_nan=False), rec:
                        result = fn(*args)
            finally:
                _ACTIVE = None
            out_leaves = _leaf_info(result, rec)
        trace = StepTrace(
            records=rec.records,
            mesh_axes=dict(zip(mesh_dims, (int(s) for s in mesh_shape))),
            n_devices=world, device_type=device_type,
            storage_bytes=dict(rec.nbytes), persistent=persistent,
            outputs={s for _d, _s, s in out_leaves},
            arg_leaves=arg_leaves, out_leaves=out_leaves,
            iterations=rec.iterations, regions=rec.regions,
            measured_peak_bytes=rec.peak,
            layers_traced=rec.seen.get("layers", (None,))[0],
            layers_total=rec.seen.get("layers", (None, None))[1],
            microbatches_traced=rec.seen.get("microbatches", (None,))[0],
            microbatches_total=rec.seen.get("microbatches", (None, None))[1],
            seconds=time.perf_counter() - t0, result=result)
        return trace
    finally:
        sharding.set_mesh(*saved)
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# analysis: the reference's overlap model on a trace
# ---------------------------------------------------------------------------

def _default_hw() -> dict:
    from .tools.roofline import H100
    return H100


def record_cost(r: TraceRecord) -> tuple:
    """``(flops, hbm_bytes)`` of one call of a compute record (the
    capture's rules: matmul-class FLOPs plus one per pointwise output
    element; operand and result bytes of every non-view op).  Collectives
    and waits contend for the link and cost nothing here."""
    if r.is_collective or r.is_wait or r.is_view:
        return 0.0, 0.0
    return (r.flops + (r.out_numel if r.pointwise else 0),
            float(r.in_bytes + r.out_bytes))


def _window(trace: StepTrace, i: int) -> list:
    """Record indices of collective ``i``'s overlap window: up to its wait
    (an async pair), else up to the first non-view record that reads its
    result (a synchronous collective); empty when nothing reads it."""
    r = trace.records[i]
    if r.wait is not None:
        return list(range(i + 1, min(r.wait, len(trace.records))))
    outs = set(r.out_ids)
    for j in range(i + 1, len(trace.records)):
        c = trace.records[j]
        if outs.intersection(c.in_ids) and not c.is_view:
            return list(range(i + 1, j))
    return []


def collective_link(r: TraceRecord) -> str:
    return "dci" if r.crosses_pods else "ici"


def analyze_trace(trace: StepTrace, hw: dict | None = None) -> CaptureStats:
    """Roll a step trace up into the reference's ``HloStats`` fields.

    Records count ``mult`` times (cut loops).  Each collective's exposure
    follows the reference's overlap model: the compute in its window
    (priced ``max(flops / peak, bytes / hbm_bw)`` against ``hw``) hides up
    to its alpha-beta time (``ici_latency + wire / link_bw``, the link
    ``dci`` where a group crosses pods, else ``ici``).  A trace carries
    its own trip multipliers and pod layout, so the reference's
    ``default_trip``/``pods``/``n_devices`` have no counterpart."""
    hw = dict(hw if hw is not None else _default_hw())
    stats = CaptureStats(hw=hw)
    keys: dict = {}
    per_name: dict = {}
    bw = {"ici": hw.get("ici_bw", 0.0),
          "dci": hw.get("dci_bw", hw.get("ici_bw", 0.0))}
    alpha = hw.get("ici_latency", 0.0)
    seen_coll: dict = {}
    for i, r in enumerate(trace.records):
        try:
            _visit(trace, i, r, stats, hw, bw, alpha, seen_coll, keys,
                   per_name)
        except Exception:                                   # noqa: BLE001
            # a malformed record must not sink the whole rollup: skip it,
            # count it, keep walking
            stats.warnings[f"record-error:{r.op}"] = \
                stats.warnings.get(f"record-error:{r.op}", 0) + 1
    if not trace.records:
        stats.warnings["empty-trace"] = 1
    return stats


def _visit(trace, i, r, stats, hw, bw, alpha, seen_coll, keys,
           per_name) -> None:
    """Add record ``i`` to ``stats``."""
    if r.is_wait:
        return
    if r.is_collective:
        op_b = float(r.in_bytes) or float(r.out_bytes)
        n = len(r.group) or None
        wire = collective_wire_bytes(r.opcode, op_b, r.out_bytes, n)
        stats.collective_bytes[r.opcode] = \
            stats.collective_bytes.get(r.opcode, 0.0) + op_b * r.mult
        stats.collective_wire_bytes[r.opcode] = \
            stats.collective_wire_bytes.get(r.opcode, 0.0) \
            + wire * r.mult
        link = collective_link(r)
        wf = wb = 0.0
        for j in _window(trace, i):
            f, b = record_cost(trace.records[j])
            wf += f
            wb += b
        comm_s = alpha + wire / bw[link] if bw[link] else 0.0
        hide_s = max(wf / hw["peak_flops"] if hw.get("peak_flops")
                     else 0.0,
                     wb / hw["hbm_bw"] if hw.get("hbm_bw") else 0.0)
        hidden = min(comm_s, hide_s)
        comp = r.op_name or "step"
        k = seen_coll[(comp, r.opcode)] = \
            seen_coll.get((comp, r.opcode), -1) + 1
        stats.collective_instances.append({
            "opcode": r.opcode, "name": f"{r.opcode}.{k}",
            "bytes": op_b, "mult": r.mult,
            "group_size": n, "computation": comp, "index": i,
            "wire_bytes": wire, "op_name": r.op_name,
            "window_flops": wf, "window_hbm_bytes": wb,
            "comm_s": comm_s, "link": link, "hidden_s": hidden,
            "exposed_bytes": (wire * (1.0 - hidden / comm_s)
                              if comm_s > 0 else float(wire)),
            "overlapped": hidden > 0.0, "async": r.wait is not None,
            "axes": list(r.axes) if r.axes is not None else None})
        return
    f, b = record_cost(r)
    stats.flops += f * r.mult
    if r.is_view:
        return
    stats.hbm_bytes += b * r.mult
    sig = (r.name, int(b))
    key = keys.get(sig)
    if key is None:
        n = per_name[r.name] = per_name.get(r.name, -1) + 1
        key = keys[sig] = f"{r.name}.{n}"
        stats.kernel_meta[key] = {"opcode": r.name,
                                  "op_name": r.op_name, "bytes": b}
    stats.kernel_counts[key] = stats.kernel_counts.get(key, 0) + r.mult
