"""Logical-axis sharding on a ``torch.distributed`` ``DeviceMesh``:
process-global mesh registry + rule table.

Model code never names mesh dimensions.  Parameters and activations are
annotated with *logical* axis names ("p_embed", "seq_sp", "expert_ff",
...) and a :class:`ShardingRules` table maps each logical name to a mesh
dimension (or a tuple of them, or ``None`` for replicated).
:func:`resolve` turns one annotation into the per-tensor-dimension spec
the reference's ``PartitionSpec`` holds; :func:`logical` turns it into
DTensor placements, one per mesh dimension; ``shard(x, *axes)``
redistributes a DTensor to them (a no-op when no mesh is registered or
``x`` is a plain tensor, so single-device code runs unchanged).

Resolution rules (what makes the table safe to apply blindly):

  * mesh dimensions absent from the current mesh — or of size 1 — are
    dropped (the same model runs on ``("data","model")``,
    ``("pod","data","model")`` and ``("pipe","data")`` meshes);
  * a mesh dimension may appear in at most one tensor dimension; the first
    (leftmost) logical axis that claims it wins, later claims resolve to
    ``None`` (e.g. MoE expert weights: "p_experts" takes the ZeRO "data"
    dimension, so "p_embed" in the same tensor stays local);
  * when ``dims`` is given, a mesh dimension that does not evenly divide
    its tensor dimension is dropped (reduced configs have e.g. 1 KV head).

A tuple rule such as ``"batch": ("pod", "data")`` shards one tensor
dimension over both mesh dimensions, major first: ``Shard(i)`` on each,
which DTensor splits in mesh order.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


class ShardingRules(dict):
    """Mapping from logical axis name to mesh dimension name(s).

    Values are a mesh dimension name, a tuple of names (the tensor
    dimension shards over their product, major first), or ``None``
    (replicated).  Plain-``dict`` semantics so call sites can patch with
    ``{**DEFAULT_RULES, ...}``.
    """

    def physical(self, name):
        if name is None:
            return None
        try:
            return self[name]
        except KeyError:
            raise KeyError(
                f"unknown logical axis {name!r}; known: {sorted(self)}"
            ) from None


DEFAULT_RULES = ShardingRules({
    # ---- parameters --------------------------------------------------------
    "p_layers": None,             # stacked layer dim stays local
    "p_vocab": "model",
    "p_embed": "data",            # FSDP / ZeRO-3 axis
    "p_heads": "model",
    "p_kv_heads": "model",
    "p_ff": "model",
    "p_experts": "data",          # TP-MoE: expert dim ZeRO-shards over data
    "p_experts_ep": "model",      # EP-MoE: experts over model
    "p_expert_ff": "model",
    "p_ssm_inner": "model",       # Mamba2 head parallelism
    # ---- activations / caches ---------------------------------------------
    "batch": ("pod", "data"),
    "seq": None,                  # no SP for training activations
    "seq_sp": "model",            # KV-cache sequence dim (flash-decode SP)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "embed": None,                # replicated between-layer activations
    "ff": "model",
    "vocab": "model",
    "experts": None,              # TP-MoE: token buffer stays data-local
    "experts_ep": "model",        # EP-MoE: the token all-to-all
    "expert_ff": "model",
    "ssm_heads": "model",
})

_MESH = None
_RULES: ShardingRules = DEFAULT_RULES


def set_mesh(mesh, rules: ShardingRules | None = None) -> None:
    """Register the process-global ``DeviceMesh`` (``None`` disables
    sharding).  ``rules=None`` resets to :data:`DEFAULT_RULES`; pass
    ``set_mesh(mesh, get_rules())`` to keep a custom table in force."""
    global _MESH, _RULES
    if mesh is not None:
        _register_missing_rules()
    _MESH = mesh
    _RULES = ShardingRules(rules) if rules is not None else DEFAULT_RULES


def get_mesh():
    return _MESH


def get_rules() -> ShardingRules:
    return _RULES


def axis_sizes(mesh) -> dict:
    """``{dimension name: size}`` of a ``DeviceMesh``, in mesh order."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_axis_size(name: str) -> int:
    """Size of a mesh dimension; 1 when no mesh is set or it is absent."""
    mesh = get_mesh()
    if mesh is None:
        return 1
    return int(axis_sizes(mesh).get(name, 1))


def resolve(*axes, dims=None, rules: ShardingRules | None = None,
            mesh=None) -> tuple:
    """Resolve logical axis names into a per-tensor-dimension spec: for
    each dimension ``None``, one mesh dimension name, or a tuple of them
    (major first) — the entries of the reference's ``PartitionSpec``.

    ``dims`` (the tensor shape) enables the divisibility filter; ``rules``
    and ``mesh`` default to the registered globals."""
    rules = rules if rules is not None else get_rules()
    mesh = mesh if mesh is not None else get_mesh()
    if dims is not None and len(dims) != len(axes):
        raise ValueError(f"rank mismatch: {len(axes)} logical axes for "
                         f"shape {tuple(dims)}")
    sizes = axis_sizes(mesh) if mesh is not None else None
    used: set = set()
    spec = []
    for i, name in enumerate(axes):
        phys = rules.physical(name)
        if phys is None:
            spec.append(None)
            continue
        cands = (phys,) if isinstance(phys, str) else tuple(phys)
        kept = []
        prod = 1
        for a in cands:
            if a in used:
                continue
            if sizes is not None:
                size = sizes.get(a)
                if size is None or size == 1:
                    continue
                if dims is not None and dims[i] % (prod * size):
                    continue
                prod *= size
            kept.append(a)
            used.add(a)
        if not kept:
            spec.append(None)
        elif len(kept) == 1:
            spec.append(kept[0])
        else:
            spec.append(tuple(kept))
    return tuple(spec)


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements, one per mesh dimension, of a resolved ``spec``:
    ``Shard(i)`` where tensor dimension ``i`` claims the mesh dimension,
    else ``Replicate()``.  A tuple entry must list its mesh dimensions in
    mesh order, the order DTensor splits a dimension in."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        pos = [names.index(a) for a in group]
        if pos != sorted(pos):
            raise ValueError(f"{group} is not in the mesh's order {names}")
        for j in pos:
            out[j] = Shard(i)
    return tuple(out)


def logical(*axes, dims=None, rules: ShardingRules | None = None,
            mesh=None) -> tuple:
    """DTensor placements (one per mesh dimension) of logical axis names:
    the counterpart of the reference's ``PartitionSpec``.  Needs a mesh,
    given or registered."""
    mesh = mesh if mesh is not None else get_mesh()
    if mesh is None:
        raise ValueError("logical() needs a mesh: pass mesh= or set_mesh()")
    return placements(resolve(*axes, dims=dims, rules=rules, mesh=mesh),
                      mesh)


def block_range(shape, dim: int, mesh, placements) -> tuple:
    """``[start, stop)`` of this rank's block of dimension ``dim`` of a
    tensor of ``shape`` placed by ``placements`` on ``mesh``
    (``torch.chunk``'s split, mesh dimensions in order, as DTensor cuts
    it)."""
    coord = mesh.get_coordinate()
    start, size = 0, shape[dim]
    for j, p in enumerate(placements):
        if p.is_shard(dim):
            chunk = -(-size // mesh.size(j))
            off = min(coord[j] * chunk, size)
            start, size = start + off, min(size - off, chunk)
    return start, start + size


def _stride(shape) -> tuple:
    """The contiguous strides of ``shape``."""
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def placed(full: torch.Tensor, mesh, placements) -> DTensor:
    """``full`` as a DTensor placed by ``placements``, from this rank's
    block of it (a copy): every rank holds the same values, so no bytes
    move, where ``distribute_tensor`` sends rank 0's."""
    block = full[tuple(slice(*block_range(full.shape, d, mesh, placements))
                       for d in range(full.dim()))]
    if block.shape != full.shape:
        block = block.clone()             # the whole tensor can go
    return DTensor.from_local(block, mesh, placements,
                              run_check=False, shape=full.shape,
                              stride=_stride(full.shape))


def placed_zeros(shape, mesh, placements, **kw) -> DTensor:
    """A zero DTensor of ``shape`` placed by ``placements``: each rank
    allocates its block alone (``kw``: ``dtype``, ``device``)."""
    local = [b - a for a, b in (block_range(shape, d, mesh, placements)
                                for d in range(len(shape)))]
    return DTensor.from_local(torch.zeros(local, **kw), mesh, placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_stride(shape))


# ---------------------------------------------------------------------------
# Static-analysis intent model (consumed by the implicit-reshard pass)
# ---------------------------------------------------------------------------

def axes_of_replica_groups(groups, mesh_axes: dict):
    """Classify a collective's replica groups onto the mesh axes they span.

    ``mesh_axes`` is the *ordered* ``{axis_name: size}`` of the mesh the
    artifact was partitioned for (device id = row-major linearization of
    the mesh coordinates, the rank order of ``init_device_mesh``).  Returns
    a ``frozenset`` of axis names when every group is exactly a sub-grid
    varying over those axes, else ``None`` (groups that do not align to the
    mesh cannot be judged against the rule table and are skipped by the
    intent check).
    """
    if not groups or not mesh_axes:
        return None
    names = list(mesh_axes)
    sizes = [int(mesh_axes[n]) for n in names]
    ndev = 1
    for s in sizes:
        ndev *= s
    strides = []
    acc = 1
    for s in reversed(sizes):
        strides.append(acc)
        acc *= s
    strides.reverse()

    def coords(d):
        return tuple((d // strides[i]) % sizes[i] for i in range(len(sizes)))

    varying: set = set()
    for g in groups:
        if any(not isinstance(d, int) or d < 0 or d >= ndev for d in g):
            return None
        cs = [coords(d) for d in g]
        for dim in range(len(sizes)):
            if len({c[dim] for c in cs}) > 1:
                varying.add(dim)
    expect = 1
    for dim in varying:
        expect *= sizes[dim]
    if any(len(g) != expect for g in groups):
        return None         # partial/ragged sub-grid: not a clean axis set
    return frozenset(names[i] for i in varying)


#: opcodes whose job is *data movement between layouts* — the reshard
#: family the implicit-reshard pass audits (reductions are never reshards)
RESHARD_OPCODES = ("all-gather", "all-to-all", "ragged-all-to-all",
                   "collective-permute", "collective-broadcast")


def intended_collectives(rules=None, mesh_axes=None, kind: str = "",
                         mesh=None) -> dict:
    """The reshard traffic the rule table *intends*: a map from reshard
    opcode to the set of mesh-axis sets it may legitimately span.

      * **all-gather** — ZeRO/FSDP parameter gathers: axes shared between a
        ``p_*`` parameter rule and the ``batch`` rule, plus the ``batch``
        axes themselves (the reduce-scatter + all-gather gradient-sync
        layout), and — for cells with KV caches (``kind != "train"``) —
        the ``seq_sp`` sequence-parallel cache axes.
      * **all-to-all** / **ragged-all-to-all** — expert-parallel token
        dispatch: axes of the ``experts_ep`` / ``p_experts_ep`` rules.
      * **collective-permute** — pipeline neighbour shifts: the ``pipe``
        axis, plus the ``batch`` axes.
      * **collective-broadcast** — same budget as all-gather.

    Every returned set also admits subsets (checked by the pass).
    """
    rules = dict(rules if rules is not None else get_rules())
    if mesh_axes is None:
        mesh = mesh if mesh is not None else get_mesh()
        mesh_axes = axis_sizes(mesh) if mesh is not None else {}
    present = {a for a, s in mesh_axes.items() if int(s) > 1}

    def axset(val):
        if val is None:
            return frozenset()
        axes = (val,) if isinstance(val, str) else tuple(val)
        return frozenset(a for a in axes if a in present)

    batch_axes = axset(rules.get("batch"))
    gather: set = set()
    if batch_axes:
        gather.add(batch_axes)
    for key, val in rules.items():
        if key.startswith("p_"):
            zero = axset(val) & batch_axes
            if zero:
                gather.add(zero)
    if kind != "train":
        sp = axset(rules.get("seq_sp"))
        if sp:
            gather.add(sp)
    a2a: set = set()
    for key in ("experts_ep", "p_experts_ep"):
        ax = axset(rules.get(key))
        if ax:
            a2a.add(ax)
    permute: set = set()
    if "pipe" in present:
        permute.add(frozenset(("pipe",)))
    if batch_axes:
        permute.add(batch_axes)
    return {
        "all-gather": gather,
        "collective-broadcast": set(gather),
        "all-to-all": a2a,
        "ragged-all-to-all": set(a2a),
        "collective-permute": permute,
    }


def _register_missing_rules() -> None:
    """Give DTensor a sharding rule for ``aten.flip`` where the release
    has none (torch 2.11; 2.13 has one): the backward of ``cumsum`` (the
    SSD scan's) flips, and without a rule a sharded Mamba2 step fails.
    Flipping keeps any sharding of the dimensions it does not flip."""
    prop = DTensor._op_dispatcher.sharding_propagator
    op = torch.ops.aten.flip.default
    if any(op in getattr(prop, name, {}) for name in (
            "op_to_rules", "op_strategy_funcs",
            "op_single_dim_strategy_funcs")):
        return
    from torch.distributed.tensor.experimental import register_sharding

    @register_sharding(op)
    def _flip(x, dims):
        ndim = len(x.shape)
        flipped = {d % ndim for d in dims}
        return [([Replicate()], [Replicate(), None])] + [
            ([Shard(d)], [Shard(d), None]) for d in range(ndim)
            if d not in flipped]


class _Constrain(torch.autograd.Function):
    """Identity that puts its value in ``target`` on the way forward and
    its gradient in ``target`` on the way back: the transpose of JAX's
    ``with_sharding_constraint`` is the same constraint on the cotangent.
    (``DTensor.redistribute``'s backward returns the gradient in the
    input's placements, so it leaves DTensor's propagation free to move
    a gradient off the annotated layout.)"""

    @staticmethod
    def forward(ctx, x, mesh, target):
        ctx.mesh, ctx.target = mesh, target
        if tuple(x.placements) == target:
            return x.view_as(x)
        return x.redistribute(mesh, target)

    @staticmethod
    def backward(ctx, grad):
        if tuple(grad.placements) != ctx.target:
            grad = grad.redistribute(ctx.mesh, ctx.target)
        return grad, None, None


def shard(x, *axes):
    """Constrain the DTensor ``x`` to ``logical(*axes)``: its value is
    redistributed there, and so is the gradient that flows back through
    this point, as the reference's sharding constraint does.

    A no-op when no mesh is registered, when ``x`` is a plain tensor (the
    single-device path, or a rank's local block), or when the annotation
    rank does not match ``x`` (callers annotate the common layout;
    reshaped variants pass through unconstrained rather than erroring).
    """
    mesh = get_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    if len(axes) != x.dim():
        return x
    target = logical(*axes, dims=x.shape, mesh=mesh)
    if not (x.requires_grad and torch.is_grad_enabled()):
        return x if tuple(x.placements) == target \
            else x.redistribute(mesh, target)
    return _Constrain.apply(x, mesh, target)


def einsum(equation: str, *operands):
    """``torch.einsum``; with a DTensor among the operands, run on each
    rank's blocks (plain operands count as replicated).

    For each mesh dimension the first operand sharded over it names the
    label it shards; every operand with that label is sharded on it there
    and every other operand replicated (an FSDP weight is gathered), and
    the result is sharded on the label, or a partial sum when the label is
    contracted.  Each rank then contracts its blocks with ``torch.einsum``,
    the way the reference's matmuls run inside a shard: DTensor's own rule
    for einsum flattens dimensions into a batched matmul, which some torch
    releases refuse when two of them are sharded.  On a mesh of size 1 the
    result is the plain einsum's, bit for bit.
    """
    dts = [o for o in operands if isinstance(o, DTensor)]
    if not dts:
        return torch.einsum(equation, *operands)
    mesh = dts[0].device_mesh
    ins, out = equation.replace(" ", "").split("->")
    ins = ins.split(",")
    ops = [o if isinstance(o, DTensor) else DTensor.from_local(
        o, mesh, (Replicate(),) * mesh.ndim, run_check=False)
        for o in operands]
    targets = [[Replicate()] * mesh.ndim for _ in ops]
    # an operand replicated over a dimension that splits the work holds
    # only its rank's share of its gradient: a partial sum
    grads = [[Replicate()] * mesh.ndim for _ in ops]
    out_pl = []
    for j in range(mesh.ndim):
        label = next((spec[o.placements[j].dim] for o, spec in zip(ops, ins)
                      if o.placements[j].is_shard()), None)
        for t, g, spec in zip(targets, grads, ins):
            if label is not None and label in spec:
                t[j] = g[j] = Shard(spec.index(label))
            elif label is not None:
                g[j] = Partial()
        out_pl.append(Replicate() if label is None else
                      Shard(out.index(label)) if label in out else Partial())
    sizes = {}
    for o, spec in zip(ops, ins):
        sizes.update(zip(spec, o.shape))
    shape = torch.Size(sizes[c] for c in out)
    local = torch.einsum(equation, *(
        o.redistribute(mesh, t).to_local(grad_placements=g)
        for o, t, g in zip(ops, targets, grads)))
    # the global layout is contiguous; torch.einsum may return a permuted
    # view
    return DTensor.from_local(local.contiguous(), mesh, out_pl,
                              run_check=False, shape=shape,
                              stride=_stride(shape))


def take_rows(table, ids):
    """``table[ids]`` (an embedding lookup); with a DTensor, each rank looks
    up its own ids in the whole table (gathered), and the table's gradient
    is a partial sum over the dimensions the ids are split on.  DTensor's
    rule for the lookup's backward (``index_put``) fails in some torch
    releases."""
    if not isinstance(table, DTensor) and not isinstance(ids, DTensor):
        return table[ids]
    mesh = (table if isinstance(table, DTensor) else ids).device_mesh
    rep = (Replicate(),) * mesh.ndim
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, rep, run_check=False)
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, rep, run_check=False)
    grad = [Partial() if p.is_shard() else Replicate()
            for p in ids.placements]
    local = table.redistribute(mesh, rep).to_local(grad_placements=grad)[
        ids.to_local()]
    shape = torch.Size((*ids.shape, *table.shape[1:]))
    return DTensor.from_local(local, mesh, ids.placements, run_check=False,
                              shape=shape, stride=_stride(shape))
