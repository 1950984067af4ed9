"""The train step, on one device or on a ``DeviceMesh``, and the sharding
plumbing shared by the train launcher.

``make_train_step`` builds

    (params, opt_state, batch) -> (params, opt_state, metrics)

with microbatched gradient accumulation (the reference's ``lax.scan`` over
microbatches, in its order: gradients summed from zero, then divided by
the count), global-norm clipping and AdamW.  Gradients come from
``torch.autograd.grad`` over the port's ``forward`` and ``cross_entropy``.
``batch`` holds torch tensors (``"inputs"``: (B, S) int tokens or (B, S, d)
embeddings, ``"labels"``: (B, S) int).

On a mesh (:func:`repro_torch.dist.sharding.set_mesh`) the parameters and
optimizer state are DTensors placed by :func:`train_shardings` (the rule
table over :func:`~repro_torch.models.param_axes`) and the batch by
:func:`batch_shardings`; the step runs under DTensor's
``implicit_replication`` (plain tensors made inside the model, such as
positions and masks, act as replicated), and each gradient is
redistributed once, after the microbatch loop, to its parameter's
placements.

Cross-pod gradient sync (``overlap_sync=``):

* ``None`` (default) — DTensor folds the pod reduction into the backward
  pass (batch sharded over ``("pod", "data")``), no explicit sync.
* ``False`` — explicit *blocking* sync: one synchronous
  :func:`~repro_torch.dist.collectives.make_pod_sync` all-reduce per leaf
  at step end.
* ``True`` — explicit *overlapped* sync: gradients are bucketed by layer
  group and each bucket's reduce half is issued before the previous
  bucket's wait retires (``psum_start``/``psum_wait``); while bucket *g* is
  in flight, bucket *g−1*'s gradient-norm contribution is computed, so the
  optimizer boundary reuses the accumulated norm.

With an explicit sync the batch is *replicated* across pods
(``include_pod=False`` batch shardings): each pod computes full-batch
gradients and the explicit pod mean is numerically the identity, so the
step matches the single-pod step (modulo int8 quantization when
``sync_compressed=True``).  Without a mesh the sync modes change nothing.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import (DTensor, Partial, distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core import trace
from repro_torch.dist.collectives import (make_pod_sync, psum_start,
                                          psum_wait)
from repro_torch.dist.sharding import (axis_sizes, get_mesh, get_rules,
                                       logical, placements, set_mesh)
from repro_torch.models import (cache_axes, cross_entropy, forward,
                                init_cache, init_params, param_axes)
from repro_torch.models.config import ModelConfig
from .optimizer import (OptConfig, adamw_update, init_opt_state,
                        opt_state_axes, tree_map, tree_paths)

BATCH_AXES = ("pod", "data")


# ---------------------------------------------------------------- shardings
def tree_shardings(mesh, axes_tree: dict, shapes_tree: dict) -> dict:
    """Tree of DTensor placements from a logical-axes tree and a tree of
    tensors of the same shapes (``meta`` tensors will do)."""
    set_mesh(mesh, get_rules())          # keep any custom rules in force
    return tree_map(lambda ax, t: logical(*ax, dims=t.shape, mesh=mesh),
                    axes_tree, shapes_tree)


def place(tree: dict, shardings: dict, mesh) -> dict:
    """Each rank's full tensors of ``tree`` → DTensors placed per
    ``shardings`` (every rank must hold the same values)."""
    return tree_map(lambda p, sh: distribute_tensor(p, mesh, sh),
                    tree, shardings)


def _dp_axes(mesh, batch_size: int | None = None,
             include_pod: bool = True) -> tuple:
    names = BATCH_AXES if include_pod else BATCH_AXES[1:]
    sizes = axis_sizes(mesh)
    axes = tuple(a for a in names if sizes.get(a, 1) > 1)
    if batch_size is not None:
        while axes:
            n = 1
            for a in axes:
                n *= sizes[a]
            if batch_size % n == 0:
                break
            axes = axes[:-1]          # drop innermost dp axis until it fits
    return axes


def batch_spec(mesh, batch_size: int | None = None,
               include_pod: bool = True) -> tuple:
    """Placements of a tensor whose leading dimension is the batch."""
    return placements((_dp_axes(mesh, batch_size, include_pod) or None,),
                      mesh)


def batch_shardings(mesh, batch_tree: dict, include_pod: bool = True):
    """``include_pod=False`` replicates the batch across pods — required by
    the explicit ``overlap_sync`` paths, whose pod-mean sync supplies the
    cross-pod reduction instead of DTensor."""
    return tree_map(lambda leaf: batch_spec(mesh, leaf.shape[0],
                                            include_pod), batch_tree)


def abstract_state(cfg: ModelConfig, opt_cfg: OptConfig | None = None):
    """Parameters (and optimizer state) on the ``meta`` device: shapes and
    dtypes, no allocation — works for the 1T-param config."""
    params = init_params(cfg, 0, "meta")
    if opt_cfg is None:
        return params, None
    return params, init_opt_state(params, opt_cfg)


def train_shardings(mesh, cfg: ModelConfig, opt_cfg: OptConfig):
    """(param_shardings, opt_shardings, param_shapes, opt_shapes)."""
    p_shapes, o_shapes = abstract_state(cfg, opt_cfg)
    p_ax = param_axes(cfg)
    p_sh = tree_shardings(mesh, p_ax, p_shapes)
    o_sh = tree_shardings(mesh, opt_state_axes(p_ax, opt_cfg), o_shapes)
    return p_sh, o_sh, p_shapes, o_shapes


# --------------------------------------------------------------- train step
def _gather_once(params: dict, cfg: ModelConfig) -> dict:
    """ZeRO-2-style hoist: redistribute params with the FSDP (``p_embed``)
    axis dropped, so the all-gather happens once per step, before the
    microbatch loop — the summed gradients go back to the sharded layout
    once, after it.  Trades (params/model-shard) bytes of memory for
    (microbatches-1)/microbatches of the FSDP collective traffic."""
    mesh = get_mesh()
    if mesh is None:
        return params

    def regather(ax, p):
        ax2 = tuple(None if a == "p_embed" else a for a in ax)
        return p.redistribute(mesh, logical(*ax2, dims=p.shape, mesh=mesh))

    return tree_map(regather, param_axes(cfg), params)


def _loss_and_grads(params: dict, inputs, labels, cfg: ModelConfig):
    """(loss, parts, grads): grads in each parameter's dtype (on a mesh, in
    whatever placements the backward left them)."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = [p for _path, p in tree_paths(live)]
    with torch.enable_grad():
        logits, _ = forward(live, inputs, cfg)
        loss, parts = cross_entropy(logits, labels)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(leaves, gs)}
    grads = tree_map(lambda p: torch.zeros_like(p) if by_leaf[id(p)] is None
                     else by_leaf[id(p)], live)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def _like(grads: dict, params: dict) -> dict:
    """Each DTensor gradient redistributed to its parameter's placements
    (a partial sum is reduced here, once per step)."""
    def one(g, p):
        if isinstance(p, DTensor) and tuple(g.placements) != p.placements:
            return g.redistribute(p.device_mesh, p.placements)
        return g
    return tree_map(one, grads, params)


def _microbatch(x, i: int, m: int):
    """Microbatch ``i`` of ``m`` of the batch ``x``: rows ``[i*b/m,
    (i+1)*b/m)``.  A batch-sharded DTensor gives each rank's own block's
    rows ``[i*b_l/m, (i+1)*b_l/m)`` instead (no rows move between ranks):
    other rows in each microbatch than the reference's, the same rows over
    the step, so the same sum of gradients up to float32 rounding."""
    if isinstance(x, DTensor) and any(p.is_shard(0) for p in x.placements):
        local = x.to_local()
        if local.shape[0] % m == 0:
            mb = local.shape[0] // m
            return DTensor.from_local(local[i * mb:(i + 1) * mb],
                                      x.device_mesh, x.placements,
                                      run_check=False)
    mb = x.shape[0] // m
    return x[i * mb:(i + 1) * mb]


def _plain(t):
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


# ----------------------------------------------------- overlapped pod sync
def _bucket_pieces(leaves: list, n_buckets: int, layer_dim: int | None):
    """Partition gradient leaves into ``n_buckets`` layer-group buckets.

    Stacked leaves (leading dim == ``layer_dim``) are sliced along the
    layer axis so bucket *g* carries layer group *g* of every stacked leaf.
    Unstacked leaves (embeddings, final norm, ...) go whole to the
    currently lightest bucket.  Returns a list over buckets of ``(leaf_idx,
    lo, hi)`` pieces (``lo is None`` ⇒ the whole leaf).
    """
    buckets: list = [[] for _ in range(n_buckets)]
    weight = [0] * n_buckets
    for i, leaf in enumerate(leaves):
        if (layer_dim is not None and leaf.dim() >= 1
                and leaf.shape[0] == layer_dim and layer_dim >= n_buckets):
            per = leaf.numel() // max(leaf.shape[0], 1) * leaf.element_size()
            for g in range(n_buckets):
                lo = g * layer_dim // n_buckets
                hi = (g + 1) * layer_dim // n_buckets
                buckets[g].append((i, lo, hi))
                weight[g] += per * (hi - lo)
        else:
            g = min(range(n_buckets), key=weight.__getitem__)
            buckets[g].append((i, None, None))
            weight[g] += leaf.numel() * leaf.element_size()
    return [b for b in buckets if b]


def _replicas(t, mesh) -> int:
    """How many ranks of ``mesh`` hold each element of ``t``'s local
    block (the product of the dimensions it is replicated over)."""
    if not isinstance(t, DTensor):
        return mesh.size()
    n = 1
    for size, p in zip(mesh.shape, t.placements):
        n *= size if p.is_replicate() else 1
    return n


def make_overlapped_pod_sync(mesh, *, axis: str = "pod",
                             compressed: bool = False, n_buckets: int = 4,
                             layer_dim: int | None = None):
    """Bucketed, software-pipelined cross-pod gradient sync.

    Returns ``sync(grads) -> (synced_grads, grad_sqnorm)`` (or ``None``
    when the mesh has no pod dimension of size above 1).  The float
    leaves' local blocks are bucketed by layer group
    (:func:`_bucket_pieces`), one flat payload per bucket, and run through
    a ``psum_start``/``psum_wait`` double-buffered pipeline over the pod
    group: bucket *g*'s reduce half is issued, THEN bucket *g−1*'s wait
    retires and its squared-norm contribution is computed — compute that
    overlaps the in-flight collective.  Only the last bucket's wait is
    fully exposed.  ``grad_sqnorm`` sums each rank's share of the squared
    norm (a block held by r ranks counts 1/r on each) over the mesh, so
    the optimizer skips its own full-tree reduction
    (``adamw_update(grad_sqnorm=...)``).

    The sync is a pod *mean*; see the module docstring for why that makes
    the step numerically the single-pod step when the batch is
    pod-replicated.
    """
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names or mesh.size(names.index(axis)) == 1:
        return None
    pg = mesh.get_group(axis)
    inv_n = 1.0 / mesh.size(names.index(axis))

    def sync(grads: dict):
        paths = tree_paths(grads)
        fidx = [i for i, (_p, g) in enumerate(paths)
                if g.is_floating_point()]
        full = [paths[i][1] for i in fidx]
        local = [g.to_local() if isinstance(g, DTensor) else g for g in full]
        weight = [1.0 / _replicas(g, mesh) for g in full]
        buckets = _bucket_pieces(local, n_buckets, layer_dim)

        def flat_of(bucket):
            return torch.cat([(local[j] if lo is None else local[j][lo:hi])
                              .to(torch.float32).reshape(-1)
                              for j, lo, hi in bucket])

        outs: list = [None] * len(buckets)
        sq = torch.zeros((), dtype=torch.float32, device=local[0].device)

        def retire(g, handle, sq):
            done = psum_wait(handle, pg) * inv_n
            outs[g] = done
            off = 0
            for j, lo, hi in buckets[g]:
                n = local[j].numel() if lo is None else \
                    local[j][lo:hi].numel()
                piece = done[off:off + n]
                sq = sq + torch.sum(piece * piece) * weight[j]
                off += n
            return sq

        prev = None
        for g, bucket in enumerate(buckets):
            handle = psum_start(flat_of(bucket), pg, compressed=compressed)
            if prev is not None:
                sq = retire(g - 1, prev, sq)     # overlaps bucket g's wire
            prev = handle
        sq = retire(len(buckets) - 1, prev, sq)  # the only exposed wait
        sq = DTensor.from_local(sq, mesh, (Partial(),) * mesh.ndim,
                                run_check=False).full_tensor()

        # unflatten: split each bucket payload back into its pieces
        parts: dict = {}
        for bucket, flat in zip(buckets, outs):
            off = 0
            for j, lo, hi in bucket:
                shape = (local[j].shape if lo is None
                         else (hi - lo, *local[j].shape[1:]))
                n = 1
                for d in shape:
                    n *= d
                piece = flat[off:off + n].reshape(shape).to(local[j].dtype)
                off += n
                parts.setdefault(j, []).append((lo, piece))
        synced = {}
        for j, pieces in parts.items():
            pieces.sort(key=lambda t: t[0] or 0)
            block = (pieces[0][1] if len(pieces) == 1
                     else torch.cat([p for _lo, p in pieces], dim=0))
            g = full[j]
            if isinstance(g, DTensor):
                block = DTensor.from_local(block, g.device_mesh,
                                           g.placements, run_check=False)
            synced[paths[fidx[j]][0]] = block
        return _rebuild(grads, synced), sq

    return sync


def _rebuild(tree: dict, by_path: dict, prefix: tuple = ()) -> dict:
    """``tree`` with the leaves at the paths of ``by_path`` replaced."""
    return {k: _rebuild(v, by_path, (*prefix, k)) if isinstance(v, dict)
            else by_path.get((*prefix, k), v) for k, v in tree.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1, overlap_sync: bool | None = None,
                    sync_compressed: bool = False, sync_buckets: int = 4):
    def pod_sync(grads):
        """(synced grads, optional precomputed sqnorm) per overlap_sync."""
        mesh = get_mesh()
        if overlap_sync is None or mesh is None:
            return grads, None
        if overlap_sync:
            sync = make_overlapped_pod_sync(
                mesh, compressed=sync_compressed, n_buckets=sync_buckets,
                layer_dim=cfg.n_layers)
            return (grads, None) if sync is None else sync(grads)
        return make_pod_sync(mesh, compressed=sync_compressed,
                             mean=True)(grads), None

    def step(params: dict, opt_state: dict, batch: dict):
        inputs, labels = batch["inputs"], batch["labels"]
        used = params
        if cfg.gather_params_once and microbatches > 1:
            used = _gather_once(params, cfg)
        if microbatches == 1:
            loss, _parts, grads = _loss_and_grads(used, inputs, labels, cfg)
        else:
            m = microbatches
            b = inputs.shape[0]
            assert b % m == 0, (b, m)
            grads = tree_map(torch.zeros_like, used)
            lsum = torch.zeros((), dtype=torch.float32, device=inputs.device)
            for i in trace.loop("microbatches", m):
                l, _p, g = _loss_and_grads(used, _microbatch(inputs, i, m),
                                           _microbatch(labels, i, m), cfg)
                grads = tree_map(torch.add, grads, g)
                lsum = lsum + l
                # dead once summed, as in the reference's scan body: the
                # last microbatch's tree must not live through the update
                del l, _p, g
            grads = tree_map(lambda g: g / m, grads)
            loss = lsum / m
        grads, grad_sqnorm = pod_sync(_like(grads, params))
        with trace.region("update"):
            new_params, new_opt, om = adamw_update(params, grads, opt_state,
                                                   opt_cfg,
                                                   grad_sqnorm=grad_sqnorm)
        metrics = {"loss": loss, **om,
                   "tokens": torch.full((), inputs.shape[0] * inputs.shape[1],
                                        dtype=torch.float32,
                                        device=inputs.device)}
        return new_params, new_opt, {k: _plain(v) for k, v in metrics.items()}

    def train_step(params: dict, opt_state: dict, batch: dict):
        with _on_mesh():
            return step(params, opt_state, batch)

    return train_step


def _on_mesh():
    """DTensor's ``implicit_replication`` when a mesh is registered (plain
    tensors made inside the model act as replicated)."""
    return (implicit_replication() if get_mesh() is not None
            else contextlib.nullcontext())


# --------------------------------------------------------------- serve step
def make_prefill_step(cfg: ModelConfig):
    """``(params, inputs) -> (logits of the last position, caches)``."""
    def prefill_step(params: dict, inputs):
        with torch.no_grad(), _on_mesh():
            return forward(params, inputs, cfg, return_cache=True,
                           logits_mode="last")
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``(params, cache, tokens) -> (logits, cache)``: one append at each
    row's length (the KV caches are written in place)."""
    def decode_step(params: dict, cache: dict, tokens):
        with torch.no_grad(), _on_mesh():
            return forward(params, tokens, cfg, cache=cache,
                           logits_mode="last")
    return decode_step


def serve_shardings(mesh, cfg: ModelConfig, batch: int, max_seq: int):
    """(param_shardings, cache_shardings, param_shapes, cache_shapes):
    params and caches on the ``meta`` device, placed by the rule table over
    ``param_axes`` and ``cache_axes``."""
    p_shapes, _ = abstract_state(cfg)
    p_sh = tree_shardings(mesh, param_axes(cfg), p_shapes)
    c_shapes = init_cache(cfg, batch, max_seq, device="meta")
    c_sh = tree_shardings(mesh, cache_axes(cfg), c_shapes)
    return p_sh, c_sh, p_shapes, c_shapes
