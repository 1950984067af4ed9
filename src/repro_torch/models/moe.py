"""Mixture-of-Experts layer: sort-based capacity dispatch + block-diagonal
expert matmuls, on one device.

  1. router: softmax(x @ Wg) in f32 → top-k experts + gates per token;
  2. stable argsort of the (T·k) expert assignments → contiguous groups;
  3. rank-in-group via group starts (searchsorted); tokens past the per-
     expert capacity C are dropped (standard capacity semantics);
  4. scatter token rows into the (E, C, d) buffer; two batched einsums
     (SwiGLU) over the expert dim; gather back; gate-weighted sum over k.

The tokens split into G groups, G = the data-parallel degree
(``pod`` × ``data``), and each group is dispatched on its own shard: on a
mesh each rank runs the sort-based dispatch on the local block of its
groups (``to_local``/``from_local``, as the reference's vmap runs inside
its shard), since the dispatch's ``searchsorted`` has no DTensor rule.
On one device G = 1 and the group axis holds one group.  Expert hidden
dims shard over ``model`` (TP-MoE); shared experts run densely for every
token.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.core.instrument import op_hook
from repro_torch.dist.sharding import einsum, mesh_axis_size, shard
from .config import ModelConfig
from .layers import _silu, kept, normal_init


def init_moe(cfg: ModelConfig, lead: tuple, gen: torch.Generator, dtype,
             device, place=kept) -> dict:
    """MoE weights with leading axes ``lead``, each handed to
    ``place(key, weight)`` as it is drawn; the router is float32
    whatever ``dtype`` is."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    normal = normal_init(lead, gen, dtype, device, place)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": normal_init(lead, gen, torch.float32, device, place)(
            "router", (d, e), s_in),
        "w_gate": normal("w_gate", (e, d, f), s_in),
        "w_up": normal("w_up", (e, d, f), s_in),
        "w_down": normal("w_down", (e, f, d), s_out),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["ws_gate"] = normal("ws_gate", (d, fs), s_in)
        p["ws_up"] = normal("ws_up", (d, fs), s_in)
        p["ws_down"] = normal("ws_down", (fs, d), s_out)
    return p


def moe_param_axes(cfg: ModelConfig) -> dict:
    """Logical sharding axes of one MoE layer's weights."""
    if cfg.moe_parallelism == "ep":
        # experts over `model`, d_model over `data` (FSDP); hidden dim local
        axes = {
            "router": ("p_embed", None),
            "w_gate": ("p_experts_ep", "p_embed", None),
            "w_up": ("p_experts_ep", "p_embed", None),
            "w_down": ("p_experts_ep", None, "p_embed"),
        }
    else:
        axes = {
            "router": ("p_embed", None),
            "w_gate": ("p_experts", "p_embed", "p_expert_ff"),
            "w_up": ("p_experts", "p_embed", "p_expert_ff"),
            "w_down": ("p_experts", "p_expert_ff", "p_embed"),
        }
    if cfg.n_shared_experts:
        axes.update({"ws_gate": ("p_embed", "p_expert_ff"),
                     "ws_up": ("p_embed", "p_expert_ff"),
                     "ws_down": ("p_expert_ff", "p_embed")})
    return axes


def top_k(probs: torch.Tensor, k: int):
    """The ``k`` largest values along the last axis and their indices, in
    descending order, ties toward the lower index (``jax.lax.top_k``'s
    order, which ``torch.topk`` does not promise)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(xt, probs, k: int, e: int, cap: int, dt):
    """Sort-based capacity dispatch for ONE token group."""
    t = xt.shape[0]
    gates, topk = top_k(probs, k)                          # (t,k)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    flat_e = topk.reshape(t * k)
    order = torch.argsort(flat_e, stable=True)             # (t·k,)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=xt.device))
    rank = torch.arange(t * k, device=xt.device) - starts[sorted_e]
    keep = rank < cap
    slot = sorted_e * cap + torch.clamp(rank, 0, cap - 1)
    slot = torch.where(keep, slot, e * cap)                # overflow row
    src = order // k                                       # source token copy
    d = xt.shape[-1]
    # kept slots are distinct; duplicates land only in the overflow row,
    # which is sliced off
    xe = torch.zeros((e * cap + 1, d), dtype=dt, device=xt.device)
    xe[slot] = xt[src]
    return xe[:e * cap].reshape(e, cap, d), (gates, order, slot, keep)


def _combine_group(ye, gates, order, slot, keep, k: int, dt):
    e, cap, d = ye.shape
    t = gates.shape[0]
    ye_flat = torch.cat([ye.reshape(e * cap, d),
                         torch.zeros((1, d), dtype=dt, device=ye.device)])
    y_copies = torch.where(keep[:, None], ye_flat[slot],
                           torch.zeros((), dtype=dt, device=ye.device))
    y_sorted = torch.zeros((t * k, d), dtype=dt, device=ye.device)
    y_sorted[order] = y_copies
    return (y_sorted.reshape(t, k, d) * gates.to(dt)[..., None]).sum(1)


def _per_group(fn, *xs):
    """``fn`` over the leading group axis of ``xs`` (the reference's
    vmap); outputs (a tensor or tuple of them per group) stacked along a
    new leading axis.  One group: ``fn``'s outputs as views, ``[None]``."""
    outs = [fn(*(x[i] for x in xs)) for i in range(xs[0].shape[0])]

    def stack(parts):
        if isinstance(parts[0], tuple):
            return tuple(stack([p[j] for p in parts])
                         for j in range(len(parts[0])))
        return parts[0][None] if len(parts) == 1 else torch.stack(parts)
    return stack(outs)


def _regroup(x, *shape):
    """``x.reshape(*shape)`` for a reshape that keeps the leading
    (batch-sharded) rows in blocks: on a DTensor laid out over ``batch``
    it reshapes each rank's block, where DTensor's own view rule can give
    the gradient a block of the wrong shape."""
    if not isinstance(x, DTensor):
        return x.reshape(*shape)
    x = shard(x, "batch", *(None,) * (x.dim() - 1))
    n = 1
    for size, p in zip(x.device_mesh.shape, x.placements):
        n *= size if p.is_shard() else 1
    local = x.to_local().reshape(shape[0] // n, *shape[1:])
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False)


def _local(x):
    """The local block of the groups of ``x`` (groups sharded over
    ``batch``, the rest replicated) and the function that wraps a local
    result of that layout back; on a plain tensor, ``x`` and the
    identity."""
    if not isinstance(x, DTensor):
        return x, lambda y: y
    x = shard(x, "batch", *(None,) * (x.dim() - 1))
    return x.to_local(), lambda y: DTensor.from_local(
        y, x.device_mesh, x.placements, run_check=False)


def moe_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,d). Returns (y, aux) with load-balancing stats."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    g = mesh_axis_size("pod") * mesh_axis_size("data")
    while g > 1 and t % g:
        g //= 2
    tl = t // g
    xt = _regroup(x, g, tl, d)
    xt = shard(xt, "batch", None, "embed")

    # ---- router (f32) -----------------------------------------------------
    logits = einsum("gtd,de->gte", xt.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)

    cap = int(math.ceil(tl * k / e * cfg.capacity_factor))
    cap = max(4, min(cap, tl))
    # ---- dispatch, each group on the rank that holds it ---------------------
    xt_l, wrap = _local(xt)
    probs_l, _ = _local(probs)
    xe_l, meta = _per_group(
        lambda xg, pg: _dispatch_group(xg, pg, k, e, cap, dt), xt_l, probs_l)
    xe = wrap(xe_l)
    ep = cfg.moe_parallelism == "ep"
    e_ax = "experts_ep" if ep else "experts"
    f_ax = None if ep else "expert_ff"
    xe = shard(xe, "batch", e_ax, None, "embed")           # (g,e,cap,d)

    # ---- expert SwiGLU (block-diagonal over experts) ------------------------
    gt = einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))
    u = einsum("gecd,edf->gecf", xe, p["w_up"].to(dt))
    gt = shard(gt, "batch", e_ax, None, f_ax)
    u = shard(u, "batch", e_ax, None, f_ax)
    h = _silu(gt) * u
    ye = einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    ye = shard(ye, "batch", e_ax, None, "embed")
    op_hook("moe.experts", (xe, p["w_gate"], p["w_up"], p["w_down"]), (ye,))

    ye_l, _ = _local(ye)
    y = wrap(_per_group(lambda yg, *m: _combine_group(yg, *m, k, dt),
                        ye_l, *meta))

    # ---- shared experts (dense) --------------------------------------------
    if cfg.n_shared_experts:
        sg = einsum("gtd,df->gtf", xt, p["ws_gate"].to(dt))
        su = einsum("gtd,df->gtf", xt, p["ws_up"].to(dt))
        sg = shard(sg, "batch", None, "expert_ff")
        su = shard(su, "batch", None, "expert_ff")
        y = y + einsum("gtf,fd->gtd", _silu(sg) * su,
                             p["ws_down"].to(dt))

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=(0, 1))                            # (e,)
    _gates, _order, slot, keep = meta
    flat_e = torch.clamp(slot // cap, 0, e - 1)
    ce = wrap(torch.zeros((slot.shape[0], e), dtype=torch.float32,
                          device=slot.device).scatter_add_(
        1, flat_e, keep.to(torch.float32))).sum(0) / (t * k)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "dropped_frac": 1.0 - wrap(keep.to(torch.float32)).mean()}
    y = _regroup(y, b, s, d)
    return shard(y, "batch", "seq", "embed"), aux
