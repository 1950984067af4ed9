"""Mixture-of-Experts layer: sort-based capacity dispatch + block-diagonal
expert matmuls, on one device.

  1. router: softmax(x @ Wg) in f32 → top-k experts + gates per token;
  2. stable argsort of the (T·k) expert assignments → contiguous groups;
  3. rank-in-group via group starts (searchsorted); tokens past the per-
     expert capacity C are dropped (standard capacity semantics);
  4. scatter token rows into the (E, C, d) buffer; two batched einsums
     (SwiGLU) over the expert dim; gather back; gate-weighted sum over k.

The reference splits the tokens into G groups, G = the data-parallel
degree, and dispatches each group on its own shard.  On one device G = 1:
the group axis stays (so the hooked tensors have the reference's shapes)
and holds one group.  Shared experts run densely for every token.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.instrument import op_hook
from .config import ModelConfig
from .layers import _silu, normal_init


def init_moe(cfg: ModelConfig, lead: tuple, gen: torch.Generator, dtype,
             device) -> dict:
    """MoE weights with leading axes ``lead``; the router is float32
    whatever ``dtype`` is."""
    d, f, e = cfg.d_model, cfg.d_ff_expert, cfg.n_experts
    normal = normal_init(lead, gen, dtype, device)
    s_in, s_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    p = {
        "router": normal_init(lead, gen, torch.float32, device)((d, e), s_in),
        "w_gate": normal((e, d, f), s_in),
        "w_up": normal((e, d, f), s_in),
        "w_down": normal((e, f, d), s_out),
    }
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["ws_gate"] = normal((d, fs), s_in)
        p["ws_up"] = normal((d, fs), s_in)
        p["ws_down"] = normal((fs, d), s_out)
    return p


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


def moe_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,d). Returns (y, aux) with load-balancing stats."""
    dt = x.dtype
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.n_experts_active
    t = b * s
    g = 1
    tl = t // g
    xt = x.reshape(g, tl, d)

    # ---- router (f32) -----------------------------------------------------
    logits = torch.einsum("gtd,de->gte", xt.to(torch.float32), p["router"])
    probs = torch.softmax(logits, dim=-1)

    cap = int(math.ceil(tl * k / e * cfg.capacity_factor))
    cap = max(4, min(cap, tl))
    xe, meta = _dispatch_group(xt[0], probs[0], k, e, cap, dt)
    xe = xe[None]                                          # (g,e,cap,d)

    # ---- expert SwiGLU (block-diagonal over experts) ------------------------
    gt = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(dt))
    u = torch.einsum("gecd,edf->gecf", xe, p["w_up"].to(dt))
    h = _silu(gt) * u
    ye = torch.einsum("gecf,efd->gecd", h, p["w_down"].to(dt))
    op_hook("moe.experts", (xe, p["w_gate"], p["w_up"], p["w_down"]), (ye,))

    y = _combine_group(ye[0], *meta, k, dt)[None]

    # ---- shared experts (dense) --------------------------------------------
    if cfg.n_shared_experts:
        sg = torch.einsum("gtd,df->gtf", xt, p["ws_gate"].to(dt))
        su = torch.einsum("gtd,df->gtf", xt, p["ws_up"].to(dt))
        y = y + torch.einsum("gtf,fd->gtd", _silu(sg) * su,
                             p["ws_down"].to(dt))

    # load-balance aux loss (Switch-style)
    me = probs.mean(dim=(0, 1))                            # (e,)
    _gates, _order, slot, keep = meta
    flat_e = torch.clamp(slot // cap, 0, e - 1)
    ce = torch.zeros((e,), dtype=torch.float32, device=x.device).index_add_(
        0, flat_e.reshape(-1), keep.reshape(-1).to(torch.float32)) / (t * k)
    aux = {"lb_loss": e * torch.sum(me * ce),
           "dropped_frac": 1.0 - keep.to(torch.float32).mean()}
    y = y.reshape(b, s, d)
    return y, aux
