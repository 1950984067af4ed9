"""Decoder LM of the dense family (GQA attention + GLU MLP blocks), without
a KV cache.

Parameters are a plain nested dict with the reference's layout: per-layer
weights are stacked along a leading layer axis under ``params["layers"]``
and sliced per layer at run time (``_tree_at``), so each layer of each step
sees fresh views — the counterpart of the fresh JAX slices, which is what
makes the instrumented event stream match the reference.  A persistent
per-layer module list would register each weight once and never free it.
Run the instrumented forward under ``torch.inference_mode()``: an autograd
graph would keep inputs alive and change the stream.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.instrument import op_hook
from .config import ModelConfig
from . import layers as L


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configurations outside the ported dense path."""
    if cfg.family != "dense" or cfg.frontend != "none" or cfg.m_rope \
            or cfg.qk_norm:
        raise NotImplementedError(
            f"{cfg.name}: only the dense family with token inputs, plain "
            "RoPE and no qk-norm is ported")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (``torch.Generator`` on ``device``),
    laid out as the reference's ``init_params`` lays them out."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    p: dict = {"embed": torch.randn((v, d), generator=gen, dtype=dt,
                                    device=device).mul_(0.02)}
    if not cfg.tie_embeddings:
        p["lm_head"] = torch.randn((d, v), generator=gen, dtype=dt,
                                   device=device).mul_(1.0 / math.sqrt(d))
    p["final_norm"] = torch.zeros((d,), dtype=dt, device=device)
    p["layers"] = {
        "attn": L.init_attention(cfg, n, gen, dt, device),
        "ln1": torch.zeros((n, d), dtype=dt, device=device),
        "ln2": torch.zeros((n, d), dtype=dt, device=device),
        "mlp": L.init_mlp(cfg, n, gen, dt, device),
    }
    return p


def _tree_at(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree, keys in sorted order (the order JAX
    rebuilds a dict pytree in, which fixes the order the slices die in)."""
    return {k: _tree_at(tree[k], i) if isinstance(tree[k], dict)
            else tree[k][i] for k in sorted(tree)}


def _attn_block(blk, h, cfg, positions):
    a, new_cache = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"],
                                                      cfg.rmsnorm_eps),
                               cfg, positions)
    h = h + a
    y = L.mlp(blk["mlp"], L.rmsnorm(h, blk["ln2"], cfg.rmsnorm_eps), cfg)
    aux = {}
    return h + y, new_cache, aux


def forward(params: dict, inputs: torch.Tensor, cfg: ModelConfig):
    """inputs: (B,S) int32 tokens.  Returns (logits, None) — the second
    slot is the reference's cache, which this path never builds."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.dtype)
    h = params["embed"].to(dt)[inputs]
    op_hook("embed.lookup", (inputs, params["embed"]), (h,))
    b, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    h, new_cache = _run_stacked_attn(params, h, cfg, positions)
    h = L.rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    if cfg.tie_embeddings:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"].to(dt))
    else:
        logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"].to(dt))
    op_hook("lm_head", (h,), (logits,))
    return logits, new_cache


def _run_stacked_attn(params, h, cfg, positions):
    layers = params["layers"]
    n = layers["ln1"].shape[0]
    for i in range(n):
        op_hook(f"layer{i}", (h,), ())
        h, _kv, _aux = _attn_block(_tree_at(layers, i), h, cfg, positions)
    return h, None
