"""Decoder LM of every family of the reference, without a KV cache.

  * dense / vlm / audio — GQA attention + GLU MLP blocks (vlm and audio
    differ only in the stubbed modality frontend, ``frontend="embed"``:
    (B, S, d) inputs and no ``embed`` parameter, and M-RoPE);
  * moe    — attention + sort-based capacity MoE blocks;
  * ssm    — Mamba2 (SSD) blocks, attention-free;
  * hybrid — Mamba2 backbone with ONE weight-shared transformer block applied
    after every ``shared_attn_every`` SSM layers (Zamba2); the SSM layers
    are stacked in (group, layer-in-group) shape, remaining layers in a
    ``tail``.

Parameters are a plain nested dict with the reference's layout: per-layer
weights are stacked along leading layer axes (``layers``, ``groups``,
``tail``) and sliced per layer at run time (``_tree_at``), so each layer of
each step sees fresh views — the counterpart of the fresh JAX slices, which
is what makes the instrumented event stream match the reference.  A
persistent per-layer module list would register each weight once and never
free it.  The hybrid's ``shared`` block is not stacked and is handed to
every group as the same tensors, registered once, as the reference does.
Run the instrumented forward under ``torch.inference_mode()``: an autograd
graph would keep inputs alive and change the stream.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.instrument import op_hook
from .config import ModelConfig
from . import layers as L
from . import mamba2 as M
from . import moe as MOE

FAMILIES = ("dense", "vlm", "audio", "moe", "ssm", "hybrid")
ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")
FRONTENDS = ("none", "embed")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a family or a frontend that the reference does not have."""
    if cfg.family not in FAMILIES or cfg.frontend not in FRONTENDS:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} / frontend {cfg.frontend!r}; "
            f"the families are {', '.join(FAMILIES)} and the frontends "
            f"{', '.join(FRONTENDS)}")


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Random parameters from ``seed`` (``torch.Generator`` on ``device``),
    laid out as the reference's ``init_params`` lays them out."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.param_dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    p: dict = {}
    if cfg.frontend == "none":
        p["embed"] = torch.randn((v, d), generator=gen, dtype=dt,
                                 device=device).mul_(0.02)
    if not cfg.tie_embeddings and v:
        p["lm_head"] = torch.randn((d, v), generator=gen, dtype=dt,
                                   device=device).mul_(1.0 / math.sqrt(d))
    p["final_norm"] = torch.zeros((d,), dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def mamba_stack(lead):
        return {"ln": zeros(*lead, d),
                "mamba": M.init_mamba2(cfg, lead, gen, dt, device)}

    if cfg.family in ATTN_FAMILIES:
        p["layers"] = {"attn": L.init_attention(cfg, (n,), gen, dt, device),
                       "ln1": zeros(n, d), "ln2": zeros(n, d)}
        if cfg.family == "moe":
            p["layers"]["moe"] = MOE.init_moe(cfg, (n,), gen, dt, device)
        else:
            p["layers"]["mlp"] = L.init_mlp(cfg, (n,), gen, dt, device)
    elif cfg.family == "ssm":
        p["layers"] = mamba_stack((n,))
    else:
        every = cfg.shared_attn_every
        n_groups = n // every
        tail = n - n_groups * every
        p["groups"] = mamba_stack((n_groups, every))
        if tail:
            p["tail"] = mamba_stack((tail,))
        p["shared"] = {"ln1": zeros(d), "ln2": zeros(d),
                       "attn": L.init_attention(cfg, (), gen, dt, device),
                       "mlp": L.init_mlp(cfg, (), gen, dt, device)}
    return p


def _tree_at(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked tree, keys in sorted order (the order JAX
    rebuilds a dict pytree in, which fixes the order the slices die in)."""
    return {k: _tree_at(tree[k], i) if isinstance(tree[k], dict)
            else tree[k][i] for k in sorted(tree)}


def _n_stacked(tree: dict, axis: int = 0) -> int:
    """Length of the stacked tree's leading ``axis``."""
    leaf = tree
    while isinstance(leaf, dict):
        leaf = leaf[next(iter(leaf))]
    return leaf.shape[axis]


def _attn_block(blk, h, cfg, positions):
    a, new_cache = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"],
                                                      cfg.rmsnorm_eps),
                               cfg, positions)
    h = h + a
    if "moe" in blk:
        y, aux = MOE.moe_layer(blk["moe"], L.rmsnorm(h, blk["ln2"],
                                                     cfg.rmsnorm_eps), cfg)
    else:
        y = L.mlp(blk["mlp"], L.rmsnorm(h, blk["ln2"], cfg.rmsnorm_eps), cfg)
        aux = {}
    return h + y, new_cache, aux


def _mamba_block(blk, h, cfg):
    y, new_state = M.mamba2_layer(blk["mamba"],
                                  L.rmsnorm(h, blk["ln"], cfg.rmsnorm_eps),
                                  cfg)
    return h + y, new_state


def forward(params: dict, inputs: torch.Tensor, cfg: ModelConfig):
    """inputs: (B,S) int32 tokens, or (B,S,d) embeddings (the ``embed``
    frontend stub).  Returns (logits, None) — the second slot is the
    reference's cache, which this path never builds."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.dtype)
    if inputs.dim() == 2 and cfg.frontend == "none":
        h = params["embed"].to(dt)[inputs]
        op_hook("embed.lookup", (inputs, params["embed"]), (h,))
    else:
        h = inputs.to(dt)
    b, s = h.shape[0], h.shape[1]
    positions = torch.arange(s, device=h.device)[None, :].expand(b, s)
    if cfg.family in ATTN_FAMILIES:
        h, new_cache = _run_stacked_attn(params, h, cfg, positions)
    elif cfg.family == "ssm":
        h, new_cache = _run_stacked_ssm(params, h, cfg)
    else:
        h, new_cache = _run_hybrid(params, h, cfg, positions)
    h = L.rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    if cfg.tie_embeddings and "embed" in params:
        logits = torch.einsum("bsd,vd->bsv", h, params["embed"].to(dt))
    elif "lm_head" in params:
        logits = torch.einsum("bsd,dv->bsv", h, params["lm_head"].to(dt))
    else:
        logits = h
    op_hook("lm_head", (h,), (logits,))
    return logits, new_cache


def _run_stacked_attn(params, h, cfg, positions):
    layers = params["layers"]
    n = _n_stacked(layers)
    for i in range(n):
        op_hook(f"layer{i}", (h,), ())
        h, _kv, _aux = _attn_block(_tree_at(layers, i), h, cfg, positions)
    return h, None


def _run_stacked_ssm(params, h, cfg):
    layers = params["layers"]
    n = _n_stacked(layers)
    for i in range(n):
        op_hook(f"layer{i}", (h,), ())
        h, _st = _mamba_block(_tree_at(layers, i), h, cfg)
    return h, None


def _run_hybrid(params, h, cfg, positions):
    shared = params["shared"]
    groups = params["groups"]
    n_g = _n_stacked(groups)
    every = _n_stacked(groups, 1)
    for gi in range(n_g):
        for li in range(every):
            op_hook(f"group{gi}.layer{li}", (h,), ())
            h, _ = _mamba_block(_tree_at(_tree_at(groups, gi), li), h, cfg)
        op_hook(f"group{gi}.shared_attn", (h,), ())
        h, _kv, _aux = _attn_block(shared, h, cfg, positions)
    if "tail" in params:
        n_t = _n_stacked(params["tail"])
        for ti in range(n_t):
            h, _ = _mamba_block(_tree_at(params["tail"], ti), h, cfg)
    return h, None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4):
    """Mean next-token CE in f32 (+ z-loss for logit drift)."""
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    zl = z_loss * torch.square(lse)
    return (nll + zl).mean(), {"ce": nll.mean(), "z": zl.mean()}
