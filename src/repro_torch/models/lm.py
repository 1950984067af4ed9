"""Decoder LM of every family of the reference, with its decode caches.

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

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core import trace
from repro_torch.core.instrument import capturing, op_hook
from repro_torch.dist.sharding import (einsum, get_mesh, placed, shard,
                                       take_rows)
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


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                shardings: dict | None = None) -> dict:
    """Random parameters from ``seed`` (``torch.Generator`` on ``device``),
    laid out as the reference's ``init_params`` lays them out.

    ``shardings``: a tree of DTensor placements on the registered mesh
    (``train.trainer.serve_shardings`` gives one).  Each leaf is placed as
    soon as it is made, this rank keeping its block of it: every rank
    draws the same values in the same order, so no bytes move, the values
    are the one-device ``init_params``'s, and a rank holds its placed
    blocks and at most one whole leaf."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.param_dtype)
    # the meta device (shapes only) has no generator: draw from the CPU's
    meta = torch.device(device).type == "meta"
    gen = torch.Generator(device="cpu" if meta else device).manual_seed(seed)
    mesh = get_mesh()
    if shardings is not None and mesh is None:
        raise ValueError("init_params(shardings=) needs a registered mesh")

    def at(*path):
        """The ``place`` of the subtree at ``path``."""
        if shardings is None:
            return L.kept
        node = shardings
        for key in path:
            node = node[key]
        return lambda key, leaf: placed(leaf, mesh, node[key])

    n, d, v = cfg.n_layers, cfg.d_model, cfg.vocab_size
    top = at()
    p: dict = {}
    if cfg.frontend == "none":
        p["embed"] = top("embed", torch.randn(
            (v, d), generator=gen, dtype=dt, device=device).mul_(0.02))
    if not cfg.tie_embeddings and v:
        p["lm_head"] = top("lm_head", torch.randn(
            (d, v), generator=gen, dtype=dt,
            device=device).mul_(1.0 / math.sqrt(d)))
    p["final_norm"] = top("final_norm",
                          torch.zeros((d,), dtype=dt, device=device))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def mamba_stack(lead, *path):
        return {"ln": at(*path)("ln", zeros(*lead, d)),
                "mamba": M.init_mamba2(cfg, lead, gen, dt, device,
                                       at(*path, "mamba"))}

    def attn_block(lead, *path):
        put = at(*path)
        return {"attn": L.init_attention(cfg, lead, gen, dt, device,
                                         at(*path, "attn")),
                "ln1": put("ln1", zeros(*lead, d)),
                "ln2": put("ln2", zeros(*lead, d))}

    if cfg.family in ATTN_FAMILIES:
        p["layers"] = attn_block((n,), "layers")
        if cfg.family == "moe":
            p["layers"]["moe"] = MOE.init_moe(cfg, (n,), gen, dt, device,
                                              at("layers", "moe"))
        else:
            p["layers"]["mlp"] = L.init_mlp(cfg, (n,), gen, dt, device,
                                            at("layers", "mlp"))
    elif cfg.family == "ssm":
        p["layers"] = mamba_stack((n,), "layers")
    else:
        every = cfg.shared_attn_every
        n_groups = n // every
        tail = n - n_groups * every
        p["groups"] = mamba_stack((n_groups, every), "groups")
        if tail:
            p["tail"] = mamba_stack((tail,), "tail")
        put = at("shared")
        p["shared"] = {"ln1": put("ln1", zeros(d)),
                       "ln2": put("ln2", zeros(d)),
                       "attn": L.init_attention(cfg, (), gen, dt, device,
                                                at("shared", "attn")),
                       "mlp": L.init_mlp(cfg, (), gen, dt, device,
                                         at("shared", "mlp"))}
    return p


def param_axes(cfg: ModelConfig) -> dict:
    """Logical sharding axes mirroring the parameter tree (a leading
    ``"p_layers"`` per stacked axis)."""
    def stack(d, extra=1):
        return {k: stack(v, extra) if isinstance(v, dict)
                else ("p_layers",) * extra + tuple(v) for k, v in d.items()}

    axes: dict = {"final_norm": (None,)}
    if cfg.frontend == "none":
        axes["embed"] = ("p_vocab", "p_embed")
    if not cfg.tie_embeddings and cfg.vocab_size:
        axes["lm_head"] = ("p_embed", "p_vocab")
    attn = L.attention_param_axes()
    if cfg.qk_norm is False:
        attn = {k: v for k, v in attn.items() if k not in ("q_norm",
                                                            "k_norm")}
    blk_attn = {"ln1": (None,), "ln2": (None,), "attn": attn}
    mamba = {"ln": (None,), "mamba": M.mamba2_param_axes()}
    if cfg.family in ("dense", "vlm", "audio"):
        axes["layers"] = stack({**blk_attn, "mlp": L.mlp_param_axes()})
    elif cfg.family == "moe":
        axes["layers"] = stack({**blk_attn, "moe": MOE.moe_param_axes(cfg)})
    elif cfg.family == "ssm":
        axes["layers"] = stack(mamba)
    elif cfg.family == "hybrid":
        axes["groups"] = stack(mamba, extra=2)
        if cfg.n_layers % cfg.shared_attn_every:
            axes["tail"] = stack(mamba)
        axes["shared"] = {**blk_attn, "mlp": L.mlp_param_axes()}
    return axes


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


def _attn_block(blk, h, cfg, positions, cache=None):
    a, new_cache = L.attention(blk["attn"], L.rmsnorm(h, blk["ln1"],
                                                      cfg.rmsnorm_eps),
                               cfg, positions, cache)
    h = h + a
    if "moe" in blk:
        y, aux = MOE.moe_layer(blk["moe"], L.rmsnorm(h, blk["ln2"],
                                                     cfg.rmsnorm_eps), cfg)
    else:
        y = L.mlp(blk["mlp"], L.rmsnorm(h, blk["ln2"], cfg.rmsnorm_eps), cfg)
        aux = {}
    return h + y, new_cache, aux


def _mamba_block(blk, h, cfg, state=None):
    y, new_state = M.mamba2_layer(blk["mamba"],
                                  L.rmsnorm(h, blk["ln"], cfg.rmsnorm_eps),
                                  cfg, state)
    return h + y, new_state


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device="cuda") -> dict:
    """Decode caches, zero-initialized on ``device`` (filled by prefill):
    ``{"kv": {"k","v": (layers, B, max_seq, Hkv, D), "length": (B,)}}``
    for the attention families; SSM states (conv tails in the compute
    dtype, the scan state in float32) for ssm; both for hybrid, with one
    KV slot per shared-attention application.  ``kv_two_tier`` (not for
    hybrid, as the reference) adds the recent buffers ``"rk"``, ``"rv"``
    (layers, B, kv_recent_len, Hkv, D) and ``"main_len"`` (B,)."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.dtype)

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def length():
        return zeros(batch, dtype=torch.int32)

    def kv(n):
        shape = (n, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        out = {"k": zeros(*shape), "v": zeros(*shape), "length": length()}
        if cfg.kv_two_tier and cfg.family != "hybrid":
            recent = (n, batch, cfg.kv_recent_len, cfg.n_kv_heads,
                      cfg.head_dim)
            out.update(rk=zeros(*recent), rv=zeros(*recent),
                       main_len=length())
        return out

    def ssm(*lead):
        gs = cfg.ssm_groups * cfg.ssm_state
        w = cfg.ssm_conv_width - 1
        return {"conv_x": zeros(*lead, batch, w, cfg.d_inner),
                "conv_B": zeros(*lead, batch, w, gs),
                "conv_C": zeros(*lead, batch, w, gs),
                "ssm": zeros(*lead, batch, cfg.ssm_heads, cfg.ssm_head_dim,
                             cfg.ssm_state, dtype=torch.float32)}

    if cfg.family in ATTN_FAMILIES:
        return {"kv": kv(cfg.n_layers)}
    if cfg.family == "ssm":
        return {"ssm": ssm(cfg.n_layers), "length": length()}
    every = cfg.shared_attn_every
    n_groups = cfg.n_layers // every
    tail = cfg.n_layers - n_groups * every
    out = {"kv": kv(n_groups), "ssm_groups": ssm(n_groups, every)}
    if tail:
        out["ssm_tail"] = ssm(tail)
    return out


def cache_axes(cfg: ModelConfig) -> dict:
    """Logical sharding for caches: KV sequence shards over `model` (SP
    flash-decode), batch over data axes; SSM heads over `model`; the
    two-tier recent buffers are sequence-replicated."""
    kv = {"k": (None, "batch", "seq_sp", None, None),
          "v": (None, "batch", "seq_sp", None, None),
          "length": (None,)}
    if cfg.kv_two_tier and cfg.family != "hybrid":
        kv.update({"rk": (None, "batch", None, None, None),
                   "rv": (None, "batch", None, None, None),
                   "main_len": (None,)})

    def ssm(n):
        return {"conv_x": (None,) * n + ("batch", None, "p_ssm_inner"),
                "conv_B": (None,) * n + ("batch", None, None),
                "conv_C": (None,) * n + ("batch", None, None),
                "ssm": (None,) * n + ("batch", "ssm_heads", None, None)}

    if cfg.family in ATTN_FAMILIES:
        return {"kv": kv}
    if cfg.family == "ssm":
        return {"ssm": ssm(1), "length": (None,)}
    out = {"kv": kv, "ssm_groups": ssm(2)}
    if cfg.n_layers % cfg.shared_attn_every:
        out["ssm_tail"] = ssm(1)
    return out


def _cache_length(cache: dict, cfg: ModelConfig):
    if "kv" in cache:
        return cache["kv"]["length"]
    # pure ssm: the serve engine keeps a length entry
    length = cache.get("length")
    if length is None:
        leaf = next(iter(cache["ssm"].values()))
        length = torch.zeros((1,), dtype=torch.int32, device=leaf.device)
    return length


def _stack_states(states: list) -> dict:
    """[{leaf: (B, ...)}] per layer -> {leaf: (layers, B, ...)}."""
    return {k: torch.stack([st[k] for st in states]) for k in states[0]}


def _kv_plan(kv: dict, s: int):
    """The write plan (and paged gather table) every layer of one forward
    shares: built once per forward, not once per layer.  The two-tier
    cache writes its recent buffer at one offset and needs none, and a
    sharded (DTensor) slot cache plans each rank's block itself.  A
    placed paged pool keeps every row on every rank (its blocks split
    only the KV heads), so its plan is the plain one."""
    if "rk" in kv or isinstance(kv.get("k"), DTensor):
        return None
    if "pk" in kv:
        return L.paged_plan(kv["bt"], kv["length"], s, kv["pk"].shape[1],
                            kv["pk"].shape[2])
    return L.dense_plan(kv["length"], s, kv["k"].shape[2])


def _kv_layer(kv: dict, i: int, plan) -> dict:
    """Layer ``i``'s slice of a dense (or two-tier) KV cache; the slices
    are views, written in place."""
    out = {"k": kv["k"][i], "v": kv["v"][i], "length": kv["length"],
           "plan": plan}
    if "rk" in kv:
        out.update(rk=kv["rk"][i], rv=kv["rv"][i], main_len=kv["main_len"])
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def forward(params: dict, inputs: torch.Tensor, cfg: ModelConfig,
            cache: dict | None = None, positions: torch.Tensor | None = None,
            return_cache: bool = False, logits_mode: str = "all",
            logits_index: torch.Tensor | None = None):
    """inputs: (B,S) int32 tokens, or (B,S,d) embeddings (the ``embed``
    frontend stub).  Returns (logits, new_cache_or_None).

    ``return_cache=True`` without an input cache collects the prefill
    KV/SSM caches.  With ``cache`` (from :func:`init_cache`, a serving
    pool, or a prefill padded with ``serve.cache.pad_cache_to``) the S
    tokens append at each row's length: KV is written into the cache in
    place, SSM states come back as new tensors.  ``logits_mode="last"``
    runs the lm_head on the last position only; ``"index"`` on per-row
    positions from ``logits_index`` — (B,) for a ragged right-padded
    prefill, or (B, P) for several positions per row (a speculative
    verify).  The layer loops of the cached and ``return_cache`` paths
    run with the operator hooks silent, as the reference's ``lax.scan``
    traces them."""
    check_supported(cfg)
    dt = L.torch_dtype(cfg.dtype)
    if inputs.dim() == 2 and cfg.frontend == "none":
        h = take_rows(params["embed"].to(dt), inputs)
        op_hook("embed.lookup", (inputs, params["embed"]), (h,))
    else:
        h = inputs.to(dt)
    b, s = h.shape[0], h.shape[1]
    h = shard(h, "batch", "seq", "embed")
    if positions is None:
        arange = torch.arange(s, device=h.device)[None, :]
        if cache is not None:
            positions = _cache_length(cache, cfg)[:, None] + arange
        else:
            positions = arange.expand(b, s)
    run = {"ssm": _run_stacked_ssm, "hybrid": _run_hybrid}.get(
        cfg.family, _run_stacked_attn)
    keep = cache is not None or return_cache
    with capturing() if keep else contextlib.nullcontext():
        h, new_cache = run(params, h, cfg, positions, cache, return_cache)
    h = L.rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    if logits_mode == "last":
        h = h[:, -1:, :]          # serving: lm_head on the new token only
    elif logits_mode == "index":
        idx = logits_index.long()
        if idx.dim() == 1:
            idx = idx[:, None]
        h = _take_positions(h, idx)
    if cfg.tie_embeddings and "embed" in params:
        logits = einsum("bsd,vd->bsv", h, params["embed"].to(dt))
    elif "lm_head" in params:
        logits = einsum("bsd,dv->bsv", h, params["lm_head"].to(dt))
    else:
        logits = h
    logits = shard(logits, "batch", "seq", "vocab")
    op_hook("lm_head", (h,), (logits,))
    return logits, new_cache


def _take_positions(h, idx):
    """``h[b, idx[b, p]]`` (B, P, d); on a DTensor, each rank gathers its
    own rows: DTensor's rule for the gather differs between torch
    releases."""
    if not isinstance(h, DTensor):
        return torch.gather(h, 1, idx[..., None].expand(-1, -1, h.shape[-1]))
    mesh = h.device_mesh
    h = h.redistribute(mesh, [Replicate() if p.is_shard(1) else p
                              for p in h.placements])
    r0, r1 = L._block(h, 0)
    local = h.to_local()
    out = torch.gather(local, 1, idx[r0:r1, :, None].expand(
        -1, -1, local.shape[-1]))
    return DTensor.from_local(out, mesh, h.placements, run_check=False)


def _run_stacked_attn(params, h, cfg, positions, cache=None,
                      return_cache=False):
    layers = params["layers"]
    n = _n_stacked(layers)
    b, s = h.shape[0], h.shape[1]
    if cache is None:
        ks, vs = [], []
        for i in trace.loop("layers", n):
            op_hook(f"layer{i}", (h,), ())
            h, kv, _aux = _attn_block(_tree_at(layers, i), h, cfg, positions)
            if return_cache:
                ks.append(kv["k"])
                vs.append(kv["v"])
        if not return_cache:
            return h, None
        return h, {"kv": {"k": torch.stack(ks), "v": torch.stack(vs),
                          "length": torch.full((b,), s, dtype=torch.int32,
                                               device=h.device)}}
    kv = cache["kv"]
    plan = _kv_plan(kv, s)
    paged = "pk" in kv
    if paged:
        # a placed pool: each rank's block of KV heads, written in place
        heads = L._block(kv["pk"], 3) if isinstance(kv["pk"], DTensor) \
            else None
        pk, pv = ((kv["pk"].to_local(), kv["pv"].to_local()) if heads
                  else (kv["pk"], kv["pv"]))
    for i in trace.loop("layers", n):
        if paged:
            kv_i = {"pk": pk[i], "pv": pv[i], "bt": kv["bt"],
                    "length": kv["length"], "plan": plan, "heads": heads}
        else:
            kv_i = _kv_layer(kv, i, plan)
        h, _kv, _aux = _attn_block(_tree_at(layers, i), h, cfg, positions,
                                   kv_i)
    return h, {"kv": {**kv, "length": kv["length"] + s}}


def _run_stacked_ssm(params, h, cfg, positions=None, cache=None,
                     return_cache=False):
    del positions                 # attention-free
    layers = params["layers"]
    n = _n_stacked(layers)
    states = []
    for i in trace.loop("layers", n):
        op_hook(f"layer{i}", (h,), ())
        st = _tree_at(cache["ssm"], i) if cache is not None else None
        h, new_st = _mamba_block(_tree_at(layers, i), h, cfg, st)
        if cache is not None or return_cache:
            states.append(new_st)
    if cache is None and not return_cache:
        return h, None
    s = h.shape[1]
    if cache is None:
        return h, {"ssm": _stack_states(states),
                   "length": torch.full((h.shape[0],), s, dtype=torch.int32,
                                        device=h.device)}
    return h, {"ssm": _stack_states(states),
               "length": cache.get("length", 0) + s}


def _run_hybrid(params, h, cfg, positions, cache=None, return_cache=False):
    shared = params["shared"]
    groups = params["groups"]
    n_g = _n_stacked(groups)
    every = _n_stacked(groups, 1)
    keep = cache is not None or return_cache
    b, s = h.shape[0], h.shape[1]
    kv = cache["kv"] if cache is not None else None
    plan = _kv_plan(kv, s) if kv is not None else None
    group_states, ks, vs = [], [], []
    for gi in trace.loop("layers", n_g):
        states = []
        for li in range(every):
            op_hook(f"group{gi}.layer{li}", (h,), ())
            st = (_tree_at(_tree_at(cache["ssm_groups"], gi), li)
                  if cache is not None else None)
            h, new_st = _mamba_block(_tree_at(_tree_at(groups, gi), li), h,
                                     cfg, st)
            if keep:
                states.append(new_st)
        op_hook(f"group{gi}.shared_attn", (h,), ())
        kv_i = None
        if kv is not None:
            kv_i = _kv_layer(kv, gi, plan)
        h, new_kv, _aux = _attn_block(shared, h, cfg, positions, kv_i)
        if keep:
            group_states.append(_stack_states(states))
            ks.append(new_kv["k"])
            vs.append(new_kv["v"])
    tail_states = []
    if "tail" in params:
        n_t = _n_stacked(params["tail"])
        for ti in range(n_t):
            st = (_tree_at(cache["ssm_tail"], ti)
                  if cache is not None else None)
            h, new_st = _mamba_block(_tree_at(params["tail"], ti), h, cfg,
                                     st)
            if keep:
                tail_states.append(new_st)
    if not keep:
        return h, None
    if kv is not None:
        new_kv = {**kv, "length": kv["length"] + s}
    else:
        new_kv = {"k": torch.stack(ks), "v": torch.stack(vs),
                  "length": torch.full((b,), s, dtype=torch.int32,
                                       device=h.device)}
    new_cache = {"kv": new_kv, "ssm_groups": _stack_states(group_states)}
    if tail_states:
        new_cache["ssm_tail"] = _stack_states(tail_states)
    return h, new_cache


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  z_loss: float = 1e-4):
    """Mean next-token CE in f32 (+ z-loss for logit drift).  A DTensor's
    vocab dimension is replicated first: DTensor's gather over a sharded
    class dimension fails."""
    if isinstance(logits, DTensor):
        last = logits.dim() - 1
        logits = logits.redistribute(placements=[
            Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in logits.placements])
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    zl = z_loss * torch.square(lse)
    return (nll + zl).mean(), {"ce": nll.mean(), "z": zl.mean()}
