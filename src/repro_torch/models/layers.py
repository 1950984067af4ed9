"""Transformer layers: RMSNorm, RoPE/M-RoPE, GQA attention (with optional
qk-norm), GLU MLPs, as plain functions on tensors and dicts of parameters.

Attention paths, as the reference's:

  * ``dense``   — full (S×T) scores; training and short prefill.
  * ``blocked`` — a loop over KV chunks with an online softmax
    (flash-style); prefill longer than ``attn_blocked_threshold``, where
    the S² scores would not fit.
  * ``decode``  — one (or a few) query tokens against a KV cache: a dense
    slot cache ``{"k","v": (B,T,Hkv,D)}`` or a paged block pool
    ``{"pk","pv": (n_blocks,bs,Hkv,D), "bt": (B,blocks) block tables}``,
    each with per-row ``"length"``.  New K/V are written into the cache
    tensors in place (the serving pools are preallocated, where the
    reference donates them to ``jax.jit``).

Numerics follow the JAX reference: matmuls in the config compute dtype
(bf16 at full width) with each weight cast to it, softmax/norm statistics
in f32.  Parameter and activation layouts are the reference's, so the
parity tests compare like with like.  Every operator reports itself
through :func:`~repro_torch.core.instrument.op_hook` under the reference's
operator name; the hooked tensors and the points where they die mirror the
reference, since they decide the instrumented event stream.

In bf16 the activations follow ``jax.nn``'s steps, each rounded to the
input's dtype (``_silu``, ``_gelu``), and the softmax scale is rounded
to the softmax dtype, as the reference's are.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.core.instrument import op_hook
from repro_torch.dist.sharding import einsum, shard
from .config import ModelConfig

NEG_INF = -1e30


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (config dtype names)."""
    dt = getattr(torch, name)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a dtype: {name!r}")
    return dt


# --------------------------------------------------------------------- norms
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


# --------------------------------------------------------------- activations
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float.  Torch applies a
    scalar to a bf16 tensor in float32, as it does a second bf16 tensor,
    then rounds once: so the rounded scalar gives the bits of the same
    operation on two ``dtype`` tensors, with no tensor copied to the
    device (a copy the host waits for)."""
    return float(torch.tensor(value, dtype=dtype))


def _silu(g: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``'s steps, each rounded to ``g``'s dtype
    (``F.silu`` rounds once)."""
    return g * (1 / (1 + torch.exp(-g)))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s tanh form with its constants in ``x``'s dtype,
    each step rounded to that dtype."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    inner = c * (x + _rounded(0.044715, x.dtype) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


# ---------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               m_rope: bool = False) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S), or (B, S, 3) for M-RoPE.
    Rotates the two halves of each head (not interleaved pairs).  M-RoPE
    splits the half into temporal / height / width sections, each rotated
    by its own position; (B, S) positions are the text-only stub, the same
    position in all three."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    inv = rope_freqs(head_dim, theta, x.device)               # (half,)
    if m_rope:
        if positions.dim() == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        s1 = half // 3
        s2 = (half - s1) // 2
        bounds = [0, s1, s1 + s2, half]
        angles = torch.cat(
            [positions[..., i].to(torch.float32)[..., None]
             * inv[bounds[i]:bounds[i + 1]] for i in range(3)], dim=-1)
    else:
        angles = positions.to(torch.float32)[..., None] * inv
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------- attention
def normal_init(lead: tuple, gen: torch.Generator, dtype, device):
    """``normal(shape, scale)``: N(0, scale²) weights of shape
    ``(*lead, *shape)``."""
    def normal(shape, scale):
        return torch.randn((*lead, *shape), generator=gen, dtype=dtype,
                           device=device).mul_(scale)
    return normal


def init_attention(cfg: ModelConfig, lead: tuple, gen: torch.Generator,
                   dtype, device) -> dict:
    """Attention weights with leading axes ``lead`` (``(n_layers,)`` for a
    stack, ``()`` for one block)."""
    d, hd = cfg.d_model, cfg.head_dim
    normal = normal_init(lead, gen, dtype, device)
    s = 1.0 / math.sqrt(d)
    p = {
        "wq": normal((d, cfg.n_heads, hd), s),
        "wk": normal((d, cfg.n_kv_heads, hd), s),
        "wv": normal((d, cfg.n_kv_heads, hd), s),
        "wo": normal((cfg.n_heads, hd, d), 1.0 / math.sqrt(cfg.q_dim)),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=dtype, device=device)
    return p


def attention_param_axes() -> dict:
    """Logical sharding axes of one attention block's weights."""
    return {
        "wq": ("p_embed", "p_heads", None),
        "wk": ("p_embed", "p_kv_heads", None),
        "wv": ("p_embed", "p_kv_heads", None),
        "wo": ("p_heads", None, "p_embed"),
        "q_norm": (None,),
        "k_norm": (None,),
    }


def _qkv(p, x, cfg: ModelConfig, positions):
    dt = x.dtype
    q = einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.m_rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.m_rope)
    q = shard(q, "batch", "seq", "heads", "head_dim")
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    v = shard(v, "batch", "seq", "kv_heads", "head_dim")
    op_hook("attn.qkv_proj", (x, p["wq"], p["wk"], p["wv"]), (q, k, v))
    return q, k, v


def _group(q, n_kv: int):
    """(B,S,H,D) -> (B,S,Hkv,G,D): query head h reads KV head h // G."""
    b, s, h, d_ = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d_)


def _sdpa_dense(q, k, v, causal: bool, q_offset=0,
                softmax_dtype=torch.float32):
    """q:(B,S,Hkv,G,D) k/v:(B,T,Hkv,D).  Full-scores attention: scores in
    ``softmax_dtype``, scaled by 1/sqrt(D) rounded to that dtype, masked
    with NEG_INF, weights cast back to q's dtype before the PV product.
    ``q_offset``: absolute position of query 0 (a slice of the queries)."""
    scale = _rounded(1.0 / math.sqrt(q.shape[-1]), softmax_dtype)
    scores = einsum("bshgd,bthd->bhgst", q, k).to(softmax_dtype) \
        * scale
    if causal:
        s_len, t_len = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(s_len, device=q.device)[:, None] + q_offset
        ki = torch.arange(t_len, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, scores.new_full((), NEG_INF))
    m = scores.amax(dim=-1, keepdim=True).detach()   # stop_gradient
    p = torch.exp(scores - m)
    w = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(*out.shape[:2], -1, out.shape[-1])    # (B,S,H,D)


def _sdpa_blocked(q, k, v, causal: bool, chunk: int = 1024):
    """Flash-style online softmax over KV chunks.  q:(B,S,Hkv,G,D),
    k/v:(B,T,Hkv,D).  The chunk is ``min(chunk, T)``, halved until it
    divides T, as the reference's; scores, running max and sum in float32,
    a causal mask per chunk."""
    b, s, hkv, g, d_ = q.shape
    t = k.shape[1]
    chunk = min(chunk, t)
    while t % chunk:           # shapes are powers of two in practice
        chunk //= 2
    scale = 1.0 / math.sqrt(d_)
    f32 = dict(dtype=torch.float32, device=q.device)
    qi = torch.arange(s, device=q.device)[:, None]
    acc = torch.zeros((b, hkv, g, s, d_), **f32)
    m = torch.full((b, hkv, g, s), NEG_INF, **f32)
    l = torch.zeros((b, hkv, g, s), **f32)
    for c0 in range(0, t, chunk):
        kc, vc = k[:, c0:c0 + chunk], v[:, c0:c0 + chunk]
        sc = einsum("bshgd,bthd->bhgst", q, kc).to(torch.float32) \
            * scale
        if causal:
            ki = c0 + torch.arange(chunk, device=q.device)[None, :]
            sc = torch.where(ki <= qi, sc, sc.new_full((), NEG_INF))
        m_new = torch.maximum(m, sc.amax(dim=-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + einsum(
            "bhgst,bthd->bhgsd", p.to(q.dtype), vc).to(torch.float32)
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    out = out.permute(0, 3, 1, 2, 4)                         # (B,S,Hkv,G,D)
    return out.reshape(b, s, hkv * g, d_)


def _sdpa_decode_partial(q, k_cache, v_cache, lengths, base=None):
    """Partial-softmax decode statistics over one KV segment.

    q:(B,S,Hkv,G,D), cache:(B,T,Hkv,D).  Returns (acc, m, l) in float32,
    ``acc`` the un-normalized weighted V sum.  ``base`` (B,): per-row
    length *before* this append; with S>1 the mask is causal per query
    (query ``s`` sits at ``base+s`` and sees keys ``<= base+s``).  Without
    it every query shares the (B,)-length mask (one-token decode, which
    ``base`` reproduces exactly at S=1)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = einsum("bshgd,bthd->bhgst", q, k_cache) \
        .to(torch.float32) * scale
    t = k_cache.shape[1]
    s = q.shape[1]
    ki = torch.arange(t, device=q.device)
    if base is None or s == 1:
        mask = ki[None, :] < lengths[:, None]                  # (B,T)
        mask = mask[:, None, None, None, :]
    else:
        limit = base[:, None] + torch.arange(1, s + 1, device=q.device)
        mask = ki[None, None, :] < limit[:, :, None]           # (B,S,T)
        mask = mask[:, None, None, :, :]
    scores = torch.where(mask, scores, scores.new_full((), NEG_INF))
    m = scores.amax(dim=-1)                                  # (B,H,G,S)
    p = torch.exp(scores - m[..., None])
    l = p.sum(dim=-1)
    acc = einsum("bhgst,bthd->bhgsd", p.to(q.dtype),
                       v_cache).to(torch.float32)
    return acc, m, l


def _merge_partials(parts):
    """Merge flash-decode partials [(acc, m, l), ...] exactly."""
    accs, ms, ls = zip(*parts)
    m_all = torch.stack(ms).amax(dim=0)
    acc = sum(a * torch.exp(m - m_all)[..., None] for a, m in zip(accs, ms))
    l_all = sum(l * torch.exp(m - m_all) for l, m in zip(ls, ms))
    return acc / torch.clamp(l_all, min=1e-30)[..., None], m_all, l_all


def _sdpa_decode(q, k_cache, v_cache, lengths, base=None):
    """Decode: q:(B,S,Hkv,G,D) against cache:(B,T,Hkv,D), a softmax over
    the cache masked at each row's length (causal per query with
    ``base``)."""
    acc, _m, l = _sdpa_decode_partial(q, k_cache, v_cache, lengths,
                                      base=base)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    out = out.to(q.dtype).permute(0, 3, 1, 2, 4)             # (B,S,Hkv,G,D)
    b, s = out.shape[:2]
    return out.reshape(b, s, -1, out.shape[-1])


# ------------------------------------------------------------ cache writes
def write_plan(flat_pos: torch.Tensor, valid: torch.Tensor) -> tuple:
    """Indices for a scatter that drops the entries where ``valid`` is
    false, as JAX's ``.at[...].set(mode="drop")`` does, with no host sync
    (a boolean mask would wait for the card).  ``flat_pos`` (N,): target
    rows of a flattened cache; returns ``(idx, src)`` for :func:`put`.

    A dropped entry rewrites the first valid entry's target with that
    entry's own value, so the duplicate write stores the same bytes; with
    no valid entry, every entry rewrites row 0 with its current value."""
    n = flat_pos.shape[0]
    valid = valid.reshape(-1)
    # (1,) tensors throughout: indexing with a 0-d tensor reads it on the
    # host, a wait on the card
    first = valid.to(torch.int8).argmax().view(1)
    anyv = valid.any().view(1)
    zero = flat_pos.new_zeros(1)
    idx = torch.where(valid, flat_pos,
                      torch.where(anyv, flat_pos.index_select(0, first),
                                  zero))
    src = torch.where(valid, torch.arange(n, device=flat_pos.device),
                      torch.where(anyv, first, torch.full_like(first, n)))
    return idx, src


def put(flat: torch.Tensor, plan: tuple, vals: torch.Tensor) -> None:
    """``flat[idx] = vals[src]`` in place, ``vals`` (N, ...) rows in
    ``flat``'s layout; ``src == N`` names ``flat``'s current row 0."""
    idx, src = plan
    ext = torch.cat([vals.to(flat.dtype), flat[:1]])
    flat.index_put_((idx,), ext[src])


def dense_plan(base: torch.Tensor, s: int, max_seq: int) -> tuple:
    """Write plan of an S-token append at each row's ``base`` into a dense
    (B, max_seq) slot cache: positions at or past ``max_seq`` drop."""
    b = base.shape[0]
    pos = base.long()[:, None] + torch.arange(s, device=base.device)
    rows = torch.arange(b, device=base.device)[:, None]
    return write_plan((rows * max_seq + pos).reshape(-1),
                      (pos < max_seq).reshape(-1))


def put_sharded(cache, vals, base, s: int) -> None:
    """:func:`put` of an S-token append at each row's ``base`` into a
    DTensor slot cache (B, T, ...) sharded over its batch and sequence
    dimensions, on this rank's block: each rank writes the rows and
    positions it holds (a dense plan of its block; the rest drop), so no
    cache bytes move.  ``vals`` (B, S, ...) is gathered to the block's
    rows.  A dimension that does not divide its mesh dimensions leaves
    the last ranks shorter blocks (``torch.chunk``'s split, mesh
    dimensions in order, as DTensor cuts them)."""
    mesh, pl = cache.device_mesh, cache.placements
    local = cache.to_local()
    coord = mesh.get_coordinate()
    size, off = list(cache.shape[:2]), [0, 0]
    for j, p in enumerate(pl):
        if p.is_shard() and p.dim < 2:
            chunk = -(-size[p.dim] // mesh.size(j))
            start = min(coord[j] * chunk, size[p.dim])
            off[p.dim] += start
            size[p.dim] = min(size[p.dim] - start, chunk)
    bl, tl = size
    if (bl, tl) != tuple(local.shape[:2]):
        raise ValueError(f"this rank's block {tuple(local.shape)} is not "
                         f"the chunk {(bl, tl)} of the cache")
    rows = slice(off[0], off[0] + bl)
    if isinstance(vals, DTensor):
        vals = vals.redistribute(mesh, [Shard(0) if p.is_shard(0)
                                        else Replicate() for p in pl])
        vals = vals.to_local()
    else:
        vals = vals[rows]
    b = base.full_tensor() if isinstance(base, DTensor) else base
    if local.numel() == 0:
        return          # this rank holds no block (after the collectives)
    pos = b[rows].long()[:, None] + torch.arange(s, device=local.device) \
        - off[1]
    valid = (pos >= 0) & (pos < tl) & (pos + off[1] < cache.shape[1])
    r = torch.arange(bl, device=local.device)[:, None]
    plan = write_plan((r * tl + pos.clamp(0, tl - 1)).reshape(-1),
                      valid.reshape(-1))
    put(local.view(-1, *local.shape[2:]), plan, vals.flatten(0, 1))


def paged_plan(bt: torch.Tensor, base: torch.Tensor, s: int,
               n_blocks: int, block_size: int) -> dict:
    """Write plan and gather table of an S-token append at each row's
    ``base`` through block tables ``bt`` (B, blocks), sentinel ``n_blocks``.
    A position at or past the table span, or in a sentinel entry, drops
    (parked rows, unbound right-pad); the gather clamps the sentinel to
    the last block, as JAX's gather does."""
    t = bt.shape[1] * block_size
    pos = base.long()[:, None] + torch.arange(s, device=bt.device)
    col = torch.clamp(pos // block_size, max=bt.shape[1] - 1)
    blk = torch.gather(bt.long(), 1, col)
    blk = torch.where(pos < t, blk, torch.full_like(blk, n_blocks))
    flat = blk * block_size + pos % block_size
    return {"write": write_plan(flat.reshape(-1),
                                (blk < n_blocks).reshape(-1)),
            "gather": torch.clamp(bt.long(), max=n_blocks - 1)}


def _whole_heads(q):
    """``q`` with its heads dimension replicated (a DTensor's): grouping
    the heads into (KV head, group) splits that dimension, which DTensor
    cannot do to a sharded one.  A decode's query is one token."""
    if not isinstance(q, DTensor) or not any(p.is_shard(2)
                                             for p in q.placements):
        return q
    return q.redistribute(q.device_mesh, [
        Replicate() if p.is_shard(2) else p for p in q.placements])


def _per_shard(fn, q, k, v):
    """``fn(q, k, v)`` on each rank's block of the DTensors ``q``, ``k``,
    ``v`` (batch over its data dimensions; heads over ``model`` where the
    KV heads divide, query heads with them), the way the reference's
    attention runs inside each shard: every (row, KV-head group) is
    independent, and DTensor cannot flatten two sharded dimensions into
    the batch of a batched matmul."""
    k = shard(k, "batch", "seq", "kv_heads", "head_dim")
    mesh, pl = k.device_mesh, k.placements
    out = fn(q.redistribute(mesh, pl).to_local(), k.to_local(),
             v.redistribute(mesh, pl).to_local())
    return DTensor.from_local(out, mesh, pl, run_check=False)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, cache: dict | None = None,
              blocked_threshold: int | None = None):
    """Returns (out, new_cache).  Without ``cache`` (prefill) new_cache is
    {"k","v": (B,S,Hkv,D), "length": (B,) int32}.  With one, the S new
    tokens append at each row's ``length``; the cache's tensors are
    written in place and new_cache holds them with the new lengths.  A
    per-layer cache may carry ``"plan"`` (:func:`dense_plan` /
    :func:`paged_plan`), made once for every layer of a forward."""
    if blocked_threshold is None:
        blocked_threshold = cfg.attn_blocked_threshold
    q, k, v = _qkv(p, x, cfg, positions)
    b, s = x.shape[0], x.shape[1]
    if cache is None:
        def sdpa(q, k, v):
            qg = _group(q, k.shape[2])
            if s > blocked_threshold:
                return _sdpa_blocked(qg, k, v, cfg.causal)
            return _sdpa_dense(
                qg, k, v, cfg.causal,
                softmax_dtype=torch_dtype(cfg.attn_softmax_dtype))

        out = _per_shard(sdpa, q, k, v) if isinstance(q, DTensor) \
            else sdpa(q, k, v)
        new_cache = {"k": k, "v": v,
                     "length": torch.full((b,), s, dtype=torch.int32,
                                          device=x.device)}
    elif "rk" in cache:
        # two-tier decode: the big seq-sharded main cache stays FROZEN (no
        # per-layer rewrite); new tokens append into a small replicated
        # recent buffer at row 0's offset (clamped to fit, as JAX's
        # dynamic_update_slice); the partial softmaxes merge exactly
        qg = _group(_whole_heads(q), cfg.n_kv_heads)
        lengths = cache["length"] + s
        main_len = cache["main_len"]
        rk, rv = cache["rk"], cache["rv"]
        start = torch.clamp((cache["length"] - main_len)[:1].long(), 0,
                            rk.shape[1] - s)
        idx = start + torch.arange(s, device=start.device)
        rk.index_copy_(1, idx, k.to(rk.dtype))
        rv.index_copy_(1, idx, v.to(rv.dtype))
        k_main = shard(cache["k"], "batch", "seq_sp", None, "head_dim")
        v_main = shard(cache["v"], "batch", "seq_sp", None, "head_dim")
        p_main = _sdpa_decode_partial(qg, k_main, v_main, main_len)
        p_rec = _sdpa_decode_partial(qg, rk, rv, lengths - main_len)
        norm, _m, _l = _merge_partials([p_main, p_rec])
        out = norm.to(q.dtype).permute(0, 3, 1, 2, 4)        # (B,S,Hkv,G,D)
        out = out.reshape(out.shape[0], out.shape[1], -1, out.shape[-1])
        new_cache = {"k": cache["k"], "v": cache["v"], "rk": rk, "rv": rv,
                     "length": lengths, "main_len": main_len}
    elif "pk" in cache:
        # paged decode/append: new K/V scatter through each row's block
        # table at base..base+S-1; the softmax gathers the row's window
        # back as a contiguous (B, T) view, the values the dense slot
        # layout would hold
        qg = _group(_whole_heads(q), cfg.n_kv_heads)
        pk, pv, bt = cache["pk"], cache["pv"], cache["bt"]
        base = cache["length"]
        n_blocks, bs_blk = pk.shape[0], pk.shape[1]
        plan = cache.get("plan") or paged_plan(bt, base, s, n_blocks,
                                               bs_blk)
        put(pk.view(-1, *pk.shape[2:]), plan["write"], k.flatten(0, 1))
        put(pv.view(-1, *pv.shape[2:]), plan["write"], v.flatten(0, 1))
        t = bt.shape[1] * bs_blk
        k_cache = pk[plan["gather"]].reshape(b, t, *pk.shape[2:])
        v_cache = pv[plan["gather"]].reshape(b, t, *pv.shape[2:])
        lengths = base + s
        out = _sdpa_decode(qg, k_cache, v_cache, lengths,
                           base=base if s > 1 else None)
        new_cache = {"pk": pk, "pv": pv, "bt": bt, "length": lengths}
    else:
        # dense slot cache: each row appends at ITS OWN length (the serving
        # pool interleaves requests at different positions; a multi-token
        # append is chunked prefill or a speculative verify); positions at
        # or past max_seq (parked rows, draft spill) drop
        qg = _group(_whole_heads(q), cfg.n_kv_heads)
        k_cache, v_cache = cache["k"], cache["v"]
        base = cache["length"]
        t = k_cache.shape[1]
        if isinstance(k_cache, DTensor):
            put_sharded(k_cache, k, base, s)
            put_sharded(v_cache, v, base, s)
        else:
            plan = cache.get("plan") or dense_plan(base, s, t)
            put(k_cache.view(-1, *k_cache.shape[2:]), plan, k.flatten(0, 1))
            put(v_cache.view(-1, *v_cache.shape[2:]), plan, v.flatten(0, 1))
        k_cache = shard(k_cache, "batch", "seq_sp", None, "head_dim")
        v_cache = shard(v_cache, "batch", "seq_sp", None, "head_dim")
        lengths = base + s
        out = _sdpa_decode(qg, k_cache, v_cache, lengths, base=base)
        new_cache = {"k": k_cache, "v": v_cache, "length": lengths}
    out = shard(out, "batch", "seq", "heads", "head_dim")
    op_hook("attn.sdpa", (q, k, v), (out,))
    y = einsum("bshd,hdm->bsm", out, p["wo"].to(x.dtype))
    y = shard(y, "batch", "seq", "embed")
    op_hook("attn.out_proj", (out, p["wo"]), (y,))
    return y, new_cache


# ----------------------------------------------------------------------- mlp
def init_mlp(cfg: ModelConfig, lead: tuple, gen: torch.Generator, dtype,
             device) -> dict:
    """GLU MLP weights with leading axes ``lead``."""
    d, f = cfg.d_model, cfg.d_ff
    normal = normal_init(lead, gen, dtype, device)
    return {
        "w_gate": normal((d, f), 1.0 / math.sqrt(d)),
        "w_up": normal((d, f), 1.0 / math.sqrt(d)),
        "w_down": normal((f, d), 1.0 / math.sqrt(f)),
    }


def mlp_param_axes() -> dict:
    """Logical sharding axes of one GLU MLP's weights."""
    return {"w_gate": ("p_embed", "p_ff"), "w_up": ("p_embed", "p_ff"),
            "w_down": ("p_ff", "p_embed")}


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    g = einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    u = einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    g = shard(g, "batch", "seq", "ff")
    u = shard(u, "batch", "seq", "ff")
    act = _gelu(g) if cfg.mlp == "geglu" else _silu(g)
    h = act * u
    y = einsum("bsf,fd->bsd", h, p["w_down"].to(dt))
    y = shard(y, "batch", "seq", "embed")
    op_hook("mlp.glu", (x, p["w_gate"], p["w_up"], p["w_down"]), (g, u, y))
    return y
