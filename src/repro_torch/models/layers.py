"""Transformer layers: RMSNorm, RoPE/M-RoPE, GQA attention (with optional
qk-norm), GLU MLPs, as plain functions on tensors and dicts of parameters.

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

from repro_torch.core.instrument import op_hook
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


def _qkv(p, x, cfg: ModelConfig, positions):
    dt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dt))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dt))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rmsnorm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rmsnorm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.m_rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.m_rope)
    op_hook("attn.qkv_proj", (x, p["wq"], p["wk"], p["wv"]), (q, k, v))
    return q, k, v


def _group(q, n_kv: int):
    """(B,S,H,D) -> (B,S,Hkv,G,D): query head h reads KV head h // G."""
    b, s, h, d_ = q.shape
    return q.reshape(b, s, n_kv, h // n_kv, d_)


def _sdpa_dense(q, k, v, causal: bool, softmax_dtype=torch.float32):
    """q:(B,S,Hkv,G,D) k/v:(B,T,Hkv,D).  Full-scores attention: scores in
    ``softmax_dtype``, scaled by 1/sqrt(D) rounded to that dtype, masked
    with NEG_INF, weights cast back to q's dtype before the PV product."""
    scale = _rounded(1.0 / math.sqrt(q.shape[-1]), softmax_dtype)
    scores = torch.einsum("bshgd,bthd->bhgst", q, k).to(softmax_dtype) \
        * scale
    if causal:
        s_len, t_len = scores.shape[-2], scores.shape[-1]
        qi = torch.arange(s_len, device=q.device)[:, None]
        ki = torch.arange(t_len, device=q.device)[None, :]
        scores = torch.where(ki <= qi, scores, scores.new_full((), NEG_INF))
    m = scores.amax(dim=-1, keepdim=True).detach()   # stop_gradient
    p = torch.exp(scores - m)
    w = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("bhgst,bthd->bshgd", w, v)
    return out.reshape(*out.shape[:2], -1, out.shape[-1])    # (B,S,H,D)


def attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor):
    """Returns (out, new_cache) with new_cache = {"k","v": (B,T,Hkv,D),
    "length": (B,) int32}, as the reference's prefill does."""
    if x.shape[1] > cfg.attn_blocked_threshold:
        raise NotImplementedError("blocked (flash-style) attention is not "
                                  "ported yet")
    q, k, v = _qkv(p, x, cfg, positions)
    qg = _group(q, cfg.n_kv_heads)
    out = _sdpa_dense(qg, k, v, cfg.causal,
                      softmax_dtype=torch_dtype(cfg.attn_softmax_dtype))
    new_cache = {"k": k, "v": v,
                 "length": torch.full((x.shape[0],), x.shape[1],
                                      dtype=torch.int32, device=x.device)}
    op_hook("attn.sdpa", (q, k, v), (out,))
    y = torch.einsum("bshd,hdm->bsm", out, p["wo"].to(x.dtype))
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


def mlp(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    dt = x.dtype
    g = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(dt))
    u = torch.einsum("bsd,df->bsf", x, p["w_up"].to(dt))
    act = _gelu(g) if cfg.mlp == "geglu" else _silu(g)
    h = act * u
    y = torch.einsum("bsf,fd->bsd", h, p["w_down"].to(dt))
    op_hook("mlp.glu", (x, p["w_gate"], p["w_up"], p["w_down"]), (g, u, y))
    return y
