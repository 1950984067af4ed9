"""Plain PyTorch layers of the references: one decoder's forward written
from the models' published descriptions, in the precision the
configuration states.

Numerics: matrix products in the compute dtype (bfloat16) with each
float32 weight cast to it; norm statistics and the softmax in float32;
activations step by step in the compute dtype.  ``prec="fp8"`` is the
control: every linear layer's operands (weights and activations) are
rounded to float8 e4m3 with one scale per tensor before the product, the
step below bfloat16 that a faster kernel would take.

Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30
FP8_MAX = 448.0


def torch_dtype(name: str) -> torch.dtype:
    """``"bfloat16"`` -> ``torch.bfloat16``."""
    dt = getattr(torch, name)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"not a dtype: {name!r}")
    return dt


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor, back in
    ``t``'s dtype."""
    scale = t.abs().amax().to(torch.float32).clamp(min=1e-30) / FP8_MAX
    q = (t.to(torch.float32) / scale).to(torch.float8_e4m3fn)
    return (q.to(torch.float32) * scale).to(t.dtype)


def linear(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """``x (..., K) @ w (K, N)`` in ``x``'s dtype."""
    w = w.to(x.dtype)
    if prec == "fp8":
        x, w = fp8(x), fp8(w)
    elif prec != "bf16":
        raise ValueError(f"unknown precision {prec!r}")
    return x @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm with the scale applied as ``1 + scale``, statistics in
    float32, the result in ``x``'s dtype."""
    xf = x.to(torch.float32)
    out = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (out * (1.0 + scale.to(torch.float32))).to(x.dtype)


def silu(g: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(x), each step rounded to ``g``'s dtype."""
    return g * (1 / (1 + torch.exp(-g)))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the two halves of each head, positions
    0..S-1.  x: (B, S, H, D)."""
    s, d = x.shape[1], x.shape[-1]
    half = d // 2
    inv = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half].to(torch.float32), x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def causal_attention(q, k, v) -> torch.Tensor:
    """Causal softmax attention with grouped KV heads.  q: (B, S, H, D),
    k, v: (B, S, Hkv, D).  Scores are products in the compute dtype,
    scaled, masked and normalised in float32; the weights go back to the
    compute dtype for the product with V.  Returns (B, S, H, D)."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d).permute(0, 2, 3, 1, 4)   # b,kv,g,s,d
    kt = k.permute(0, 2, 3, 1)[:, :, None]                          # b,kv,1,d,s
    scale = float(torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32))
    scores = (qg @ kt).to(torch.float32) * scale
    keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(keep, scores, scores.new_full((), NEG_INF))
    p = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    w = (p / p.sum(dim=-1, keepdim=True)).to(q.dtype)
    del scores, p
    out = w @ v.permute(0, 2, 1, 3)[:, :, None]                      # b,kv,g,s,d
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, h, d)


def attention_block(p: dict, h: torch.Tensor, cfg, prec: str) -> torch.Tensor:
    """Pre-norm attention and gated MLP with residuals (one decoder layer).
    ``p``: ``ln1``, ``ln2``, ``attn`` {wq (d,H,D), wk, wv (d,Hkv,D),
    wo (H,D,d)}, ``mlp`` {w_gate, w_up (d,f), w_down (f,d)}."""
    b, s, d = h.shape
    a = p["attn"]
    x = rmsnorm(h, p["ln1"], cfg.rmsnorm_eps)
    q = linear(x, a["wq"].reshape(d, -1), prec).reshape(b, s, cfg.n_heads, -1)
    k = linear(x, a["wk"].reshape(d, -1), prec).reshape(b, s, cfg.n_kv_heads, -1)
    v = linear(x, a["wv"].reshape(d, -1), prec).reshape(b, s, cfg.n_kv_heads, -1)
    q, k = rope(q, cfg.rope_theta), rope(k, cfg.rope_theta)
    o = causal_attention(q, k, v).reshape(b, s, -1)
    h = h + linear(o, a["wo"].reshape(-1, d), prec)
    m = p["mlp"]
    x = rmsnorm(h, p["ln2"], cfg.rmsnorm_eps)
    g = linear(x, m["w_gate"], prec)
    u = linear(x, m["w_up"], prec)
    return h + linear(silu(g) * u, m["w_down"], prec)


def layer(tree: dict, *index) -> dict:
    """The subtree of stacked leaves at ``index`` along the leading axes."""
    return {k: layer(v, *index) if isinstance(v, dict) else v[index]
            for k, v in tree.items()}


def embed(params: dict, tokens: torch.Tensor, dtype) -> torch.Tensor:
    return params["embed"][tokens.long()].to(dtype)


def head_rows(params: dict, h: torch.Tensor, rows, cfg, prec: str) -> torch.Tensor:
    """Logits (R, V) at ``rows`` = (batch index, position) tensors, from the
    last hidden state h (B, S, d): the final norm and the output head over
    every position, then the rows."""
    h = rmsnorm(h, params["final_norm"], cfg.rmsnorm_eps)
    logits = linear(h, params["lm_head"], prec)
    return logits[rows[0], rows[1]]
