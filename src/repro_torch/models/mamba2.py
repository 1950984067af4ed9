"""Mamba2 (SSD — state-space duality) blocks, chunked, without a decode
state.

The sequence is split into chunks of Q tokens (arXiv:2405.21060); within a
chunk the recurrence is materialized as a (Q×Q) lower-triangular
"attention-like" matrix, and chunk states pass from one chunk to the next
in a loop — O(S·Q) instead of O(S²).  State decay products are computed in
log space (segment-sum trick) in f32; projections run in the compute
dtype.  The scan is plain PyTorch, as it is plain ``jnp`` in the reference.

The local variables of :func:`mamba2_layer` follow the reference's, since
the hooked tensors die when the function returns, in the order its locals
are cleared, and that order fixes the instrumented event stream.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core.instrument import op_hook
from .config import ModelConfig
from .layers import _silu, normal_init, rmsnorm


def init_mamba2(cfg: ModelConfig, lead: tuple, gen: torch.Generator, dtype,
                device) -> dict:
    """Mamba2 weights with leading axes ``lead``; ``A_log``, ``dt_bias`` and
    ``D`` are float32 whatever ``dtype`` is."""
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_conv_width
    normal = normal_init(lead, gen, dtype, device)
    s = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": normal((d, di), s),
        "w_x": normal((d, di), s),
        "w_B": normal((d, g * ds), s),
        "w_C": normal((d, g * ds), s),
        "w_dt": normal((d, nh), s),
        "conv_x": normal((w, di), 0.1),
        "conv_B": normal((w, g * ds), 0.1),
        "conv_C": normal((w, g * ds), 0.1),
        "A_log": torch.zeros((*lead, nh), **f32),
        "dt_bias": torch.full((*lead, nh), -2.0, **f32),
        "D": torch.ones((*lead, nh), **f32),
        "norm": torch.zeros((*lead, di), dtype=dtype, device=device),
        "w_out": normal((di, d), 1.0 / math.sqrt(di)),
    }


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^v)`` as ``logaddexp(v, 0)``, the reference's
    ``jax.nn.softplus``; ``torch.nn.functional.softplus`` would turn
    linear above its threshold of 20 instead."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor):
    """Depthwise causal conv. x:(B,S,C), w:(W,C). Returns (y, tail) where
    tail holds the trailing W-1 inputs (the streaming-decode state)."""
    width = w.shape[0]
    pad = torch.zeros((x.shape[0], width - 1, x.shape[2]), dtype=x.dtype,
                      device=x.device)
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    return _silu(y), xp[:, -(width - 1):, :]


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA: (..., Q) → L (..., Q, Q) with L[i,j]=exp(Σ_{k=j+1..i} dA) for j≤i
    and 0 above the diagonal.  The exponent is masked to -inf before the
    exp, so no value above the diagonal (where it grows) can overflow."""
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    q = dA.shape[-1]
    idx = torch.arange(q, device=dA.device)
    mask = idx[:, None] >= idx[None, :]
    return torch.exp(diff.masked_fill(~mask, float("-inf")))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """SSD over chunks.

    x: (b,s,h,p) f32 | dt: (b,s,h) f32 | A: (h,) f32 (negative)
    B,C: (b,s,h,n) f32 (group-broadcast done by caller)
    Returns y (b,s,h,p) f32 and final state (b,h,p,n) f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    nc = s // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, h, n)
    Cc = C.reshape(b, nc, chunk, h, n)
    dA = dtc * A[None, None, None, :]                     # (b,nc,q,h)
    dA_h = dA.permute(0, 1, 3, 2)                         # (b,nc,h,q)
    cs = torch.cumsum(dA_h, dim=-1)                       # (b,nc,h,q)
    L = _segsum(dA_h)                                     # (b,nc,h,q,q)

    # intra-chunk (the "attention-like" quadratic-in-Q term)
    scores = torch.einsum("bcihn,bcjhn->bchij", Cc, Bc)
    scores = scores * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = torch.einsum("bchij,bcjhp->bcihp", scores, xc)

    # per-chunk boundary states
    decay_to_end = torch.exp(cs[..., -1:] - cs)           # (b,nc,h,q)
    state_c = torch.einsum("bchj,bcjh,bcjhn,bcjhp->bchpn",
                           decay_to_end, dtc, Bc, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cs[..., -1])                  # (b,nc,h)
    s_prev = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + state_c[:, c]
    final_state = s_prev
    s_prevs = torch.stack(s_prevs, dim=1)                 # (b,nc,h,p,n)

    in_decay = torch.exp(cs)                              # (b,nc,h,q)
    y_inter = torch.einsum("bcihn,bchpn,bchi->bcihp", Cc, s_prevs, in_decay)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, final_state


def ssd_ref(x, dt, A, B, C):
    """Naive sequential recurrence oracle."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    st = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        dec = torch.exp(dtt * A[None, :])                 # (b,h)
        st = st * dec[..., None, None] \
            + torch.einsum("bh,bhn,bhp->bhpn", dtt, Bt, xt)
        ys.append(torch.einsum("bhn,bhpn->bhp", Ct, st))
    return torch.stack(ys, dim=1), st


def mamba2_layer(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B,S,d_model).  Returns (out, state) with state = {"conv_x",
    "conv_B", "conv_C", "ssm"}, the reference's prefill state."""
    dt_ = x.dtype
    b, s, _ = x.shape
    nh, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    z = torch.einsum("bsd,de->bse", x, p["w_z"].to(dt_))
    xs = torch.einsum("bsd,de->bse", x, p["w_x"].to(dt_))
    Bv = torch.einsum("bsd,de->bse", x, p["w_B"].to(dt_))
    Cv = torch.einsum("bsd,de->bse", x, p["w_C"].to(dt_))
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["w_dt"].to(dt_))

    xs, conv_x = _causal_conv(xs, p["conv_x"].to(dt_))
    Bv, conv_B = _causal_conv(Bv, p["conv_B"].to(dt_))
    Cv, conv_C = _causal_conv(Cv, p["conv_C"].to(dt_))

    A = -torch.exp(p["A_log"])                            # (h,) negative
    dt_act = softplus(dt_raw.to(torch.float32)
                      + p["dt_bias"][None, None, :])
    xh = xs.reshape(b, s, nh, pd).to(torch.float32)
    heads_per_group = nh // g
    Bh = torch.repeat_interleave(Bv.reshape(b, s, g, n), heads_per_group,
                                 dim=2)
    Ch = torch.repeat_interleave(Cv.reshape(b, s, g, n), heads_per_group,
                                 dim=2)
    Bh = Bh.to(torch.float32)
    Ch = Ch.to(torch.float32)

    if s > 1:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        if pad:
            # pad with dt=0 steps: decay exp(0)=1 and zero input, so the
            # final state is exact; padded outputs are sliced off.
            zpad = lambda a: F.pad(a, (0, 0) * (a.dim() - 2)     # noqa: E731
                                   + (0, pad))
            y, ssm = ssd_chunked(zpad(xh), zpad(dt_act), A, zpad(Bh),
                                 zpad(Ch), chunk)
            y = y[:, :s]
        else:
            y, ssm = ssd_chunked(xh, dt_act, A, Bh, Ch, chunk)
    else:
        y, ssm = ssd_ref(xh, dt_act, A, Bh, Ch)
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, nh * pd).to(dt_)

    y = rmsnorm(y * _silu(z), p["norm"], cfg.rmsnorm_eps)
    op_hook("mamba.ssd", (xs, Bv, Cv, dt_raw), (y,))
    out = torch.einsum("bse,ed->bsd", y, p["w_out"].to(dt_))
    op_hook("mamba.out_proj", (y, p["w_out"]), (out,))
    new_state = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "ssm": ssm}
    return out, new_state
