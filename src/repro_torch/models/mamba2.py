"""Mamba2 (SSD — state-space duality) blocks, chunked, with the decode
state of the serving path.

The sequence is split into chunks of Q tokens (arXiv:2405.21060); within a
chunk the recurrence is materialized as a (Q×Q) lower-triangular
"attention-like" matrix, and chunk states pass from one chunk to the next
in a loop — O(S·Q) instead of O(S²), and O(1) state for decode, which
runs the sequential recurrence (``ssd_ref``) from the carried state.
State decay products are computed in log space (segment-sum trick) in
f32; projections run in the compute dtype.  The scan is plain PyTorch,
as it is plain ``jnp`` in the reference.

The local variables of :func:`mamba2_layer` follow the reference's, since
the hooked tensors die when the function returns, in the order its locals
are cleared, and that order fixes the instrumented event stream.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.core.instrument import op_hook
from repro_torch.dist.sharding import einsum, shard
from .config import ModelConfig
from .layers import _silu, kept, normal_init, rmsnorm


def init_mamba2(cfg: ModelConfig, lead: tuple, gen: torch.Generator, dtype,
                device, place=kept) -> dict:
    """Mamba2 weights with leading axes ``lead``, each handed to
    ``place(key, weight)`` as it is made; ``A_log``, ``dt_bias`` and
    ``D`` are float32 whatever ``dtype`` is."""
    d, di = cfg.d_model, cfg.d_inner
    g, ds, nh, w = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_conv_width
    normal = normal_init(lead, gen, dtype, device, place)
    s = 1.0 / math.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": normal("w_z", (d, di), s),
        "w_x": normal("w_x", (d, di), s),
        "w_B": normal("w_B", (d, g * ds), s),
        "w_C": normal("w_C", (d, g * ds), s),
        "w_dt": normal("w_dt", (d, nh), s),
        "conv_x": normal("conv_x", (w, di), 0.1),
        "conv_B": normal("conv_B", (w, g * ds), 0.1),
        "conv_C": normal("conv_C", (w, g * ds), 0.1),
        "A_log": place("A_log", torch.zeros((*lead, nh), **f32)),
        "dt_bias": place("dt_bias", torch.full((*lead, nh), -2.0, **f32)),
        "D": place("D", torch.ones((*lead, nh), **f32)),
        "norm": place("norm", torch.zeros((*lead, di), dtype=dtype,
                                          device=device)),
        "w_out": normal("w_out", (di, d), 1.0 / math.sqrt(di)),
    }


def mamba2_param_axes() -> dict:
    """Logical sharding axes of one Mamba2 layer's weights."""
    return {
        "w_z": ("p_embed", "p_ssm_inner"), "w_x": ("p_embed", "p_ssm_inner"),
        "w_B": ("p_embed", None), "w_C": ("p_embed", None),
        "w_dt": ("p_embed", "p_ssm_inner"),
        "conv_x": (None, "p_ssm_inner"), "conv_B": (None, None),
        "conv_C": (None, None),
        "A_log": ("p_ssm_inner",), "dt_bias": ("p_ssm_inner",),
        "D": ("p_ssm_inner",), "norm": ("p_ssm_inner",),
        "w_out": ("p_ssm_inner", "p_embed"),
    }


def softplus(v: torch.Tensor) -> torch.Tensor:
    """``log(1 + e^v)`` as ``logaddexp(v, 0)``, the reference's
    ``jax.nn.softplus``; ``torch.nn.functional.softplus`` would turn
    linear above its threshold of 20 instead."""
    return torch.logaddexp(v, torch.zeros((), dtype=v.dtype,
                                          device=v.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, state=None):
    """Depthwise causal conv. x:(B,S,C), w:(W,C). Returns (y, tail) where
    tail holds the trailing W-1 inputs (the streaming-decode state);
    ``state``, when given, is the previous call's tail."""
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
    else:
        pad = state
    xp = torch.cat([pad, x], dim=1)
    y = sum(xp[:, i:i + x.shape[1], :] * w[i][None, None, :]
            for i in range(width))
    return _silu(y), xp[:, -(width - 1):, :]


def _pad_steps(a: torch.Tensor, pad: int) -> torch.Tensor:
    """``a`` (b, s, ...) with ``pad`` zero steps appended to ``s``.  A
    DTensor pads each rank's block (the step dimension is never split):
    DTensor's rule for the pad breaks in some torch releases."""
    widths = (0, 0) * (a.dim() - 2) + (0, pad)
    if not isinstance(a, DTensor):
        return F.pad(a, widths)
    if any(p.is_shard(1) for p in a.placements):
        raise ValueError("the step dimension of a scan input is split")
    return DTensor.from_local(F.pad(a.to_local(), widths), a.device_mesh,
                              a.placements, run_check=False)


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


def ssd_chunked(x, dt, A, B, C, chunk: int, init_state=None):
    """SSD over chunks.

    x: (b,s,h,p) f32 | dt: (b,s,h) f32 | A: (h,) f32 (negative)
    B,C: (b,s,h,n) f32 (group-broadcast done by caller)
    init_state: (b,h,p,n) f32 entering the first chunk (zeros if None)
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
    scores = einsum("bcihn,bcjhn->bchij", Cc, Bc)
    scores = scores * L * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_intra = einsum("bchij,bcjhp->bcihp", scores, xc)

    # per-chunk boundary states
    decay_to_end = torch.exp(cs[..., -1:] - cs)           # (b,nc,h,q)
    state_c = einsum("bchj,bcjh,bcjhn,bcjhp->bchpn",
                           decay_to_end, dtc, Bc, xc)

    # inter-chunk recurrence: the state entering each chunk
    chunk_decay = torch.exp(cs[..., -1])                  # (b,nc,h)
    s_prev = init_state if init_state is not None else torch.zeros(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s_prev)
        s_prev = s_prev * chunk_decay[:, c, :, None, None] + state_c[:, c]
    final_state = s_prev
    s_prevs = torch.stack(s_prevs, dim=1)                 # (b,nc,h,p,n)

    in_decay = torch.exp(cs)                              # (b,nc,h,q)
    y_inter = einsum("bcihn,bchpn,bchi->bcihp", Cc, s_prevs, in_decay)
    y = (y_intra + y_inter).reshape(b, s, h, p)
    return y, final_state


def ssd_ref(x, dt, A, B, C, init_state=None):
    """Sequential recurrence from ``init_state`` (zeros if None): the
    oracle, and the decode step."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    st = init_state if init_state is not None else torch.zeros(
        (b, h, p, n), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        xt, dtt, Bt, Ct = x[:, t], dt[:, t], B[:, t], C[:, t]
        dec = torch.exp(dtt * A[None, :])                 # (b,h)
        st = st * dec[..., None, None] \
            + einsum("bh,bhn,bhp->bhpn", dtt, Bt, xt)
        ys.append(einsum("bhn,bhpn->bhp", Ct, st))
    return torch.stack(ys, dim=1), st


def mamba2_layer(p: dict, x: torch.Tensor, cfg: ModelConfig,
                 state: dict | None = None):
    """x: (B,S,d_model).  Returns (out, new_state), a state being
    {"conv_x", "conv_B", "conv_C", "ssm"}.  Without ``state`` (prefill)
    the scan is chunked; with one (decode) the recurrence runs from it."""
    dt_ = x.dtype
    b, s, _ = x.shape
    nh, pd, n, g = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state, \
        cfg.ssm_groups
    z = einsum("bsd,de->bse", x, p["w_z"].to(dt_))
    xs = einsum("bsd,de->bse", x, p["w_x"].to(dt_))
    Bv = einsum("bsd,de->bse", x, p["w_B"].to(dt_))
    Cv = einsum("bsd,de->bse", x, p["w_C"].to(dt_))
    dt_raw = einsum("bsd,dh->bsh", x, p["w_dt"].to(dt_))
    z = shard(z, "batch", "seq", "p_ssm_inner")
    xs = shard(xs, "batch", "seq", "p_ssm_inner")
    # a partial sum here (x sharded over its contracted width) meets the
    # head-sharded dt_bias below, which some torch releases cannot
    # redistribute; the heads' placement is the one the green table gives
    dt_raw = shard(dt_raw, "batch", "seq", "ssm_heads")

    st = state or {}
    xs, conv_x = _causal_conv(xs, p["conv_x"].to(dt_), st.get("conv_x"))
    Bv, conv_B = _causal_conv(Bv, p["conv_B"].to(dt_), st.get("conv_B"))
    Cv, conv_C = _causal_conv(Cv, p["conv_C"].to(dt_), st.get("conv_C"))

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
    # the replicated B/C sliced to this rank's heads, as the scan's other
    # operands are: their gradients then sum over the heads before any
    # collective (the reference's partitioner does so unannotated)
    Bh = shard(Bh, "batch", "seq", "ssm_heads", None)
    Ch = shard(Ch, "batch", "seq", "ssm_heads", None)

    if state is None and s > 1:
        chunk = min(cfg.ssm_chunk, s)
        pad = (-s) % chunk
        if pad:
            # pad with dt=0 steps: decay exp(0)=1 and zero input, so the
            # final state is exact; padded outputs are sliced off.
            y, ssm = ssd_chunked(*(_pad_steps(a, pad) for a in (xh, dt_act)),
                                 A, *(_pad_steps(a, pad) for a in (Bh, Ch)),
                                 chunk)
            y = y[:, :s]
        else:
            y, ssm = ssd_chunked(xh, dt_act, A, Bh, Ch, chunk)
    else:
        y, ssm = ssd_ref(xh, dt_act, A, Bh, Ch, st.get("ssm"))
    y = y + xh * p["D"][None, None, :, None]
    y = y.reshape(b, s, nh * pd).to(dt_)
    y = shard(y, "batch", "seq", "p_ssm_inner")

    y = rmsnorm(y * _silu(z), p["norm"], cfg.rmsnorm_eps)
    op_hook("mamba.ssd", (xs, Bv, Cv, dt_raw), (y,))
    out = einsum("bse,ed->bsd", y, p["w_out"].to(dt_))
    out = shard(out, "batch", "seq", "embed")
    op_hook("mamba.out_proj", (y, p["w_out"]), (out,))
    new_state = {"conv_x": conv_x, "conv_B": conv_B, "conv_C": conv_C,
                 "ssm": ssm}
    return out, new_state
