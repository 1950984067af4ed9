"""AdamW with optionally int8-quantized moments, on one device.

Moments can be stored in int8 with per-row (last-axis) absmax scales — the
blockwise-quantized-Adam trick the trillion-parameter config needs, laid
out so array shapes are preserved.  The arithmetic is the reference's, step
for step, in float32; trees are nested dicts walked in sorted key order,
the order ``jax.tree.leaves`` walks them in.
"""

from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "float32" | "int8"
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


# ------------------------------------------------------------------- trees
def tree_paths(tree: dict, prefix: tuple = ()) -> list:
    """(path, leaf) pairs of a nested dict, keys in sorted order."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.extend(tree_paths(v, (*prefix, k)))
        else:
            out.append(((*prefix, k), v))
    return out


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of ``tree`` and the matching entries of
    ``rest`` (whole subtrees where ``tree`` has a leaf, as an int8 moment's
    ``{"q", "scale"}``)."""
    return {k: tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}


# ------------------------------------------------------------- quantization
def _f32(v: float) -> float:
    """``v`` rounded to float32, as a Python float (applied to a float32
    tensor, it needs no tensor copied to the device)."""
    return float(torch.tensor(v, dtype=torch.float32))


def _quant(x: torch.Tensor):
    """Symmetric int8 with per-row (last-axis) absmax scale; rounds half to
    even, as ``jnp.round`` does."""
    amax = torch.amax(torch.abs(x), dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, _f32(1e-20)) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequant(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


# ------------------------------------------------------------------ states
def init_opt_state(params: dict, cfg: OptConfig) -> dict:
    def zeros_like_moment(p):
        if cfg.moment_dtype == "int8":
            return {"q": torch.zeros(p.shape, dtype=torch.int8,
                                     device=p.device),
                    "scale": torch.zeros((*p.shape[:-1], 1),
                                         dtype=torch.float32,
                                         device=p.device)}
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    leaf = tree_paths(params)[0][1]
    return {"mu": tree_map(zeros_like_moment, params),
            "nu": tree_map(zeros_like_moment, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


# ---------------------------------------------------------------- schedule
def lr_schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    """Linear warm-up, then a cosine decay to ``min_lr_frac``; float32 from
    an int32 ``step``."""
    s = step.to(torch.float32)
    warm = torch.clamp_max(s / max(cfg.warmup_steps, 1), 1.0)
    prog = torch.clamp((step - cfg.warmup_steps).to(torch.float32)
                       / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


# ------------------------------------------------------------------ update
def global_norm(tree: dict) -> torch.Tensor:
    leaves = [v for _p, v in tree_paths(tree)]
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


def adamw_update(params: dict, grads: dict, state: dict, cfg: OptConfig):
    """Returns (new_params, new_state, metrics)."""
    step = state["step"] + 1
    lr = lr_schedule(step, cfg)
    gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - _f32(b1) ** sf
    bc2 = 1 - _f32(b2) ** sf

    def upd(p, g, mu, nu):
        g = g.to(torch.float32) * clip
        if cfg.moment_dtype == "int8":
            mu_f = _dequant(mu["q"], mu["scale"])
            nu_f = _dequant(nu["q"], nu["scale"])
        else:
            mu_f, nu_f = mu, nu
        mu_f = b1 * mu_f + (1 - b1) * g
        nu_f = b2 * nu_f + (1 - b2) * g * g
        upd_ = (mu_f / bc1) / (torch.sqrt(nu_f / bc2) + cfg.eps)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        pf = p.to(torch.float32)
        new_p = (pf - lr * (upd_ + wd * pf)).to(p.dtype)
        if cfg.moment_dtype == "int8":
            q1, s1 = _quant(mu_f)
            q2, s2 = _quant(nu_f)
            return new_p, {"q": q1, "scale": s1}, {"q": q2, "scale": s2}
        return new_p, mu_f, nu_f

    out = tree_map(upd, params, grads, state["mu"], state["nu"])
    new_state = {"mu": tree_map(lambda o: o[1], out),
                 "nu": tree_map(lambda o: o[2], out), "step": step}
    return tree_map(lambda o: o[0], out), new_state, \
        {"grad_norm": gnorm, "lr": lr}
