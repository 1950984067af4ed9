"""Weights and tokens of a cell, drawn on the device from ``--seed``.

The benchmark makes the inputs that the program and the plain reference
both take.  Every parameter lives in one flat float32 buffer drawn by one
``normal_`` call of a ``torch.Generator`` on the device; each leaf is a
view of it, shaped and scaled in place.  A configuration's reference
(``configs/<name>.py``) gives the tree's layout, ``{key: subtree | (shape,
kind, fan_in)}``, as the port's ``models.forward`` reads it (stacked
leading layer axes), built from the blocks below; none of the port's code
makes it.

Leaf values, as drawn from z ~ N(0, 1):

* projections: z / sqrt(fan_in); the embedding 0.02 z; convolutions 0.1 z;
* norm scales (applied as ``1 + scale``): 0.1 z;
* a state-space layer's ``A_log`` 0.5 z, ``dt_bias`` -2 + 0.5 z, ``D``
  1 + 0.1 z.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 2 ** 63


def attn(cfg, lead=()) -> dict:
    """An attention block's projections, ``lead`` axes first."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"wq": (lead + (d, h, hd), "w", d), "wk": (lead + (d, kv, hd), "w", d),
            "wv": (lead + (d, kv, hd), "w", d),
            "wo": (lead + (h, hd, d), "w", h * hd)}


def mlp(cfg, lead=()) -> dict:
    """A gated MLP's projections, ``lead`` axes first."""
    d, f = cfg.d_model, cfg.d_ff
    return {"w_gate": (lead + (d, f), "w", d), "w_up": (lead + (d, f), "w", d),
            "w_down": (lead + (f, d), "w", f)}


def ends(cfg) -> dict:
    """The embedding, the final norm and an untied output head."""
    d, v = cfg.d_model, cfg.vocab_size
    return {"embed": ((v, d), "embed", 0), "lm_head": ((d, v), "w", d),
            "final_norm": ((d,), "norm", 0)}


def _leaves(tree, prefix=()):
    for key in sorted(tree):
        node = tree[key]
        if isinstance(node, dict):
            yield from _leaves(node, prefix + (key,))
        else:
            yield prefix + (key,), node


def n_params(layout: dict) -> int:
    return sum(math.prod(shape) for _p, (shape, _k, _f) in _leaves(layout))


def _shape_leaf(z: torch.Tensor, kind: str, fan_in: int) -> None:
    if kind == "w":
        z.mul_(1.0 / math.sqrt(fan_in))
    elif kind == "embed":
        z.mul_(0.02)
    elif kind in ("conv", "norm"):
        z.mul_(0.1)
    elif kind == "a_log":
        z.mul_(0.5)
    elif kind == "dt_bias":
        z.mul_(0.5).sub_(2.0)
    elif kind == "skip":
        z.mul_(0.1).add_(1.0)
    else:
        raise ValueError(kind)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % SEED_MOD)


def draw(layout: dict, gen: torch.Generator, device) -> dict:
    """The parameter tree of ``layout``, float32, drawn from ``gen``."""
    leaves = list(_leaves(layout))
    total = sum(math.prod(shape) for _p, (shape, _k, _f) in leaves)
    flat = torch.empty(total, dtype=torch.float32, device=device)
    flat.normal_(generator=gen)
    tree: dict = {}
    off = 0
    for path, (shape, kind, fan_in) in leaves:
        n = math.prod(shape)
        leaf = flat[off:off + n].view(shape)
        _shape_leaf(leaf, kind, fan_in)
        off += n
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tokens(cfg, gen: torch.Generator, batch: int, seq: int, device) -> torch.Tensor:
    """One (batch, seq) int32 batch of token ids drawn from ``gen``."""
    return torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                         dtype=torch.int32, device=device)
