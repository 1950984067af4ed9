"""The single-device train step.

``make_train_step`` builds

    (params, opt_state, batch) -> (params, opt_state, metrics)

with microbatched gradient accumulation (the reference's ``lax.scan`` over
microbatches, in its order: gradients summed from zero, then divided by
the count), global-norm clipping and AdamW.  Gradients come from
``torch.autograd.grad`` over the port's ``forward`` and ``cross_entropy``.
``batch`` holds torch tensors (``"inputs"``: (B, S) int tokens or (B, S, d)
embeddings, ``"labels"``: (B, S) int).

The reference's cross-pod sync modes (``overlap_sync``, ``sync_compressed``,
``sync_buckets``) belong to distribution and are not ported: setting any of
them raises ``NotImplementedError``.  ``cfg.gather_params_once`` is a no-op
on one device in the reference too (no mesh), and so here.
"""

from __future__ import annotations

import torch

from repro_torch.models import cross_entropy, forward
from repro_torch.models.config import ModelConfig
from .optimizer import OptConfig, adamw_update, tree_map, tree_paths


def _loss_and_grads(params: dict, inputs, labels, cfg: ModelConfig):
    """(loss, parts, grads): grads in each parameter's dtype."""
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    leaves = [p for _path, p in tree_paths(live)]
    with torch.enable_grad():
        logits, _ = forward(live, inputs, cfg)
        loss, parts = cross_entropy(logits, labels)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    by_leaf = {id(p): g for p, g in zip(leaves, gs)}
    grads = tree_map(lambda p: torch.zeros_like(p) if by_leaf[id(p)] is None
                     else by_leaf[id(p)], live)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(cfg: ModelConfig, opt_cfg: OptConfig,
                    microbatches: int = 1, overlap_sync: bool | None = None,
                    sync_compressed: bool = False, sync_buckets: int = 4):
    if overlap_sync is not None or sync_compressed or sync_buckets != 4:
        raise NotImplementedError(
            "the cross-pod sync modes (overlap_sync, sync_compressed, "
            "sync_buckets) belong to distribution, which is not ported")

    def train_step(params: dict, opt_state: dict, batch: dict):
        inputs, labels = batch["inputs"], batch["labels"]
        if microbatches == 1:
            loss, _parts, grads = _loss_and_grads(params, inputs, labels,
                                                  cfg)
        else:
            m = microbatches
            b = inputs.shape[0]
            assert b % m == 0, (b, m)
            mb = b // m
            grads = tree_map(torch.zeros_like, params)
            lsum = torch.zeros((), dtype=torch.float32, device=inputs.device)
            for i in range(m):
                sl = slice(i * mb, (i + 1) * mb)
                l, _p, g = _loss_and_grads(params, inputs[sl], labels[sl],
                                           cfg)
                grads = tree_map(torch.add, grads, g)
                lsum = lsum + l
            grads = tree_map(lambda g: g / m, grads)
            loss = lsum / m
        new_params, new_opt, om = adamw_update(params, grads, opt_state,
                                               opt_cfg)
        metrics = {"loss": loss, **om,
                   "tokens": torch.full((), inputs.shape[0] * inputs.shape[1],
                                        dtype=torch.float32,
                                        device=inputs.device)}
        return new_params, new_opt, metrics

    return train_step
