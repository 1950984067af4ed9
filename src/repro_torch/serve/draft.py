"""Draft-token proposers for speculative decoding.

Speculative decode splits each serving tick into *propose* (cheap guesses at
the next ``k`` tokens per active request) and *verify* (one fused target
forward scores all ``k+1`` positions; the accepted prefix commits, the rest
rolls back).  The proposer only affects *speed* — a bad draft costs wasted
verify positions, never wrong output, because the target model gates every
committed token.

Two sources:

* :class:`NgramProposer` — prompt-lookup self-draft.  No second model: the
  most recent occurrence of the context's trailing n-gram predicts its
  historical continuation.  Free to run, and effective exactly when decode
  output is repetitive (templated generation, code, shared-prefix serving
  traces).
* :class:`DraftModelProposer` — a small autoregressive draft model sharing
  the target's config machinery (same vocab required).  Runs a greedy
  ``k``-token rollout per tick: one batched prefill over each request's
  committed context, then ``k-1`` cached decode steps.  Deliberately
  stateless across ticks (it re-prefills the context each tick) — simple and
  always consistent with rollbacks, at the cost of redundant draft compute.

On a mesh (registered when the proposer is made) the draft's weights are
placed DTensors, its rollout runs under DTensor's implicit replication as
the engine's dispatches do, its rollout cache is grown placed
(:func:`~repro_torch.serve.cache.grow_placed`) and its logits are gathered
whole before the argmax, so every rank drafts the same tokens.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.core.instrument import capturing
from repro_torch.dist.sharding import get_mesh
from repro_torch.models import init_params
from repro_torch.models.lm import forward
from repro_torch.train.trainer import serve_shardings

from .cache import grow_placed, pad_cache_to, to_device, to_host
from .scheduler import pad_group


class NgramProposer:
    """Prompt-lookup drafting: match the context's trailing n-gram against
    its own history (longest n first), propose the ``k`` tokens that
    followed the most recent earlier occurrence.  Returns fewer than ``k``
    (possibly zero) tokens when no n-gram recurs."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        assert max_ngram >= min_ngram >= 1
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, contexts, k: int) -> list:
        return [self._one(np.asarray(c), k) for c in contexts]

    def _one(self, ctx: np.ndarray, k: int) -> np.ndarray:
        n_ctx = len(ctx)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            if n_ctx <= n:
                continue
            pat = ctx[-n:]
            # windows over ctx[:-1]: every earlier position the n-gram ends
            # at (the final occurrence itself is excluded by the slice)
            win = np.lib.stride_tricks.sliding_window_view(ctx[:-1], n)
            hits = np.flatnonzero((win == pat[None, :]).all(axis=1))
            if len(hits):
                # most recent occurrence with a full k-token continuation;
                # an occurrence right at the context end would predict
                # almost nothing (its continuation is cut off)
                full = hits[hits + n + k <= n_ctx]
                start = int(full[-1] if len(full) else hits[-1]) + n
                d = ctx[start:start + k]
                if len(d):
                    return d.astype(np.int32)
        return np.zeros((0,), np.int32)


class DraftModelProposer:
    """Greedy ``k``-token rollout from a small draft LM (same vocab as the
    target).  ``params=None`` draws a fresh init from ``seed`` on
    ``device`` — with ``cfg``/``params`` equal to the target's, every draft
    token is accepted (the degenerate self-draft sanity case).  On a
    mesh, every rank draws the weights placed, leaf by leaf
    (``init_params(shardings=)``)."""

    def __init__(self, cfg, params=None, seed: int = 1, device="cuda"):
        if cfg.family != "dense":
            raise NotImplementedError(
                "draft models must be dense attention LMs (the rollout "
                "appends through a KV cache)")
        self.cfg = cfg
        self.mesh = get_mesh()
        if params is None:
            # the weights' placements depend on no batch or sequence size
            shardings = (serve_shardings(self.mesh, cfg, 1, 1)[0]
                         if self.mesh is not None else None)
            params = init_params(cfg, seed, device, shardings=shardings)
        self.params = params
        self.device = self.params["final_norm"].device

    def _forward(self, *args, **kw):
        # the reference's rollout is jitted: no operator hooks fire
        on_mesh = (implicit_replication() if self.mesh is not None
                   else contextlib.nullcontext())
        with torch.no_grad(), capturing(), on_mesh:
            return forward(self.params, *args, self.cfg, **kw)

    def _grow(self, cache: dict, span: int) -> dict:
        """The prefill's cache with room for ``span`` positions."""
        if self.mesh is None:
            return pad_cache_to(cache, self.cfg, span)
        rows = cache["kv"]["k"].shape[1]
        return grow_placed(cache, span, self.mesh, serve_shardings(
            self.mesh, self.cfg, rows, span)[1]["kv"])

    def propose(self, contexts, k: int) -> list:
        toks, lens = pad_group([np.asarray(c) for c in contexts], pow2=True)
        logits, cache = self._forward(
            to_device(toks, self.device), return_cache=True,
            logits_mode="index",
            logits_index=to_device(lens - 1, self.device))
        # decode appends need k-1 extra cache positions past the bucket; the
        # per-row length override then hides each row's right-pad junk
        cache = self._grow(cache, toks.shape[1] + k)
        cache["kv"] = dict(cache["kv"], length=to_device(lens, self.device))
        out = np.zeros((len(contexts), k), np.int32)
        tok = _argmax(logits[:, 0, :])
        out[:, 0] = tok
        for i in range(1, k):
            logits, cache = self._forward(to_device(tok[:, None],
                                                    self.device),
                                          cache=cache, logits_mode="last")
            tok = _argmax(logits[:, -1, :])
            out[:, i] = tok
        return [out[i] for i in range(len(contexts))]


def _argmax(logits: torch.Tensor) -> np.ndarray:
    """Greedy tokens on the host (float32 first: numpy has no bf16; a
    DTensor's logits gathered whole)."""
    return np.argmax(to_host(logits), axis=-1).astype(np.int32)
