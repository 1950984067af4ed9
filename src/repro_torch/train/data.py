"""Data pipeline: deterministic, step-indexed, per-host sharded (numpy, as
the reference's is, so ``batch_at(step)`` equals it bit for bit).

Restart-safe by construction: ``batch_at(step)`` is a pure function of
(seed, step), so a restarted job resumes bit-exactly from the checkpointed
step with no pipeline state to save (stateless skip-ahead).  Each host
materializes only its slice of the global batch.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend: str = "none"       # "embed" archs get float frame embeddings
    d_model: int = 0


class TokenSource:
    """Base: deterministic per-step token batches."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.default_rng(
            [self.cfg.seed, step, self.host_id])

    def tokens_at(self, step: int) -> np.ndarray:
        raise NotImplementedError

    def batch_at(self, step: int) -> dict:
        toks = self.tokens_at(step)                 # (local_batch, seq+1)
        batch = {"labels": toks[:, 1:].astype(np.int32)}
        if self.cfg.frontend == "embed":
            rng = self._rng(step)
            batch["inputs"] = rng.standard_normal(
                (self.local_batch, self.cfg.seq_len, self.cfg.d_model),
                dtype=np.float32)
        else:
            batch["inputs"] = toks[:, :-1].astype(np.int32)
        return batch


class SyntheticTokens(TokenSource):
    """Zipfian synthetic tokens (vocab-realistic frequency skew)."""

    def tokens_at(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        u = rng.random((self.local_batch, self.cfg.seq_len + 1))
        # inverse-CDF Zipf over the vocab (alpha ~1): cheap and heavy-tailed
        v = self.cfg.vocab_size
        toks = np.minimum((np.exp(u * np.log(v)) - 1).astype(np.int64),
                          v - 1)
        return toks


class FileTokens(TokenSource):
    """Memory-mapped flat token file (uint16/uint32), random chunks by step."""

    def __init__(self, path: str, cfg: DataConfig, dtype=np.uint16,
                 host_id: int = 0, n_hosts: int = 1):
        super().__init__(cfg, host_id, n_hosts)
        self.data = np.memmap(path, dtype=dtype, mode="r")
        assert len(self.data) > cfg.seq_len + 1, "token file too small"

    def tokens_at(self, step: int) -> np.ndarray:
        rng = self._rng(step)
        n = len(self.data) - self.cfg.seq_len - 1
        starts = rng.integers(0, n, size=self.local_batch)
        return np.stack([np.asarray(
            self.data[s:s + self.cfg.seq_len + 1]) for s in starts])


def make_source(cfg: DataConfig, path: str | None = None, **kw) -> TokenSource:
    if path:
        return FileTokens(path, cfg, **kw)
    return SyntheticTokens(cfg, **kw)
