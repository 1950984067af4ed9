"""Architecture config registry: ``--arch <id>`` resolution + reduced
(smoke-test) variants: the reference's twelve architectures."""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

_ARCHS = {
    "mamba2-2.7b": "mamba2_2_7b",
    "stablelm-1.6b": "stablelm_1_6b",
    "glm4-9b": "glm4_9b",
    "gemma-7b": "gemma_7b",
    "qwen3-32b": "qwen3_32b",
    "zamba2-7b": "zamba2_7b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "dbrx-132b": "dbrx_132b",
    "kimi-k2-1t-a32b": "kimi_k2_1t_a32b",
    "musicgen-large": "musicgen_large",
    "paper-gpt2": "paper_gpt2",
    "paper-bert": "paper_bert",
}
ASSIGNED = list(_ARCHS)[:10]          # the 10 assigned architectures


def get(name: str) -> ModelConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCHS)}")
    mod = importlib.import_module(f"{__name__}.{_ARCHS[name]}")
    return mod.CONFIG


def list_archs() -> list:
    return list(_ARCHS)


def reduced(cfg: ModelConfig, seq_len: int = 64) -> ModelConfig:
    """Family-preserving tiny variant for CPU smoke tests."""
    hd = 16
    n_heads = 4 if cfg.n_heads else 0
    if cfg.n_heads:
        ratio = max(1, cfg.n_heads // max(cfg.n_kv_heads, 1))
        n_kv = max(1, n_heads // min(ratio, n_heads))
    else:
        n_kv = 0
    updates = dict(
        n_layers=5 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=n_heads, n_kv_heads=n_kv,
        head_dim=hd if cfg.n_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=min(cfg.vocab_size, 256) if cfg.vocab_size else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=8 if cfg.ssm_state else 64,
        ssm_chunk=16,
        shared_attn_every=2 if cfg.family == "hybrid" else 0,
        n_experts=4 if cfg.n_experts else 0,
        n_experts_active=2 if cfg.n_experts else 0,
        d_ff_expert=32 if cfg.n_experts else 0,
        capacity_factor=2.0,        # = e/k: dropless at smoke scale, so
                                    # teacher-forced == decode exactly
        n_shared_experts=min(cfg.n_shared_experts, 1),
        param_dtype="float32", opt_moment_dtype=cfg.opt_moment_dtype,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **updates)
