"""qwen2-vl-72b — VLM backbone with M-RoPE; patch-embedding frontend is a
stub (input_specs supplies precomputed patch embeddings) [arXiv:2409.12191]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=29568, vocab_size=152064, mlp="swiglu", m_rope=True,
    rope_theta=1e6, frontend="embed",
)
