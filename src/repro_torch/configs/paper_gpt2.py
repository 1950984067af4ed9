"""GPT-2 (124M) — one of the paper's own evaluation models (Table IV)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-gpt2", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=50257, mlp="swiglu", tie_embeddings=True,
)
