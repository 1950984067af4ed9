"""musicgen-large — decoder-only over EnCodec tokens; the EnCodec
frame-embedding frontend is a stub (input_specs supplies precomputed frame
embeddings) [arXiv:2306.05284]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=2048, mlp="swiglu", frontend="embed",
)
