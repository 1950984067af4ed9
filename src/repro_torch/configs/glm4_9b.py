"""glm4-9b — RoPE, extreme GQA (kv=2) [hf:THUDM/glm-4-9b]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", family="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2, head_dim=128,
    d_ff=13696, vocab_size=151552, mlp="swiglu", rope_theta=1e4,
)
