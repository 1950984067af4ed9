"""BERT-base — paper evaluation model (Table IV); encoder (non-causal)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-bert", family="dense",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
    d_ff=3072, vocab_size=30522, mlp="geglu", causal=False,
)
