"""dbrx-132b — fine-grained MoE, 16 experts top-4 [hf:databricks/dbrx-base]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=10752, vocab_size=100352, mlp="swiglu", rope_theta=5e5,
    n_experts=16, n_experts_active=4, d_ff_expert=10752,
)
