"""kimi-k2-1t-a32b — trillion-param MoE, 384 experts top-8 + 1 shared
[arXiv:2501.kimi2].  Memory policy: bf16 params + int8 Adam moments (f32
states would need ~14 TB)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab_size=163840, mlp="swiglu", rope_theta=5e4,
    n_experts=384, n_experts_active=8, d_ff_expert=2048, n_shared_experts=1,
    param_dtype="bfloat16", opt_moment_dtype="int8",
)
