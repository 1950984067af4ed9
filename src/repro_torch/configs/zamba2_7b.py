"""zamba2-7b — Mamba2 backbone + ONE weight-shared attention block applied
every 6 SSM layers [arXiv:2411.15242]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000, mlp="swiglu",
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256, ssm_groups=1,
    shared_attn_every=6,
    supports_long_context=True,
)
