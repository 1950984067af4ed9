"""mamba2-2.7b — SSD (state-space duality), attention-free [arXiv:2405.21060]."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, ssm_chunk=256,
    ssm_groups=1, tie_embeddings=True,
    supports_long_context=True,
)
