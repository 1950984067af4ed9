"""Model substrate of the port: the decoder LM of the dense (GQA + GLU
MLP), moe, ssm (Mamba2) and hybrid (Zamba2) families."""

from .config import ModelConfig
from .lm import init_params, forward
from . import layers, mamba2, moe

__all__ = ["ModelConfig", "init_params", "forward", "layers", "mamba2",
           "moe"]
