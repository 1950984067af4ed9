"""Model substrate of the port: the decoder LM of the dense (GQA + GLU
MLP; vlm and audio with the stubbed embed frontend), moe, ssm (Mamba2) and
hybrid (Zamba2) families, and its loss."""

from .config import ModelConfig
from .lm import init_params, forward, cross_entropy
from . import layers, mamba2, moe

__all__ = ["ModelConfig", "init_params", "forward", "cross_entropy",
           "layers", "mamba2", "moe"]
