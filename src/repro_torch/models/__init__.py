"""Model substrate of the port: the dense decoder LM (GQA + GLU MLP)."""

from .config import ModelConfig
from .lm import init_params, forward
from . import layers

__all__ = ["ModelConfig", "init_params", "forward", "layers"]
