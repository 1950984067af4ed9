"""Training substrate of the port, on one device: optimizer, data and the
train step."""

from .optimizer import OptConfig, init_opt_state, adamw_update, lr_schedule
from .trainer import make_train_step
from .data import DataConfig, SyntheticTokens, FileTokens, make_source

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_schedule",
           "make_train_step", "DataConfig", "SyntheticTokens", "FileTokens",
           "make_source"]
