"""Training substrate of the port: optimizer, trainer (on one device or a
``DeviceMesh``), data, checkpoint, elasticity."""

from .optimizer import OptConfig, init_opt_state, adamw_update, lr_schedule
from .trainer import (make_train_step, train_shardings, abstract_state,
                      tree_shardings, batch_shardings, place,
                      make_prefill_step, make_decode_step, serve_shardings)
from .data import DataConfig, SyntheticTokens, FileTokens, make_source
from . import checkpoint
from .elastic import LoopConfig, TrainLoop

__all__ = ["OptConfig", "init_opt_state", "adamw_update", "lr_schedule",
           "make_train_step", "train_shardings", "abstract_state",
           "tree_shardings", "batch_shardings", "place",
           "make_prefill_step", "make_decode_step", "serve_shardings",
           "DataConfig",
           "SyntheticTokens", "FileTokens", "make_source", "checkpoint",
           "LoopConfig", "TrainLoop"]
