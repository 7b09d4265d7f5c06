"""Training engine of the port (counterpart of back2future_tpu.train):
multi-scale loss, optimiser and LR regime, train state, the train and
eval steps, the metrics, checkpoints and the epoch loop (`run`), on one
device or over data-parallel ranks (DDP; parallel/).
"""

from .checkpoint import (latest_checkpoint, load_model_checkpoint, load_or_convert,
                         load_train_checkpoint, save_checkpoint)
from .loop import build_loaders, build_model, eval_epoch, run, train_epoch
from .metrics import decode_occ, fl_all, full_res_metrics, occ_f1
from .multiscale import LEVEL_WEIGHTS, level_weight, multiscale_loss
from .optim import ChainOptimizer, lr_for_epoch, make_optimizer
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step

__all__ = [
    "LEVEL_WEIGHTS", "level_weight", "multiscale_loss",
    "ChainOptimizer", "lr_for_epoch", "make_optimizer",
    "TrainState", "create_train_state",
    "make_eval_step", "make_train_step",
    "decode_occ", "fl_all", "occ_f1", "full_res_metrics",
    "save_checkpoint", "latest_checkpoint", "load_model_checkpoint",
    "load_train_checkpoint", "load_or_convert",
    "build_model", "build_loaders", "train_epoch", "eval_epoch", "run",
]
