"""Training engine of the port (counterpart of back2future_tpu.train):
multi-scale loss, optimiser and LR regime, train state, train step.

The epoch loop, checkpoints and the metrics are not ported yet
(ROADMAP.md queue 1 item 9).
"""

from .multiscale import LEVEL_WEIGHTS, level_weight, multiscale_loss
from .optim import ChainOptimizer, lr_for_epoch, make_optimizer
from .state import TrainState, create_train_state
from .step import make_eval_step, make_train_step

__all__ = [
    "LEVEL_WEIGHTS", "level_weight", "multiscale_loss",
    "ChainOptimizer", "lr_for_epoch", "make_optimizer",
    "TrainState", "create_train_state",
    "make_eval_step", "make_train_step",
]
