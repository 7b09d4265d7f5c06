"""Train state (counterpart of back2future_tpu/train/state.py).

Unlike the JAX package's immutable pytree, the port's state holds the
module itself, whose parameters the step updates in place, and the
optimiser (with its moments) built over them.
"""

from __future__ import annotations

import dataclasses

import torch

from .optim import ChainOptimizer, make_optimizer


@dataclasses.dataclass(frozen=True)
class TrainState:
    model: torch.nn.Module
    optimizer: ChainOptimizer
    step: int = 0          # global step counter
    epoch: int = 1

    def with_epoch(self, epoch: int, opt) -> "TrainState":
        """Enter a new epoch regime. Mirrors the reference's per-epoch
        optimState rebuild (train.lua:112-121): a fresh optimiser each
        epoch (Adam moments reset) unless `adam_reset_per_epoch` is off."""
        new = dataclasses.replace(self, epoch=epoch)
        if getattr(opt, "adam_reset_per_epoch", True):
            new = dataclasses.replace(new, optimizer=make_optimizer(
                opt, self.model.parameters(), epoch))
        return new


def create_train_state(model: torch.nn.Module, opt, epoch: int = 1) -> TrainState:
    return TrainState(model=model, optimizer=make_optimizer(opt, model.parameters(), epoch),
                      step=0, epoch=epoch)
