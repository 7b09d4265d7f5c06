"""The train step (counterpart of back2future_tpu/train/step.py:23-85).

One step: decode the batch on the device, run the forward with the image
warps, the multi-scale loss, `backward` (through the hand-written
backward kernels on CUDA tensors), then the optimiser at the epoch's
regime LR. The parameters are updated in place. Nothing in the step reads
a device value on the host: the logs are 0-d device tensors.

Not ported yet (ROADMAP.md queue 1 item 9): `remat`, the ground-truth
metrics (`ground_truth=1`) and the eval step; each raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from ..data.wire import decode_batch
from .multiscale import multiscale_loss
from .optim import lr_for_epoch
from .state import TrainState

_TODO = "is not ported yet (ROADMAP.md queue 1 item 9)"


def make_train_step(model: torch.nn.Module, opt, crits) -> Callable:
    """Build step(state, batch) -> (state, logs) for a state made by
    `create_train_state(model, opt)`."""
    if getattr(opt, "remat", 0):
        raise NotImplementedError(f"remat {_TODO}")
    if opt.ground_truth:
        raise NotImplementedError(f"the ground-truth metrics of the train step {_TODO}")

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = decode_batch(batch)
        optimizer = state.optimizer
        optimizer.set_lr(lr_for_epoch(state.epoch, opt.LR))
        optimizer.zero_grad()
        outputs = model(batch["images"], with_warped=True)
        loss, comps = multiscale_loss(outputs, batch, opt, crits)
        loss.backward()
        optimizer.step()
        logs = {"loss": loss.detach(), **{k: v.detach() for k, v in comps.items()}}
        return dataclasses.replace(state, step=state.step + 1), logs

    return step


def make_eval_step(model, opt, crits) -> Callable:
    raise NotImplementedError(f"the eval step {_TODO}")
