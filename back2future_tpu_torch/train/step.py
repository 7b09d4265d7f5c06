"""The train and eval steps (counterpart of back2future_tpu/train/step.py).

A train step: decode the batch on the device, run the forward with the
image warps, the multi-scale loss, `backward` (through the hand-written
backward kernels on CUDA tensors), then the optimiser at the epoch's
regime LR. The parameters are updated in place. An eval step is the
forward with the image warps and the loss under `torch.no_grad()`, with
no backward. Both add the ground-truth metrics when `opt.ground_truth`
is set and the batch holds `flow_gt` (the occlusion ones only when the
model has an occlusion head: `frames > 2 and not no_occ`). Nothing in
either step reads a device value on the host: the logs are 0-d device
tensors.

Not ported yet: `remat` (ROADMAP.md queue 1 item 9e) raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from ..data.wire import decode_batch
from .metrics import full_res_metrics
from .multiscale import multiscale_loss
from .optim import lr_for_epoch
from .state import TrainState


def _logs(loss: torch.Tensor, comps: Dict[str, torch.Tensor], outputs: List[Dict[str, Any]],
          batch: Dict[str, Any], opt) -> Dict[str, torch.Tensor]:
    """The step's logs: the loss, its components and, with ground truth,
    the metrics of the finest level (back2future_tpu/train/step.py:65-70)."""
    logs = {"loss": loss.detach(), **{k: v.detach() for k, v in comps.items()}}
    if opt.ground_truth and "flow_gt" in batch:
        g0 = outputs[0]
        occ = g0["occ"] if (opt.frames > 2 and not opt.no_occ) else None
        with torch.no_grad():
            logs.update(full_res_metrics(g0["flow"], occ, batch, opt.flownet_factor,
                                         opt.sizeAverage))
    return logs


def make_train_step(model: torch.nn.Module, opt, crits) -> Callable:
    """Build step(state, batch) -> (state, logs) for a state made by
    `create_train_state(model, opt)`."""
    if getattr(opt, "remat", 0):
        raise NotImplementedError("remat is not ported yet (ROADMAP.md queue 1 item 9e)")

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = decode_batch(batch)
        optimizer = state.optimizer
        optimizer.set_lr(lr_for_epoch(state.epoch, opt.LR))
        optimizer.zero_grad()
        outputs = model(batch["images"], with_warped=True)
        loss, comps = multiscale_loss(outputs, batch, opt, crits)
        logs = _logs(loss, comps, outputs, batch, opt)
        loss.backward()
        optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), logs

    return step


def make_eval_step(model: torch.nn.Module, opt, crits) -> Callable:
    """Build eval_step(batch) -> logs: forward + losses + metrics, no
    backward (test.lua:101-312; back2future_tpu/train/step.py:88-106)."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = decode_batch(batch)
        outputs = model(batch["images"], with_warped=True)
        loss, comps = multiscale_loss(outputs, batch, opt, crits)
        return _logs(loss, comps, outputs, batch, opt)

    return eval_step
