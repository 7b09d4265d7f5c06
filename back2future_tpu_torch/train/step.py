"""The train and eval steps (counterpart of back2future_tpu/train/step.py).

A train step: decode the batch on the device, run the forward (with the
image warps for `optimize="pme"`, whose photometric term reads them; the
supervised "epe" loss reads none, so its forward skips them), the
multi-scale loss, `backward` (through the hand-written backward kernels on
CUDA tensors), then the optimiser at the epoch's regime LR. The
parameters are updated in place. With `-remat 1` the forward runs under
non-reentrant activation checkpointing, one region for the whole net:
autograd keeps only its inputs and recomputes it during the backward (the
counterpart of `jax.checkpoint(policy=nothing_saveable)`), so every
forward kernel runs twice a step. The first tensor the backward unpacks
recomputes the whole forward, so the backward holds the activation
pyramid again; the peak drops only by what the loss holds beside it
(PERF.md). The forward draws no random numbers, so the recompute needs
no saved RNG state. An eval step is the forward and the loss under
`torch.no_grad()`, with no backward. Both add the ground-truth metrics
when `opt.ground_truth` is set and the batch holds `flow_gt` (the
occlusion ones only when the model has an occlusion head: `frames > 2
and not no_occ`). Nothing in either step reads a device value on the
host: the logs are 0-d device tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.utils.checkpoint

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


def _with_warped(opt) -> bool:
    """Whether the loss reads the image warps: only the photometric term
    of `optimize="pme"` does."""
    return opt.optimize == "pme"


def make_train_step(model: torch.nn.Module, opt, crits) -> Callable:
    """Build step(state, batch) -> (state, logs) for a state made by
    `create_train_state(model, opt)`."""
    with_warped = _with_warped(opt)

    def forward(images):
        if getattr(opt, "remat", 0):
            return torch.utils.checkpoint.checkpoint(model, images, with_warped,
                                                     use_reentrant=False,
                                                     preserve_rng_state=False)
        return model(images, with_warped)

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        batch = decode_batch(batch)
        optimizer = state.optimizer
        optimizer.set_lr(lr_for_epoch(state.epoch, opt.LR))
        optimizer.zero_grad()
        outputs = forward(batch["images"])
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
        outputs = model(batch["images"], _with_warped(opt))
        loss, comps = multiscale_loss(outputs, batch, opt, crits)
        return _logs(loss, comps, outputs, batch, opt)

    return eval_step
