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

A train step runs as five spans (utils.timing.span; they open a
profiler range only while a profiler runs), in order and unnested:
`step.decode`, `step.forward`, `step.loss` (the loss and its logs),
`step.backward` (the gradients' reset, which sets them to None and
launches nothing, and `backward`) and `step.optimizer` (the regime LR
and the update). The gradients stay on the parameters after a step. The
eval step opens none.

Inside a process group (parallel/distributed.py; of one rank too) the
train step runs the net through DistributedDataParallel, whose
gradient hook sums the ranks' gradients of their loss shares
(train/multiscale.py), so one step on each rank's slice equals one step
on the global batch; the loss and its components are summed over ranks
and the metrics reduced as ratios of global sums, so every rank logs
the global batch's values. DDP wraps a module that holds the net (and
the remat region, so that the recompute runs inside DDP's forward);
`state.model` stays the bare net, whose state_dict checkpoints save.
With a spatial mesh axis the net carries its spatial group
(`net.spatial_comm`, parallel/spatial.py): both steps take the data slot's
whole batch, and the net computes its row bands and returns them as
they are (`bands=True`): the loss and the metrics work on each sharded
level's band, and on the levels the plan leaves whole with a share
that accounts for the S ranks that compute them alike
(train/multiscale.py, parallel/distributed.py).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch
import torch.utils.checkpoint

from ..data.wire import decode_batch
from ..parallel.distributed import all_reduce_sum, data_parallel, in_group, sum_gradients_hook
from ..utils.timing import span
from .metrics import full_res_metrics
from .multiscale import multiscale_loss
from .optim import lr_for_epoch
from .state import TrainState


def _logs(loss: torch.Tensor, comps: Dict[str, torch.Tensor], outputs: List[Dict[str, Any]],
          batch: Dict[str, Any], opt) -> Dict[str, torch.Tensor]:
    """The step's logs: the loss, its components and, with ground truth,
    the metrics of the finest level (back2future_tpu/train/step.py:65-70)."""
    logs = {"loss": loss.detach(), **{k: v.detach() for k, v in comps.items()}}
    if data_parallel():
        total = all_reduce_sum(torch.stack(list(logs.values())))
        logs = dict(zip(logs, total.unbind()))
    if opt.ground_truth and "flow_gt" in batch:
        g0 = outputs[0]
        occ = g0["occ"] if (opt.frames > 2 and not opt.no_occ) else None
        with torch.no_grad():
            logs.update(full_res_metrics(g0["flow"], occ, batch, opt.flownet_factor,
                                         opt.sizeAverage, g0.get("band")))
    return logs


def _with_warped(opt) -> bool:
    """Whether the loss reads the image warps: only the photometric term
    of `optimize="pme"` does."""
    return opt.optimize == "pme"


class _Forward(torch.nn.Module):
    """The train step's forward: the net, under one activation-checkpoint
    region with `remat`."""

    def __init__(self, net: torch.nn.Module, remat: bool):
        super().__init__()
        self.net = net
        self.remat = remat

    def forward(self, images, with_warped: bool):
        if self.remat:
            return torch.utils.checkpoint.checkpoint(self.net, images, with_warped, True,
                                                     use_reentrant=False,
                                                     preserve_rng_state=False)
        return self.net(images, with_warped, True)


def data_parallel_module(module: torch.nn.Module) -> torch.nn.Module:
    """`module` under DistributedDataParallel with the summing gradient
    hook (module docstring); rank 0's parameters are broadcast to every
    rank when it is built, which all ranks do together.

    Some recipes leave parameters that no loss reaches (under
    `optimize="epe"` with `past_flow`, the past decoders feed only the
    flow_past output, which the supervised loss does not read), so DDP
    walks each step's graph for them (`find_unused_parameters`): their
    gradients stay None, as without a group. `static_graph` is no
    substitute: where a returned output that no loss reads holds such
    parameters, it leaves the second step's gradients unreduced and
    fails the third step."""
    device = next(module.parameters()).device
    ddp = torch.nn.parallel.DistributedDataParallel(
        module, device_ids=[device.index] if device.type == "cuda" else None,
        find_unused_parameters=True)
    ddp.register_comm_hook(None, sum_gradients_hook)
    return ddp


def make_train_step(model: torch.nn.Module, opt, crits) -> Callable:
    """Build step(state, batch) -> (state, logs) for a state made by
    `create_train_state(model, opt)`. Inside a process group every rank
    builds its step together (DDP's set-up is a collective)."""
    with_warped = _with_warped(opt)
    forward = _Forward(model, bool(getattr(opt, "remat", 0)))
    if in_group():
        forward = data_parallel_module(forward)

    def step(state: TrainState, batch: Dict[str, Any]
             ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        optimizer = state.optimizer
        with span("step.decode"):
            batch = decode_batch(batch)
        with span("step.forward"):
            outputs = forward(batch["images"], with_warped)
        with span("step.loss"):
            loss, comps = multiscale_loss(outputs, batch, opt, crits)
            logs = _logs(loss, comps, outputs, batch, opt)
        with span("step.backward"):
            optimizer.zero_grad()
            loss.backward()
        with span("step.optimizer"):
            optimizer.set_lr(lr_for_epoch(state.epoch, opt.LR))
            optimizer.step()
        return dataclasses.replace(state, step=state.step + 1), logs

    step.forward = forward   # the module the step runs: DDP inside a group
    return step


def make_eval_step(model: torch.nn.Module, opt, crits) -> Callable:
    """Build eval_step(batch) -> logs: forward + losses + metrics, no
    backward (test.lua:101-312; back2future_tpu/train/step.py:88-106)."""

    @torch.no_grad()
    def eval_step(batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = decode_batch(batch)
        outputs = model(batch["images"], _with_warped(opt), True)
        loss, comps = multiscale_loss(outputs, batch, opt, crits)
        return _logs(loss, comps, outputs, batch, opt)

    return eval_step
