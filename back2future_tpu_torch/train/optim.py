"""Optimiser and learning-rate regimes (counterpart of
back2future_tpu/train/optim.py; train.lua:27-121, opts.lua:75-79).

Default recipe: Adam, LR 1e-4 halved at epochs 201/401/601/801. The JAX
package chains optax's `add_decayed_weights(wd)`, then
`clip_by_global_norm(clip)`, then `adam(b1=.9, b2=.999, eps=1e-8)` or
`sgd(momentum)`. `torch.optim.Adam(weight_decay=wd)` would add the decay
after a clip done before `step()`, so `ChainOptimizer` applies the chain
by hand in optax's order: the decay is added to the gradients, the
global-norm clip (optax's rule: scale by clip/norm when norm >= clip) is
applied on the device without a host sync, and then the update rule runs
with no decay of its own.
"""

from __future__ import annotations

from typing import Iterable, List

import torch


def lr_for_epoch(epoch: int, base_lr: float = 0.0) -> float:
    """LR for a 1-indexed epoch (train.lua:66-92)."""
    lr = base_lr if base_lr > 0 else 1e-4
    for i, (start, end) in enumerate([(1, 200), (201, 400), (401, 600),
                                      (601, 800), (801, 1000)]):
        if start <= epoch <= end:
            return lr / (2 ** i)
    return lr / 16  # beyond epoch 1000: keep the final regime


class ChainOptimizer:
    """add_decayed_weights -> clip_by_global_norm -> `rule`, as optax chains
    them. `rule` is a torch optimiser over the same parameters with no
    weight decay."""

    def __init__(self, params: List[torch.nn.Parameter], rule: torch.optim.Optimizer,
                 weight_decay: float, grad_clip: float):
        self.params = params
        self.rule = rule
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    @property
    def lr(self) -> float:
        return self.rule.param_groups[0]["lr"]

    def set_lr(self, lr: float) -> None:
        for group in self.rule.param_groups:
            group["lr"] = lr

    def zero_grad(self) -> None:
        self.rule.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        params = [p for p in self.params if p.grad is not None]
        grads = [p.grad for p in params]
        if self.weight_decay > 0:
            torch._foreach_add_(grads, params, alpha=self.weight_decay)
        if self.grad_clip > 0 and grads:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
            scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                                self.grad_clip / norm)
            torch._foreach_mul_(grads, scale)
        self.rule.step()


def make_optimizer(opt, params: Iterable[torch.nn.Parameter], epoch: int = 1,
                   lr_override: float = 0.0) -> ChainOptimizer:
    """The optimiser for one epoch's regime (or a pinned LR)."""
    params = list(params)
    lr = lr_override if lr_override > 0 else lr_for_epoch(epoch, opt.LR)
    if opt.optimizer == "adam":
        # torch optim.adam defaults: beta1=0.9, beta2=0.999, eps=1e-8
        rule = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    elif opt.optimizer == "sgd":
        # torch optim.sgd: momentum with dampening=0, as optax.sgd's trace
        rule = torch.optim.SGD(params, lr=lr, momentum=opt.momentum)
    else:
        raise ValueError(f"unknown optimizer {opt.optimizer!r}")
    return ChainOptimizer(params, rule, opt.weightDecay, getattr(opt, "grad_clip", 0.0))
