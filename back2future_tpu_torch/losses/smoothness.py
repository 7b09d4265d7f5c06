"""Smoothness criterions (counterpart of back2future_tpu/losses/smoothness.py).

First-order contrast-sensitive smoothness has an autodiff-consistent
reference backward (the contrast weights depend only on the target, which
receives no gradient), so it is a plain differentiable function. The
second-order variant and the KL occlusion smoothness are not ported yet
(ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import functools

import torch

from .common import fwd_diff_x, fwd_diff_y
from .penalty import make_penalty

_CS = 20.0  # contrast sensitivity (SmoothnessCriterion.lua:25)


@dataclasses.dataclass(frozen=True)
class SmoothConfig:
    penalty: str = "Quadratic"
    size_average: bool = True
    second_order: bool = False
    reference_grads: bool = True


def smoothness(flow: torch.Tensor, target: torch.Tensor, cfg: SmoothConfig) -> torch.Tensor:
    """First-order contrast-sensitive smoothness
    (criterions/SmoothnessCriterion.lua:28-73)."""
    p = make_penalty(cfg.penalty)
    gy, gx = fwd_diff_y(flow), fwd_diff_x(flow)
    with torch.no_grad():
        wy = torch.exp(-_CS * fwd_diff_y(target).abs().mean(-1, keepdim=True))
        wx = torch.exp(-_CS * fwd_diff_x(target).abs().mean(-1, keepdim=True))
    buf = (p.apply(gx) * wx + p.apply(gy) * wy).sum()
    if cfg.size_average:
        buf = buf / flow.numel()
    return buf


def make_flow_smoothness(cfg: SmoothConfig):
    if cfg.second_order:
        raise NotImplementedError("second-order smoothness is not ported yet "
                                  "(ROADMAP.md queue 1 item 8, the soft recipe)")
    return functools.partial(smoothness, cfg=cfg)
