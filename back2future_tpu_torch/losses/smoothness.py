"""Smoothness criterions (counterpart of back2future_tpu/losses/smoothness.py).

First- and second-order contrast-sensitive smoothness have
autodiff-consistent reference backwards (the contrast weights depend only
on the target, which receives no gradient), so they are plain
differentiable functions. The KL occlusion smoothness is not ported yet
(ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

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


def _two_sided_weights(t: torch.Tensor, dim: int) -> torch.Tensor:
    """exp(-20 * ig), ig the two-sided accumulated mean |target gradient|
    along `dim` (1: H, 2: W): ig[1:] += mean|t[1:] - t[:-1]|,
    ig[1:-1] += mean|t[1:-1] - t[2:]| (SecondOrderSmoothnessCriterion.lua:49-56)."""
    n = t.shape[dim]
    ig = torch.zeros(t.shape[:3] + (1,), dtype=t.dtype, device=t.device)
    ig.narrow(dim, 1, n - 1).add_(torch.diff(t, dim=dim).abs().mean(-1, keepdim=True))
    back = (t.narrow(dim, 1, n - 2) - t.narrow(dim, 2, n - 2)).abs().mean(-1, keepdim=True)
    ig.narrow(dim, 1, n - 2).add_(back)
    return torch.exp(-_CS * ig)


def second_order_smoothness(flow: torch.Tensor, target: torch.Tensor,
                            cfg: SmoothConfig) -> torch.Tensor:
    """Second-order variant on 2u_i - u_{i-1} - u_{i+1} with two-sided
    image-gradient weights (criterions/SecondOrderSmoothnessCriterion.lua)."""
    p = make_penalty(cfg.penalty)
    gy = F.pad(2 * flow[:, 1:-1] - flow[:, :-2] - flow[:, 2:], (0, 0, 0, 0, 1, 1))
    gx = F.pad(2 * flow[:, :, 1:-1] - flow[:, :, :-2] - flow[:, :, 2:], (0, 0, 1, 1))
    with torch.no_grad():
        wy, wx = _two_sided_weights(target, 1), _two_sided_weights(target, 2)
    buf = (p.apply(gx) * wx + p.apply(gy) * wy).sum()
    if cfg.size_average:
        buf = buf / flow.numel()
    return buf


def make_flow_smoothness(cfg: SmoothConfig):
    fn = second_order_smoothness if cfg.second_order else smoothness
    return functools.partial(fn, cfg=cfg)
