"""Smoothness criterions (counterpart of back2future_tpu/losses/smoothness.py).

First- and second-order contrast-sensitive smoothness have
autodiff-consistent reference backwards (the contrast weights depend only
on the target, which receives no gradient), so they are plain
differentiable functions. The KL criterion's reference backward applies
analytic formulas on eps-clamped values without zeroing clamped entries,
so under `reference_grads=True` it is an autograd Function.
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


# --------------------------------------------------------------------------
# KL divergence between neighbouring occlusion pixels
# (criterions/KLDivergenceCriterion.lua)
# --------------------------------------------------------------------------

_KL_EPS = 5e-2


def _kl_padded(occ):
    """Replication-pad by 1 and clamp below at eps
    (KLDivergenceCriterion.lua:36-40)."""
    pp = F.pad(occ.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    return torch.clamp(pp, min=_KL_EPS)


def _kl_weights(target):
    with torch.no_grad():
        wy = torch.exp(-_CS * fwd_diff_y(target).abs().mean(-1, keepdim=True))
        wx = torch.exp(-_CS * fwd_diff_x(target).abs().mean(-1, keepdim=True))
    return wy, wx


def _kl_value(occ, target, size_average):
    b, h, w, c = occ.shape
    nz = _kl_padded(occ)
    lg = torch.log(nz)
    pc, lc = nz[:, 1:1 + h, 1:1 + w], lg[:, 1:1 + h, 1:1 + w]
    pd, ld = nz[:, 2:2 + h, 1:1 + w], lg[:, 2:2 + h, 1:1 + w]    # down neighbour
    pr, lr = nz[:, 1:1 + h, 2:2 + w], lg[:, 1:1 + h, 2:2 + w]    # right neighbour
    gy = (lc - ld) * pc + (ld - lc) * pd
    gx = (lc - lr) * pc + (lr - lc) * pr
    wy, wx = _kl_weights(target)
    buf = (gx * wx + gy * wy).sum()
    return c / occ.numel() * buf if size_average else buf


class _KLFn(torch.autograd.Function):
    """KL smoothness with the reference backward (smoothness.py:139-168):
    the analytic formulas on the clamped values, to occ only."""

    @staticmethod
    def forward(ctx, occ, target, size_average):
        ctx.size_average = size_average
        ctx.save_for_backward(occ, target)
        return _kl_value(occ, target, size_average)

    @staticmethod
    def backward(ctx, g):
        occ, target = ctx.saved_tensors
        b, h, w, c = occ.shape
        nz = _kl_padded(occ)
        lg = torch.log(nz)
        pc, lc = nz[:, 1:1 + h, 1:1 + w], lg[:, 1:1 + h, 1:1 + w]
        pd, ld = nz[:, 2:2 + h, 1:1 + w], lg[:, 2:2 + h, 1:1 + w]
        pr, lr = nz[:, 1:1 + h, 2:2 + w], lg[:, 1:1 + h, 2:2 + w]
        pu, lu = nz[:, 0:h, 1:1 + w], lg[:, 0:h, 1:1 + w]          # up neighbour
        pl, ll = nz[:, 1:1 + h, 0:w], lg[:, 1:1 + h, 0:w]          # left neighbour
        wy, wx = _kl_weights(target)
        # the reference's analytic formulas on clamped values
        # (KLDivergenceCriterion.lua:84-103)
        gy = (lc - ld + 1.0 - pd / pc) * wy
        tmp = -pu / pc + lc - lu + 1.0
        tmp[:, 1:] *= wy[:, :-1]
        gy = gy + tmp
        gx = (lc - lr + 1.0 - pr / pc) * wx
        tmp = -pl / pc + lc - ll + 1.0
        tmp[:, :, 1:] *= wx[:, :, :-1]
        gx = gx + tmp
        norm = (c / occ.numel()) if ctx.size_average else 1.0
        return (gx + gy) * norm * g, None, None


@functools.lru_cache(maxsize=None)
def make_kl_smoothness(size_average: bool = True, reference_grads: bool = True):
    """fn(occ, target) -> scalar: the contrast-weighted KL divergence
    between neighbouring occlusion pixels; the target gets no gradient."""

    def kl(occ, target):
        if reference_grads:
            return _KLFn.apply(occ, target, size_average)
        return _kl_value(occ, target, size_average)

    return kl
