"""Occlusion prior and constant-velocity criterions (counterpart of
back2future_tpu/losses/priors.py).

Both reference backwards deviate from the true gradient, so under
`reference_grads=True` each is an autograd Function:

  * the occlusion prior's is a deliberate pseudo-gradient — (1-o2, 1-o1)
    where the analytic gradient of 1 - o1*o2 is (-o2, -o1)
    (criterions/OcclusionPriorCriterion.lua:59-66);
  * const_vel normalises the forward by the elements (B*H*W*2) but the
    backward by the pixels (B*H*W), and stabilises the EPE denominator
    with eps=1e-12 (criterions/ConstVelCriterion.lua:33,56-60).

Both are per pixel: on a row band (losses/common.py) they take the
band's rows and its `Band`, which only sets the whole level's size of
their `sizeAverage` normalisations.
"""

from __future__ import annotations

import torch

from .common import numel_of

_EPS = 1e-12


def _occ_prior_value(occ, size_average, penalty, band):
    c = occ.shape[-1]
    if c == 3:
        val = (1.0 - occ[..., 1]) * (occ[..., 0] + occ[..., 2]) * penalty * 0.05
    else:
        val = (1.0 - occ[..., 0] * occ[..., 1]) * penalty
    out = val.sum()
    return c / numel_of(occ, band) * out if size_average else out


class _OccPriorFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, occ, size_average, penalty, band):
        ctx.size_average, ctx.penalty, ctx.band = size_average, penalty, band
        ctx.save_for_backward(occ)
        return _occ_prior_value(occ, size_average, penalty, band)

    @staticmethod
    def backward(ctx, g):
        (occ,) = ctx.saved_tensors
        penalty = ctx.penalty
        c = occ.shape[-1]
        norm = (c / numel_of(occ, ctx.band)) if ctx.size_average else 1.0
        if c == 3:
            d = torch.stack([(1.0 - occ[..., 1]) * penalty * 0.05,
                             -(occ[..., 0] + occ[..., 2]) * penalty * 0.05,
                             (1.0 - occ[..., 1]) * penalty * 0.05], dim=-1)
        else:
            # pseudo-gradient: (1-o2, 1-o1) instead of (-o2, -o1)
            d = torch.stack([(1.0 - occ[..., 1]) * penalty,
                             (1.0 - occ[..., 0]) * penalty], dim=-1)
        return d * norm * g, None, None, None


def make_occ_prior(size_average: bool = True, penalty: float = 1.0,
                   reference_grads: bool = True):
    """fn(occ, target, band=None) -> scalar; the target is unused and gets
    no gradient."""

    def occ_prior(occ, target, band=None):
        if reference_grads:
            return _OccPriorFn.apply(occ, size_average, penalty, band)
        return _occ_prior_value(occ, size_average, penalty, band)

    return occ_prior


def _const_vel_value(flow_a, flow_b, size_average, band):
    diff = flow_a - flow_b
    out = torch.sqrt((diff * diff).sum(-1)).sum()
    return out / numel_of(flow_a, band) if size_average else out


class _ConstVelFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, flow_a, flow_b, size_average, band):
        ctx.size_average, ctx.band = size_average, band
        ctx.save_for_backward(flow_a, flow_b)
        return _const_vel_value(flow_a, flow_b, size_average, band)

    @staticmethod
    def backward(ctx, g):
        flow_a, flow_b = ctx.saved_tensors
        diff = flow_a - flow_b
        d = diff / (torch.sqrt((diff * diff).sum(-1, keepdim=True)) + _EPS)
        if ctx.size_average:
            # normalised by the pixels, not the elements (reference quirk,
            # ConstVelCriterion.lua:56,69-70)
            d = d / (numel_of(flow_a, ctx.band) / flow_a.shape[-1])
        return d * g, -d * g, None, None


def make_const_vel(size_average: bool = True, reference_grads: bool = True):
    """fn(flow_a, flow_b, band=None) -> scalar: the summed end-point error
    between the two flows (criterions/ConstVelCriterion.lua)."""

    def const_vel(flow_a, flow_b, band=None):
        if reference_grads:
            return _ConstVelFn.apply(flow_a, flow_b, size_average, band)
        return _const_vel_value(flow_a, flow_b, size_average, band)

    return const_vel
