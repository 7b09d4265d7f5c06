"""Occlusion prior (counterpart of back2future_tpu/losses/priors.py:23-65).

Its reference backward is a deliberate pseudo-gradient — (1-o2, 1-o1)
where the analytic gradient of 1 - o1*o2 is (-o2, -o1)
(criterions/OcclusionPriorCriterion.lua:59-66) — so under
`reference_grads=True` it is an autograd Function. The constant-velocity
criterion is not ported yet (ROADMAP.md queue 1 item 8).
"""

from __future__ import annotations

import torch


def _occ_prior_value(occ, size_average, penalty):
    c = occ.shape[-1]
    if c == 3:
        val = (1.0 - occ[..., 1]) * (occ[..., 0] + occ[..., 2]) * penalty * 0.05
    else:
        val = (1.0 - occ[..., 0] * occ[..., 1]) * penalty
    out = val.sum()
    return c / occ.numel() * out if size_average else out


class _OccPriorFn(torch.autograd.Function):

    @staticmethod
    def forward(ctx, occ, size_average, penalty):
        ctx.size_average, ctx.penalty = size_average, penalty
        ctx.save_for_backward(occ)
        return _occ_prior_value(occ, size_average, penalty)

    @staticmethod
    def backward(ctx, g):
        (occ,) = ctx.saved_tensors
        penalty = ctx.penalty
        c = occ.shape[-1]
        norm = (c / occ.numel()) if ctx.size_average else 1.0
        if c == 3:
            d = torch.stack([(1.0 - occ[..., 1]) * penalty * 0.05,
                             -(occ[..., 0] + occ[..., 2]) * penalty * 0.05,
                             (1.0 - occ[..., 1]) * penalty * 0.05], dim=-1)
        else:
            # pseudo-gradient: (1-o2, 1-o1) instead of (-o2, -o1)
            d = torch.stack([(1.0 - occ[..., 1]) * penalty,
                             (1.0 - occ[..., 0]) * penalty], dim=-1)
        return d * norm * g, None, None


def make_occ_prior(size_average: bool = True, penalty: float = 1.0,
                   reference_grads: bool = True):
    """fn(occ, target) -> scalar; the target is unused and gets no gradient."""

    def occ_prior(occ, target):
        if reference_grads:
            return _OccPriorFn.apply(occ, size_average, penalty)
        return _occ_prior_value(occ, size_average, penalty)

    return occ_prior
