"""Supervised endpoint-error criterion (counterpart of
back2future_tpu/losses/supervised.py; criterions/L2Criterion.lua).

Masked average EPE; also returns the per-pixel EPE map for the occluded /
non-occluded metric breakdown (train.lua:337-375). Under
`reference_grads=True` the backward replicates the reference's
eps-stabilised denominator. With `size_average` the normaliser is the
mask's sum over the global batch: under data parallelism the ranks'
counts are all-reduced (parallel/distributed.py; it has no gradient), in
the value and in the reference backward alike: over the world on a row
band (given its `Band`), whose rows the spatial group's ranks share out,
else over the data group.
"""

from __future__ import annotations

import functools

import torch

from ..parallel.distributed import all_reduce_data, all_reduce_sum

_EPS = 1e-12


def epe_map(flow: torch.Tensor, target_flow: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-pixel masked endpoint error (B,H,W)."""
    diff = flow - target_flow
    return torch.sqrt(torch.sum(diff * diff, dim=-1)) * mask


def _mask_count(mask: torch.Tensor, band) -> torch.Tensor:
    """The mask's sum over the global batch (module docstring)."""
    return (all_reduce_data if band is None else all_reduce_sum)(mask.sum())


def _l2_value(flow, target_flow, mask, size_average, band):
    mask = mask.reshape(mask.shape[:3])
    m = epe_map(flow, target_flow, mask)
    out = m.sum()
    if size_average:
        out = out / _mask_count(mask, band)
    return out, m


class _L2Fn(torch.autograd.Function):
    """L2 with the reference backward (supervised.py:47-58): to the flow
    only; the gradient through the EPE map is dropped."""

    @staticmethod
    def forward(ctx, flow, target_flow, mask, size_average, band):
        ctx.size_average, ctx.band = size_average, band
        ctx.save_for_backward(flow, target_flow, mask)
        out, m = _l2_value(flow, target_flow, mask, size_average, band)
        ctx.mark_non_differentiable(m)
        return out, m

    @staticmethod
    def backward(ctx, g, _g_map):
        flow, target_flow, mask = ctx.saved_tensors
        mask3 = mask.reshape(mask.shape[:3])
        diff = flow - target_flow
        denom = torch.sqrt((diff * diff).sum(-1) * mask3) + _EPS
        d = diff / denom[..., None] * mask3[..., None]
        if ctx.size_average:
            d = d / _mask_count(mask3, ctx.band)
        return d * g, None, None, None, None


@functools.lru_cache(maxsize=None)
def make_l2_criterion(size_average: bool = True, reference_grads: bool = True):
    """Returns fn(flow, target_flow, mask, band=None) -> (loss, epe_map).

    mask is (B,H,W) (or (B,H,W,1)); npixels = mask.sum().
    """

    def l2(flow, target_flow, mask, band=None):
        if reference_grads:
            return _L2Fn.apply(flow, target_flow, mask, size_average, band)
        return _l2_value(flow, target_flow, mask, size_average, band)

    return l2
