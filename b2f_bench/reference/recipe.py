"""Plain PyTorch reference of the unsupervised hard recipe's loss (the
reference's train.lua:227-483 with `-optimize pme`): per output level,
finest first, weighted {0.005, 0.01, 0.02, 0.08, 0.32, 0.64, 1.28}
(train.lua:56-58, sizeAverage off):

  pme    OBCC, occlusion-aware brightness constancy (OBCCriterion.lua),
         with the criterion's own backward: a gradient to the occlusion
         (the out-of-image constant included) and to the warped frames,
         none to the flow or the target;
  sflow  first-order smoothness of the flow weighted by the target's
         edges, exp(-20 * mean_c |target difference|)
         (SmoothnessCriterion.lua);
  socc   the same of the occlusion, at `smooth_occ`;
  gocc   the occlusion prior sum(1 - o_past * o_future) at `prior_occ`,
         with its pseudo-gradient (1 - o_future, 1 - o_past)
         (OcclusionPriorCriterion.lua:59-66).

The target is the reference frame of the normalised input, 2x2-mean
pooled to each level. The criteria run in float32.
"""

from __future__ import annotations

from typing import List

import torch

from .common import avg_pool2

LEVEL_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32, 0.64, 1.28)
CONTRAST = 20.0


def _penalty(name: str):
    if name == "L1":
        return lambda x: torch.sqrt(x * x + 1e-6)
    if name == "Quadratic":
        return lambda x: x * x
    raise ValueError(f"penalty {name!r} is not in the reference")


def _check(opt: dict) -> None:
    want = dict(optimize="pme", pme_criterion="OBCC", sizeAverage=False, past_flow=False)
    bad = {k: opt.get(k) for k, v in want.items() if opt.get(k, v) != v}
    if bad:
        raise ValueError(f"the recipe reference does not cover these options: {bad}")


def _diff_h(x):
    """Forward difference along H, 0 in the last row."""
    return torch.cat([x[:, 1:] - x[:, :-1], torch.zeros_like(x[:, :1])], dim=1)


def _diff_w(x):
    """Forward difference along W, 0 in the last column."""
    return torch.cat([x[:, :, 1:] - x[:, :, :-1], torch.zeros_like(x[:, :, :1])], dim=2)


def smoothness(field: torch.Tensor, target: torch.Tensor, penalty: str) -> torch.Tensor:
    p = _penalty(penalty)
    with torch.no_grad():
        wy = torch.exp(-CONTRAST * _diff_h(target).abs().mean(-1, keepdim=True))
        wx = torch.exp(-CONTRAST * _diff_w(target).abs().mean(-1, keepdim=True))
    return (p(_diff_w(field)) * wx + p(_diff_h(field)) * wy).sum()


def _inside(flow: torch.Tensor, k: float, scale: float) -> torch.Tensor:
    """1 where the 1-indexed pixel moved by k * flow * scale stays in the
    image, else 0."""
    b, h, w, _ = flow.shape
    x = torch.arange(1, w + 1, dtype=flow.dtype, device=flow.device).view(1, 1, w)
    y = torch.arange(1, h + 1, dtype=flow.dtype, device=flow.device).view(1, h, 1)
    tx, ty = x + k * scale * flow[..., 0], y + k * scale * flow[..., 1]
    return ((tx >= 1) & (ty >= 1) & (tx <= w) & (ty <= h)).to(flow.dtype)


def _obcc_parts(flow, occ, warped, target, scale, penalty):
    """Per frame of the warped ones: (occlusion channel, photometric sum
    over channels, in-image mask). Frames before the reference weigh by
    occlusion channel 1, those after by channel 0 (OBCCriterion.lua:86-92)."""
    frames = len(warped) + 1
    ref = 0.5 * (frames - 1)
    p = _penalty(penalty)
    parts = []
    with torch.no_grad():
        for f in range(1, frames):
            k = (f - ref - 1) if f <= ref else (f - ref)
            parts.append((1 if f <= ref else 0, p(warped[f - 1] - target).sum(-1),
                          _inside(flow, k, scale)))
    return parts


class _OBCC(torch.autograd.Function):

    @staticmethod
    def forward(ctx, flow, occ, target, scale, penalty, *warped):
        inner = 1.0 / (target.shape[-1] * len(warped))
        acc = 0.0
        for ch, photo, m in _obcc_parts(flow, occ, warped, target, scale, penalty):
            acc = acc + photo * occ[..., ch] * m + (1.0 - m)
        ctx.save_for_backward(flow, occ, target, *warped)
        ctx.scale, ctx.penalty = scale, penalty
        return acc.sum() * inner

    @staticmethod
    def backward(ctx, g):
        flow, occ, target, *warped = ctx.saved_tensors
        inner = g / (target.shape[-1] * len(warped))
        d_occ = torch.zeros_like(occ)
        d_warped = []
        eps = 1e-6 if ctx.penalty == "L1" else None
        for f, (ch, photo, m) in enumerate(_obcc_parts(flow, occ, warped, target, ctx.scale,
                                                       ctx.penalty)):
            d_occ[..., ch] += (photo * m + (1.0 - m)) * inner
            diff = warped[f] - target
            der = diff / torch.sqrt(diff * diff + eps) if eps else 2.0 * diff
            d_warped.append(der * (m * occ[..., ch]).unsqueeze(-1) * inner)
        return (None, d_occ, None, None, None, *d_warped)


class _OccPrior(torch.autograd.Function):

    @staticmethod
    def forward(ctx, occ):
        ctx.save_for_backward(occ)
        return (1.0 - occ[..., 0] * occ[..., 1]).sum()

    @staticmethod
    def backward(ctx, g):
        (occ,) = ctx.saved_tensors
        return torch.stack([1.0 - occ[..., 1], 1.0 - occ[..., 0]], dim=-1) * g


def loss(outputs: List[dict], images: torch.Tensor, opt: dict) -> torch.Tensor:
    """The recipe's loss of the output groups (finest first) for the
    normalised frames `images` (B, H, W, 3F)."""
    _check(opt)
    frames = opt["frames"]
    rc = 3 * ((frames + 1) // 2 - 1)
    total = images.new_zeros(())
    down = images
    for l, g in enumerate(outputs):
        if l > 0:
            down = avg_pool2(down)
        w = LEVEL_WEIGHTS[l]
        target = down[..., rc:rc + 3]
        flow, occ = g["flow"].float(), g["occ"].float()
        total = total + w * opt["smooth_flow"] * smoothness(flow, target,
                                                            opt["smooth_flow_penalty"])
        total = total + w * opt["pme"] * _OBCC.apply(flow, occ, target, g["flow_scale"],
                                                    opt["pme_penalty"],
                                                    *[t.float() for t in g["warped"]])
        if opt["smooth_occ"] > 0:
            total = total + w * opt["smooth_occ"] * smoothness(occ, target,
                                                               opt["smooth_occ_penalty"])
        if opt["prior_occ"] > 0:
            total = total + w * opt["prior_occ"] * _OccPrior.apply(occ)
    return total
