"""Criterion library of the port (counterpart of back2future_tpu.losses).

Ported: the penalties, OBCC, first-order smoothness and the occlusion
prior — what the hard unsupervised recipe runs. `build_criterions` keeps
the reference's selection logic (model.lua:144-258); a criterion that is
not ported yet (OBGCC, BCC/MBCC, the SSIM family, KL occlusion
smoothness, second-order smoothness, const_vel, the supervised L2)
raises NotImplementedError naming ROADMAP.md queue 1 item 8.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable

from .penalty import L1Penalty, LorentzianPenalty, QuadraticPenalty, make_penalty
from .photometric import PhotoConfig, make_obcc
from .priors import make_occ_prior
from .smoothness import SmoothConfig, make_flow_smoothness, smoothness

_TODO = "is not ported yet (ROADMAP.md queue 1 item 8)"
# pme criteria of the JAX package that wait for a later slice
_UNPORTED_PME = ("BCC", "OBGCC", "SSIM", "SSIML1", "OSSIM", "OSSIML1")


@dataclasses.dataclass
class Criterions:
    """Configured criterion callables for a training run."""
    pme: Callable          # pme(scale) -> fn(flow, flow_past, occ, warped, target)
    flow_smooth: Callable  # fn(flow, target) -> scalar
    occ_smooth: Callable   # fn(occ, target) -> scalar
    occ_prior: Callable    # fn(occ, target) -> scalar
    const_vel: Callable    # fn(flow, flow_past) -> scalar
    l2: Callable           # fn(flow, gt_flow, mask) -> (loss, epe_map)


def _unported(name: str) -> Callable:
    def fn(*args, **kwargs):
        raise NotImplementedError(f"the {name} criterion {_TODO}")
    return fn


def build_criterions(opt) -> Criterions:
    """Mirror of the reference criterion setup (model.lua:144-258) for the
    ported criteria."""
    name = opt.pme_criterion
    if name in _UNPORTED_PME:
        raise NotImplementedError(f"pme_criterion {name!r} {_TODO}")
    if name != "OBCC":
        raise ValueError(f"unsupported pme_criterion {name!r}")

    # model.lua:189-193 only swaps the criterion's default penalty when
    # -pme_penalty names L1 or Lorentzian; any other value keeps Quadratic
    pme_penalty = opt.pme_penalty
    if pme_penalty not in ("L1", "Lorentzian"):
        pme_penalty = "Quadratic"
    if opt.dataset == "Kitti2015":
        # model.lua:196-198: L1Penalty(0.38) — ctor alpha is a no-op in the
        # reference, so effectively plain L1
        pme_penalty = "L1"

    photo_cfg = PhotoConfig(
        frames=opt.frames,
        penalty=pme_penalty,
        size_average=opt.sizeAverage,
        past_flow=opt.past_flow,
        alpha=opt.pme_alpha,
        beta=opt.pme_beta,
        # reference typo: opt.pme_gamma lands in an unused `gamm` field, so
        # gamma is effectively always 1.0 (model.lua:171) — replicated
        gamma=1.0,
        reference_grads=opt.reference_grads,
    )

    def pme(scale: float):
        return make_obcc(photo_cfg, float(scale))

    flow_smooth = make_flow_smoothness(SmoothConfig(
        penalty=opt.smooth_flow_penalty, size_average=opt.sizeAverage,
        second_order=opt.smooth_second_order, reference_grads=opt.reference_grads))

    if opt.smooth_occ_penalty == "KL":
        raise NotImplementedError(f"the KL occlusion smoothness {_TODO}")
    occ_smooth = functools.partial(smoothness, cfg=SmoothConfig(
        penalty=opt.smooth_occ_penalty, size_average=opt.sizeAverage,
        second_order=False, reference_grads=opt.reference_grads))

    return Criterions(
        pme=pme,
        flow_smooth=flow_smooth,
        occ_smooth=occ_smooth,
        occ_prior=make_occ_prior(opt.sizeAverage, 1.0, opt.reference_grads),
        const_vel=_unported("const_vel"),
        l2=_unported("supervised L2"),
    )


__all__ = [
    "QuadraticPenalty", "L1Penalty", "LorentzianPenalty", "make_penalty",
    "PhotoConfig", "make_obcc",
    "SmoothConfig", "smoothness", "make_flow_smoothness",
    "make_occ_prior",
    "Criterions", "build_criterions",
]
