"""Criterion library of the port (counterpart of back2future_tpu.losses):
the penalties, the photometric criteria (OBCC, OBGCC, MBCC, the SSIM
family, the 2-frame BCC and SSIM), first- and second-order and KL
smoothness, the occlusion prior, const_vel and the supervised L2, and
the factory that mirrors the reference's selection logic
(model.lua:144-258). Every criterion takes a keyword `band`: the
parallel.spatial `Band` of a row band's tensors, None for whole ones
(losses/common.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .penalty import L1Penalty, LorentzianPenalty, QuadraticPenalty, make_penalty
from .photometric import (PhotoConfig, bcc, make_mbcc, make_mssim_l1, make_obcc, make_obgcc,
                          make_ossim_l1, ssim)
from .priors import make_const_vel, make_occ_prior
from .smoothness import (SmoothConfig, make_flow_smoothness, make_kl_smoothness,
                         second_order_smoothness, smoothness)
from .supervised import epe_map, make_l2_criterion

_PME_FACTORIES = {
    "BCC": make_mbcc,        # model.lua:149-151 maps 'BCC' to MBCCriterion
    "OBCC": make_obcc,
    "OBGCC": make_obgcc,
    "SSIM": make_mssim_l1,   # alpha=1
    "SSIML1": make_mssim_l1,  # alpha=0.85
    "OSSIM": make_ossim_l1,  # alpha=1
    "OSSIML1": make_ossim_l1,  # alpha=0.85
}


@dataclasses.dataclass
class Criterions:
    """Configured criterion callables for a training run; each also takes
    `band=` (module docstring)."""
    pme: Callable          # pme(scale) -> fn(flow, flow_past, occ, warped, target)
    flow_smooth: Callable  # fn(flow, target) -> scalar
    occ_smooth: Callable   # fn(occ, target) -> scalar
    occ_prior: Callable    # fn(occ, target) -> scalar
    const_vel: Callable    # fn(flow, flow_past) -> scalar
    l2: Callable           # fn(flow, gt_flow, mask) -> (loss, epe_map)


def build_criterions(opt) -> Criterions:
    """Mirror of the reference criterion setup (model.lua:144-258)."""
    name = opt.pme_criterion
    if name not in _PME_FACTORIES:
        raise ValueError(f"unsupported pme_criterion {name!r}")

    # model.lua:189-193 only swaps the criterion's default penalty when
    # -pme_penalty names L1 or Lorentzian; any other value keeps the default
    # (Quadratic for the *BCC family, L1 for the SSIM family — the SSIM
    # side is resolved inside _make_ssim).
    pme_penalty = opt.pme_penalty
    if pme_penalty not in ("L1", "Lorentzian"):
        pme_penalty = "Quadratic"
    if opt.dataset == "Kitti2015":
        # model.lua:196-198: L1Penalty(0.38) — ctor alpha is a no-op in the
        # reference, so effectively plain L1
        pme_penalty = "L1"

    ssim_alpha = {"SSIM": 1.0, "OSSIM": 1.0, "SSIML1": 0.85, "OSSIML1": 0.85}
    photo_cfg = PhotoConfig(
        frames=opt.frames,
        penalty=pme_penalty,
        size_average=opt.sizeAverage,
        past_flow=opt.past_flow,
        alpha=ssim_alpha.get(name, opt.pme_alpha),
        beta=opt.pme_beta,
        # reference typo: opt.pme_gamma lands in an unused `gamm` field, so
        # gamma is effectively always 1.0 (model.lua:171) — replicated
        gamma=1.0,
        reference_grads=opt.reference_grads,
    )
    pme_factory = _PME_FACTORIES[name]

    def pme(scale: float):
        return pme_factory(photo_cfg, float(scale))

    flow_smooth = make_flow_smoothness(SmoothConfig(
        penalty=opt.smooth_flow_penalty, size_average=opt.sizeAverage,
        second_order=opt.smooth_second_order, reference_grads=opt.reference_grads))

    if opt.smooth_occ_penalty == "KL":
        occ_smooth = make_kl_smoothness(opt.sizeAverage, opt.reference_grads)
    else:
        os_cfg = SmoothConfig(penalty=opt.smooth_occ_penalty, size_average=opt.sizeAverage,
                              second_order=False, reference_grads=opt.reference_grads)

        def occ_smooth(occ, target, band=None, _cfg=os_cfg):
            return smoothness(occ, target, _cfg, band)

    return Criterions(
        pme=pme,
        flow_smooth=flow_smooth,
        occ_smooth=occ_smooth,
        occ_prior=make_occ_prior(opt.sizeAverage, 1.0, opt.reference_grads),
        const_vel=make_const_vel(opt.sizeAverage, opt.reference_grads),
        l2=make_l2_criterion(opt.sizeAverage, opt.reference_grads),
    )


__all__ = [
    "QuadraticPenalty", "L1Penalty", "LorentzianPenalty", "make_penalty",
    "PhotoConfig", "make_obcc", "make_obgcc", "make_mbcc",
    "make_mssim_l1", "make_ossim_l1", "bcc", "ssim",
    "SmoothConfig", "smoothness", "second_order_smoothness",
    "make_flow_smoothness", "make_kl_smoothness",
    "make_occ_prior", "make_const_vel",
    "make_l2_criterion", "epe_map",
    "Criterions", "build_criterions",
]
