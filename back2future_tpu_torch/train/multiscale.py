"""Multi-scale loss assembly over the model's level outputs (counterpart
of back2future_tpu/train/multiscale.py; the reference's feval wiring,
train.lua:227-483).

The loss is a scalar of the model outputs; gradients reach the model
through autograd and the criteria's reference-gradient Functions. Level
weights: finest -> coarsest {0.005, 0.01, 0.02, 0.08, 0.32, 0.64, 1.28}
(train.lua:56-58); all ones when sizeAverage (train.lua:60-64).

Ported for `optimize="pme"`, the unsupervised recipe. The supervised
branch (`optimize="epe"`) waits for the L2 criterion (ROADMAP.md queue 1
item 8) and raises.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..ops import avg_pool2

LEVEL_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32, 0.64, 1.28)
COMPONENTS = ("pme", "sflow", "socc", "gocc", "sup_flow", "sup_occ")


def level_weight(l: int, size_average: bool) -> float:
    return 1.0 if size_average else LEVEL_WEIGHTS[l]


def _ref_channels(frames: int) -> int:
    """First channel of the reference frame in the stacked input
    (train.lua:236-238)."""
    ref = 1 if frames == 2 else (frames + 1) // 2
    return (ref - 1) * 3


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else x


def multiscale_loss(outputs: List[Dict[str, Any]], batch: Dict[str, Any],
                    opt, crits) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, component dict). `batch["images"]`: (B,H,W,3F)
    normalised stacked frames. The criteria run in f32, whatever the
    model's compute dtype."""
    if opt.optimize != "pme":
        raise NotImplementedError(f"optimize={opt.optimize!r}: the supervised branch "
                                  f"is not ported yet (ROADMAP.md queue 1 item 8)")
    frames = opt.frames
    rc = _ref_channels(frames)
    outputs = [{k: ([_f32(t) for t in v] if k == "warped" else _f32(v))
                for k, v in g.items()} for g in outputs]
    down = batch["images"].float()
    comps = {k: torch.zeros((), device=down.device) for k in COMPONENTS}
    multi_occ = frames > 2 and not opt.no_occ

    for l, g in enumerate(outputs):
        if l > 0:
            down = avg_pool2(down)
        w = level_weight(l, opt.sizeAverage)
        target = down[..., rc:rc + 3]

        # flow smoothness on each predicted flow field (train.lua:427-433)
        flows = [g["flow"]] + ([g["flow_past"]] if (opt.past_flow and g["flow_past"] is not None)
                               else [])
        for fl in flows:
            comps["sflow"] = comps["sflow"] + w * opt.smooth_flow * crits.flow_smooth(fl, target)

        # constant velocity (train.lua:435-441)
        if opt.past_flow and g["flow_past"] is not None:
            comps["sflow"] = comps["sflow"] + \
                w * opt.const_vel * crits.const_vel(g["flow"], g["flow_past"])

        # photometric (train.lua:443-454)
        pme_fn = crits.pme(g["flow_scale"])
        comps["pme"] = comps["pme"] + w * opt.pme * pme_fn(
            g["flow"], g["flow_past"], g["occ"], tuple(g["warped"]), target)

        if multi_occ:
            if opt.smooth_occ > 0:
                comps["socc"] = comps["socc"] + \
                    w * opt.smooth_occ * crits.occ_smooth(g["occ"], target)
            if opt.prior_occ > 0:
                comps["gocc"] = comps["gocc"] + \
                    w * opt.prior_occ * crits.occ_prior(g["occ"], target)

    total = sum(comps.values())
    return total, comps
