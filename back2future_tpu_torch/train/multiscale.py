"""Multi-scale loss assembly over the model's level outputs (counterpart
of back2future_tpu/train/multiscale.py; the reference's feval wiring,
train.lua:227-483).

The loss is a scalar of the model outputs; gradients reach the model
through autograd and the criteria's reference-gradient Functions. Level
weights: finest -> coarsest {0.005, 0.01, 0.02, 0.08, 0.32, 0.64, 1.28}
(train.lua:56-58); all ones when sizeAverage (train.lua:60-64).

`optimize="pme"` is the unsupervised recipe (photometric, smoothness,
occlusion prior, const_vel); `optimize="epe"` the supervised one (L2 on
the flow and on the occlusion per level against subsampled ground
truth). The image warps feed only the photometric term, so the train and
eval steps skip them for "epe" (XLA drops them there as dead code).

Under data parallelism a rank's loss is its share of the global batch's
(parallel/distributed.py `loss_share`): the terms normalised by the
rank's own batch (`sizeAverage`) are scaled by 1/D over D data slots,
the supervised L2 divides by the global mask count, and batch sums need
nothing. With a spatial axis of S ranks the share is per level: at a
level the net computes in row bands (its group's "band", models/pwc.py),
each rank computes its band's part of every term, on its rows of the
targets, with that share; at a level whole on every rank of the spatial
group, which compute it alike, every term carries 1/S more. The shares
sum over ranks to the loss of the global batch, and so do their
gradients.

Known reference defects NOT replicated (documented intent implemented
instead, as in the JAX package): the supervised occlusion loss as written
would index a 1-channel tensor out of bounds and pass a tensor where
L2Criterion expects a {flow, mask} table (train.lua:285,319-331); this
applies the intended conversion (0/0.5/1 three-state -> per-channel {1,
0.5, 0} soft targets) and an all-ones mask.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..ops import avg_pool2, subsample2
from ..parallel.distributed import loss_share

LEVEL_WEIGHTS = (0.005, 0.01, 0.02, 0.08, 0.32, 0.64, 1.28)
COMPONENTS = ("pme", "sflow", "socc", "gocc", "sup_flow", "sup_occ")


def level_weight(l: int, size_average: bool) -> float:
    return 1.0 if size_average else LEVEL_WEIGHTS[l]


def _ref_channels(frames: int) -> int:
    """First channel of the reference frame in the stacked input
    (train.lua:236-238)."""
    ref = 1 if frames == 2 else (frames + 1) // 2
    return (ref - 1) * 3


def convert_gt_occ(occ_gt: torch.Tensor) -> torch.Tensor:
    """3-state gt (0 bwd / 0.5 vis / 1 fwd) -> 2-channel soft targets
    (intent of train.lua:319-326). occ_gt: (B,H,W,1) or (B,H,W)."""
    if occ_gt.dim() == 4:
        occ_gt = occ_gt[..., 0]
    half = 0.5 * (occ_gt == 0.5).float()
    return torch.stack([(occ_gt == 0.0).float() + half, (occ_gt == 1.0).float() + half], dim=-1)


def _f32(x):
    return x.float() if isinstance(x, torch.Tensor) else x


def multiscale_loss(outputs: List[Dict[str, Any]], batch: Dict[str, Any],
                    opt, crits) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (total_loss, component dict): this rank's shares under
    data parallelism (module docstring).

    batch keys: "images" (B,H,W,3F) normalised stacked frames; for
    "epe" also "flow_gt" (B,H,W,2) [already / flownet_factor], "occ_gt"
    (B,H,W,2) [channels: frames-occ, 3-frame-occ] and "mask" (B,H,W).
    The criteria run in f32, whatever the model's compute dtype."""
    def rows(t, band):
        """A level's targets, from the whole level, on the outputs' rows."""
        return t if band is None else band.rows(t)

    frames = opt.frames
    outputs = [{k: ([_f32(t) for t in v] if k == "warped" else _f32(v))
                for k, v in g.items()} for g in outputs]
    batch = {k: _f32(v) for k, v in batch.items()}
    comps = {k: torch.zeros((), device=batch["images"].device) for k in COMPONENTS}
    multi_occ = frames > 2 and not opt.no_occ

    if opt.optimize == "epe":
        flow_ds = batch["flow_gt"]
        mask_ds = batch["mask"][..., None] if batch["mask"].dim() == 3 else batch["mask"]
        occ_ds = batch["occ_gt"][..., :1]
        for l, g in enumerate(outputs):
            if l > 0:
                flow_ds = subsample2(flow_ds)
                mask_ds = subsample2(mask_ds)
                if opt.rescale_flow == 1:
                    flow_ds = flow_ds / 2.0
                if multi_occ:
                    occ_ds = subsample2(occ_ds)
            band = g.get("band")
            w = level_weight(l, opt.sizeAverage) * loss_share(False, band is not None)

            sup, _ = crits.l2(g["flow"], rows(flow_ds, band), rows(mask_ds, band)[..., 0],
                              band=band)
            comps["sup_flow"] = comps["sup_flow"] + opt.epe * w * sup

            if multi_occ:
                occ_target = convert_gt_occ(rows(occ_ds, band))
                ones = torch.ones(occ_target.shape[:3], dtype=occ_target.dtype,
                                  device=occ_target.device)
                # L2 over the 2-channel occ as a "flow" pair (intended
                # semantics of train.lua:328-331)
                sup_occ, _ = crits.l2(g["occ"], occ_target, ones, band=band)
                comps["sup_occ"] = comps["sup_occ"] + w * sup_occ

    if opt.optimize == "pme":
        rc = _ref_channels(frames)
        down = batch["images"]
        for l, g in enumerate(outputs):
            if l > 0:
                down = avg_pool2(down)
            band = g.get("band")
            w = level_weight(l, opt.sizeAverage) * loss_share(opt.sizeAverage, band is not None)
            target = rows(down, band)[..., rc:rc + 3]

            # flow smoothness on each predicted flow field (train.lua:427-433)
            flows = [g["flow"]] + ([g["flow_past"]]
                                   if (opt.past_flow and g["flow_past"] is not None) else [])
            for fl in flows:
                comps["sflow"] = comps["sflow"] + \
                    w * opt.smooth_flow * crits.flow_smooth(fl, target, band=band)

            # constant velocity (train.lua:435-441)
            if opt.past_flow and g["flow_past"] is not None:
                comps["sflow"] = comps["sflow"] + \
                    w * opt.const_vel * crits.const_vel(g["flow"], g["flow_past"], band=band)

            # photometric (train.lua:443-454)
            pme_fn = crits.pme(g["flow_scale"])
            comps["pme"] = comps["pme"] + w * opt.pme * pme_fn(
                g["flow"], g["flow_past"], g["occ"], tuple(g["warped"]), target, band=band)

            if multi_occ:
                if opt.smooth_occ > 0:
                    comps["socc"] = comps["socc"] + \
                        w * opt.smooth_occ * crits.occ_smooth(g["occ"], target, band=band)
                if opt.prior_occ > 0:
                    comps["gocc"] = comps["gocc"] + \
                        w * opt.prior_occ * crits.occ_prior(g["occ"], target, band=band)

    total = sum(comps.values())
    return total, comps
