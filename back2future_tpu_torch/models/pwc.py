"""Multi-frame PWC network (torch nn.Module, NHWC).

Counterpart of back2future_tpu/models/pwc.py, itself a rebuild of the
reference graph (models/pwc.lua:87-508): a shared-weight conv feature
pyramid per frame, and per pyramid level (coarsest -> finest computed
level) forward/backward multi-frame cost volumes, an occlusion decoder
with channel softmax, flow decoder(s), bilinear warping of features (for
the next level) and of the image pyramids (for the photometric losses).

Output: list of per-level dicts, FINEST first (models/pwc.lua:458-489):
  {"flow": (B,h,w,2), "flow_past": (B,h,w,2)|None, "occ": (B,h,w,2)|None,
   "warped": [(B,h,w,3) for each non-reference frame, frame order],
   "flow_scale": float}

`forward(x, with_warped=False)` skips the image warps and returns
"warped": [] — what the compiled JAX serving program computes, since XLA
drops those warps as dead code when only flow and occlusion are read.

Image rows sharded over a spatial group (parallel/spatial.py): with
`net.spatial_comm` set (its spatial group's communicator), every slot of
the group takes the whole input and computes the sharded levels of the
`level_plan` on its row band (`RowLayout`): the convs and cost volumes
exchange halos, the 2x upsamples read the whole level's taps, and each
feature warp gathers its source image and warps its band by the row
window (`warp_bilinear(..., y0=)`). The levels past the plan's cut and
the fused stem (a replicated region whose outputs are split into bands)
run whole on every slot. The outputs come whole, each sharded level's
gathered; with `bands=True` (the train and eval steps, whose loss works
on bands) a sharded level's outputs stay its band, its group holding
the band's `Band` under "band" (None for a whole level), and its image
warps warp the whole image pyramid by the band's flow through the row
window, with no gather (the input frames take no gradient).

The forward and `from_pyramids` run as spans (utils.timing.span, a
profiler range only while a profiler runs): `model.pyramid` (the cast,
the frame stacking and the feature pyramid, the fused stem included),
then `model.decode` (`_decode`), inside which each coarse-to-fine level
l is `model.level{l}`, l the `RowLayout`'s numbering (1 = full
resolution), as SPyNet names its levels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn

from ..ops import (
    avg_pool2, cost_volume_multi, spatial_softmax, upsample_bilinear2x,
    upsample_nearest2x, warp_bilinear,
)
from ..ops.pyramid import upsample_bilinear2x_rows
from ..ops.stem import fused_stem, stem_eligible, stem_enabled
from ..parallel.spatial import Band, Comm, gather_rows, halo_rows, level_plan, shard_rows
from ..utils.timing import span
from .layers import ConvUnit, Decoder

# d = 16 (models/pwc.lua:29); feature dims per level (models/pwc.lua:89)
_D = 16
_FEAT_MAPS = (3, _D, _D * 2, _D * 4, _D * 6, _D * 8, _D * 12)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class PWCConfig:
    frames: int = 3
    levels: int = 7
    win: int = 9              # -pwc_ws
    skip: int = 2             # -pwc_skip
    siamese: int = 1          # -pwc_siamese
    two_frame: int = 0
    flownet_factor: float = 20.0
    rescale_flow: int = 0
    residual: int = 0         # -residual
    occ_input: int = 0
    sum_cvs: bool = False     # -pwc_sum_cvs
    past_flow: bool = False
    dtype: torch.dtype = torch.float32
    reference_grads: bool = True

    @property
    def ref(self) -> int:
        """1-indexed reference frame (models/pwc.lua:130-133)."""
        return 1 if self.frames == 2 else (self.frames + 1) // 2

    @property
    def l_st(self) -> int:
        """Finest computed level (models/pwc.lua:136)."""
        return max(self.skip + 1, 1)

    @property
    def feat_maps(self) -> tuple:
        fm = list(_FEAT_MAPS)
        while len(fm) < self.levels:
            fm.append(fm[-1])
        if self.skip == 0:
            fm[0] = fm[1]
        if self.siamese == 0:
            fm = [3] * max(self.levels + 1, len(fm))
        return tuple(fm)

    @property
    def flow_scales(self) -> tuple:
        """flow_scale per output level, FINEST first."""
        out = []
        for l in range(self.l_st, self.levels + 1):
            if self.rescale_flow == 1:
                out.append(self.flownet_factor)
            else:
                out.append(self.flownet_factor / (2.0 ** (l - self.l_st)))
        return tuple(out)

    @property
    def num_output_levels(self) -> int:
        return self.levels - self.l_st + 1


class RowLayout:
    """Where a forward's tensors live, by pyramid level (level l has
    H / 2**(l-1) rows): the band of this slot at a sharded level of the
    plan, the whole level otherwise. Without a row shard every level is
    whole and each method is the plain op."""

    def __init__(self, comm: Optional[Comm], height: int, levels: int, halo: int):
        self.comm_ = None if comm is None or comm.size == 1 else comm
        self.height = height
        self.plan = (level_plan(height, self.comm_.size, levels, halo) if self.comm_
                     else (False,) * levels)

    def sharded(self, l: int) -> bool:
        return self.plan[l - 1]

    def comm(self, l: int) -> Optional[Comm]:
        """The communicator of a band at level l, None for a whole level."""
        return self.comm_ if self.sharded(l) else None

    def band(self, t: torch.Tensor, l: int) -> torch.Tensor:
        """Level l's tensor from the whole one."""
        return shard_rows(t, self.comm_) if self.sharded(l) else t

    def whole(self, t: torch.Tensor, l: int) -> torch.Tensor:
        """The whole level l from level l's tensor."""
        return gather_rows(t, self.comm_) if self.sharded(l) else t

    def input(self, t: torch.Tensor, l: int) -> torch.Tensor:
        """Level l-1's tensor as the input of level l's stage (a band
        stays a band; a whole stage takes the whole level)."""
        return t if self.sharded(l) else self.whole(t, l - 1)

    def _y0(self, l: int) -> int:
        return self.comm_.index * (self.height >> (l - 1)) // self.comm_.size

    def band_of(self, l: int) -> Optional[Band]:
        """Level l's `Band` on this slot, None for a whole level."""
        return Band(self.comm_, self._y0(l), self.height >> (l - 1)) if self.sharded(l) else None

    def up_bilinear(self, t: torch.Tensor, l: int) -> torch.Tensor:
        """Level l's tensor upsampled 2x to level l-1."""
        if not self.sharded(l - 1):
            return upsample_bilinear2x(t)
        in_h = self.height >> (l - 1)
        out_h = 2 * in_h // self.comm_.size
        if self.sharded(l):   # the band's rows and one of each neighbour's
            return upsample_bilinear2x_rows(halo_rows(t, 1, self.comm_), in_h,
                                            self._y0(l) - 1, self._y0(l - 1), out_h)
        return upsample_bilinear2x_rows(t, in_h, 0, self._y0(l - 1), out_h)

    def up_nearest(self, t: torch.Tensor, l: int) -> torch.Tensor:
        """Level l's tensor upsampled 2x (nearest) to level l-1."""
        up = upsample_nearest2x(t)
        return up if self.sharded(l) else self.band(up, l - 1)

    def warp(self, images: torch.Tensor, flow: torch.Tensor, l: int,
             reference_grads: bool) -> torch.Tensor:
        """Level l's images warped by level l's flow: on a band, the
        whole images gathered and the band's rows warped by the row
        window."""
        if not self.sharded(l):
            return warp_bilinear(images, flow, reference_grads=reference_grads)
        return warp_bilinear(gather_rows(images, self.comm_), flow,
                             reference_grads=reference_grads, y0=self._y0(l))

    def warp_whole(self, images: torch.Tensor, flow: torch.Tensor, l: int,
                   reference_grads: bool) -> torch.Tensor:
        """Whole images of level l warped by level l's flow: on a band,
        the band's rows by the row window."""
        return warp_bilinear(images, flow, reference_grads=reference_grads,
                             y0=self._y0(l) if self.sharded(l) else 0)


def pwc_config_from_options(opt) -> PWCConfig:
    """Build from an `Options` (config.py; models/pwc.lua:103-117)."""
    return PWCConfig(
        frames=opt.frames, levels=opt.levels, win=opt.pwc_ws,
        skip=opt.pwc_skip, siamese=opt.pwc_siamese, two_frame=opt.two_frame,
        flownet_factor=opt.flownet_factor, rescale_flow=opt.rescale_flow,
        residual=opt.residual, occ_input=opt.occ_input,
        sum_cvs=opt.pwc_sum_cvs, past_flow=opt.past_flow,
        dtype=DTYPES[opt.compute_dtype],
        reference_grads=opt.reference_grads,
    )


class PWCNet(nn.Module):
    """The multi-frame PWC network. Submodule names are the flax module
    names (`feat_{l}`, `{flow,occ,past}_decoder_{l}`), so the params
    bridge maps one tree onto the other by name."""

    spatial_comm: Optional[Comm] = None   # the spatial group's, on a row-sharded slot

    def __init__(self, cfg: PWCConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        fm = cfg.feat_maps
        nd = cfg.win * cfg.win
        multi = cfg.frames > 2 and cfg.two_frame == 0
        nd_flow = nd if (cfg.sum_cvs or not multi) else nd * 2
        nd_occ = nd * 2 if multi else nd

        # Shared-weight (siamese) feature pyramid: one ConvUnit per level,
        # applied to every frame (models/pwc.lua:187-195). Level l has
        # fm[l-1] channels.
        if cfg.siamese == 1:
            if cfg.skip == 0:
                self.feat_1 = ConvUnit(3, fm[0], stride=1, generator=generator)
            for l in range(2, cfg.levels + 1):
                self.add_module(f"feat_{l}", ConvUnit(fm[l - 2], fm[l - 1], stride=2,
                                                      generator=generator))

        # decoders, created in the flax module's order
        for l in range(cfg.l_st, cfg.levels + 1):
            c_l = fm[l - 1]
            up = 0 if l == cfg.levels else c_l + 2   # + ref features + upsampled flow
            self.add_module(f"flow_decoder_{l}", Decoder(nd_flow + up, generator=generator))
            if cfg.past_flow:
                self.add_module(f"past_decoder_{l}",
                                Decoder(nd_flow + up, generator=generator))
            if cfg.frames > 2:
                occ_in = nd_occ + c_l
                if cfg.two_frame == 1:
                    occ_in += c_l
                if l != cfg.levels:
                    occ_in += 2 + (2 if cfg.occ_input == 1 else 0)
                self.add_module(f"occ_decoder_{l}", Decoder(occ_in, generator=generator))

    def _features(self, img: torch.Tensor, rows: RowLayout) -> Dict[int, torch.Tensor]:
        """Apply pyramid stages 2..levels (and stage 1 when skip==0);
        stages 2 and 3 through the fused stem when `_stem_fusable`. `img`
        is whole; each level comes out as `rows` places it."""
        cfg = self.cfg
        cs = {1: rows.band(img, 1)}
        start = 2
        if cfg.siamese == 1:
            if cfg.skip == 0:
                cs[1] = self.feat_1(cs[1], rows.comm(1))
            elif self._stem_fusable(img):
                c2, c3 = fused_stem(img, self.feat_2, self.feat_3)
                cs[2], cs[3] = rows.band(c2, 2), rows.band(c3, 3)
                start = 4
            for l in range(start, cfg.levels + 1):
                cs[l] = getattr(self, f"feat_{l}")(rows.input(cs[l - 1], l), rows.comm(l))
        else:
            for l in range(2, cfg.levels + 1):
                cs[l] = avg_pool2(rows.input(cs[l - 1], l))
        return cs

    def _rows(self, height: int) -> RowLayout:
        """The row layout of a forward at `height` rows: the plan's halo
        is the cost volume's reach at the widest frame distance."""
        cfg = self.cfg
        f_i, l_i = self._frame_range()
        reach = (cfg.win // 2) * max(l_i - cfg.ref, cfg.ref - f_i, 1)
        return RowLayout(self.spatial_comm, height, cfg.levels, max(reach, 1))

    def _stem_fusable(self, x: torch.Tensor) -> bool:
        """Whether levels 2 and 3 run through the fused stem (ops/stem.py),
        as in the JAX net (back2future_tpu/models/pwc.py:190-202): default
        feature dims, raw 3-channel input (skip != 0, so no feat_1 stage),
        `stem_eligible` shapes, and `B2F_STEM_PALLAS` on (off by default).
        The stem reads `feat_2`'s and `feat_3`'s own parameters."""
        cfg = self.cfg
        fm = cfg.feat_maps
        return (cfg.skip != 0 and cfg.levels >= 3 and x.shape[-1] == 3
                and stem_eligible(x.shape[1], x.shape[2], 3, fm[1], fm[2])
                and stem_enabled())

    def _frame_range(self):
        """Frames with features/cost volumes (models/pwc.lua:161-166)."""
        cfg = self.cfg
        return (cfg.ref, cfg.ref + 1) if cfg.two_frame == 1 else (1, cfg.frames)

    def forward(self, x: torch.Tensor, with_warped: bool = True, bands: bool = False
                ) -> List[Dict[str, Any]]:
        """x: (B, H, W, 3*frames) frame stack, H and W divisible by
        2**(levels-1). `bands`: module docstring."""
        cfg = self.cfg
        if x.shape[-1] != 3 * cfg.frames:
            raise ValueError(f"expected {3 * cfg.frames} input channels, "
                             f"got {x.shape[-1]}")
        with span("model.pyramid"):
            x = x.to(cfg.dtype)
            f_i, l_i = self._frame_range()
            # the weights are shared across frames, so ONE conv chain runs
            # over the frame-stacked batch and is split afterwards
            f_range = list(range(f_i, l_i + 1))
            stacked = torch.cat([x[..., 3 * (f - 1):3 * f] for f in f_range], dim=0)
            rows = self._rows(x.shape[1])
            css = self._features(stacked, rows)
            n = x.shape[0]
            cs = {f: {l: feat[k * n:(k + 1) * n] for l, feat in css.items()}
                  for k, f in enumerate(f_range)}
        with span("model.decode"):
            return self._decode(x, cs, with_warped, rows, bands)

    def pyramid(self, frame: torch.Tensor) -> Dict[int, torch.Tensor]:
        """Siamese feature pyramid of ONE frame: (B, H, W, 3) -> {level:
        (B, H/2^(l-1), W/2^(l-1), C_l)}. In a sliding window every frame's
        pyramid is the same in all windows it appears in, so video
        inference computes it once per frame (api.compute_flow_video)."""
        if frame.shape[-1] != 3:
            raise ValueError(f"pyramid() takes one (B, H, W, 3) frame, got "
                             f"channels={frame.shape[-1]}")
        return self._features(frame.to(self.cfg.dtype), self._rows(frame.shape[1]))

    def from_pyramids(self, x: torch.Tensor,
                      cs: Dict[int, Dict[int, torch.Tensor]],
                      with_warped: bool = True) -> List[Dict[str, Any]]:
        """Forward from precomputed per-frame pyramids `cs[f][l]`; `x` is
        the (B, H, W, 3F) frame stack. Same outputs as `forward`."""
        cfg = self.cfg
        if x.shape[-1] != 3 * cfg.frames:
            raise ValueError(f"expected {3 * cfg.frames} input channels, "
                             f"got {x.shape[-1]}")
        f_i, l_i = self._frame_range()
        missing = [f for f in range(f_i, l_i + 1) if f not in cs]
        if missing:
            raise ValueError(f"from_pyramids: missing pyramids for frames "
                             f"{missing} (need {f_i}..{l_i})")
        with span("model.pyramid"):
            x = x.to(cfg.dtype)
            cs = {f: {l: feat.to(cfg.dtype) for l, feat in d.items()}
                  for f, d in cs.items()}
        with span("model.decode"):
            return self._decode(x, cs, with_warped, self._rows(x.shape[1]), False)

    def _decode(self, x: torch.Tensor, cs: Dict[int, Dict[int, torch.Tensor]],
                with_warped: bool, rows: RowLayout, bands: bool) -> List[Dict[str, Any]]:
        """Coarse-to-fine decode from per-frame feature pyramids (placed
        by `rows`): cost volumes, occ/flow decoders, feature warps and
        (with_warped) the image warps, then the output groups, whole or
        (`bands`) as `rows` places them."""
        cfg = self.cfg
        F, ref, l_st, levels = cfg.frames, cfg.ref, cfg.l_st, cfg.levels
        factor = cfg.flownet_factor
        f_i, l_i = self._frame_range()
        multi = F > 2 and cfg.two_frame == 0

        # image pyramids of non-ref frames for the photometric warps
        # (ds[f][j] = image downsampled j times; models/pwc.lua:147-158)
        ds = {}
        if with_warped:
            for f in range(1, F + 1):
                if f != ref:
                    chain = [x[..., 3 * (f - 1):3 * f].contiguous()]
                    for _ in range(levels - l_st):
                        chain.append(avg_pool2(chain[-1]))
                    ds[f] = chain

        ws: Dict[int, Dict[int, torch.Tensor]] = {f: {} for f in range(1, F + 1)}
        ufs, ubfs, uoccs, fs, bfs, occs = {}, {}, {}, {}, {}, {}
        skip_ufs, skip_ubfs, skip_occs = {}, {}, {}
        iws: Dict[int, Dict[int, torch.Tensor]] = {f: {} for f in range(1, F + 1)}
        outs: Dict[int, Dict[str, Any]] = {}   # each level's outputs
        place = (lambda t, res: t) if bands else rows.whole

        for l in range(levels, l_st - 1, -1):
            with span(f"model.level{l}"):
                comm = rows.comm(l)
                # cost-volume inputs: raw features at the coarsest level, warped
                # features below (models/pwc.lua:238-244)
                inp = cs if l == levels else ws
                future = [inp[f][l] for f in range(ref + 1, l_i + 1)]
                cv_fwd = cost_volume_multi(cs[ref][l], future, cfg.win, fwd=True, comm=comm)
                if multi:
                    past = [inp[f][l] for f in range(ref - 1, 0, -1)]
                    cv_bwd = cost_volume_multi(cs[ref][l], past, cfg.win, fwd=False, comm=comm)
                    cvs_occ = torch.cat([cv_fwd, cv_bwd], dim=-1)
                    cvs_flow = cv_fwd + cv_bwd if cfg.sum_cvs else cvs_occ
                else:
                    cvs_flow = cvs_occ = cv_fwd

                # occlusion decoder (models/pwc.lua:286-321)
                if F > 2:
                    occ_in = [cvs_occ, cs[ref][l]]
                    if cfg.two_frame == 1:
                        occ_in.append(cs[ref + 1][l])
                    if l != levels:
                        occ_in.append(ufs[l + 1])
                        if cfg.occ_input == 1:
                            occ_in.append(uoccs[l + 1])
                    occs[l] = spatial_softmax(
                        getattr(self, f"occ_decoder_{l}")(torch.cat(occ_in, dim=-1), comm))
                    if cfg.skip > 0 or cfg.occ_input == 1:
                        uoccs[l] = rows.up_nearest(occs[l], l)
                    if cfg.skip > 0:
                        so = uoccs[l]
                        for k in range(2, l_st):
                            so = rows.up_nearest(so, l + 1 - k)
                        skip_occs[l] = so

                # flow decoder(s) (models/pwc.lua:324-352)
                flow_dec = getattr(self, f"flow_decoder_{l}")
                past_dec = getattr(self, f"past_decoder_{l}") if cfg.past_flow else None
                if l == levels:
                    fs[l] = flow_dec(cvs_flow, comm)
                    if cfg.past_flow:
                        bfs[l] = past_dec(cvs_flow, comm)
                else:
                    d = flow_dec(torch.cat([cvs_flow, cs[ref][l], ufs[l + 1]], dim=-1), comm)
                    fs[l] = d + ufs[l + 1] if cfg.residual == 1 else d
                    if cfg.past_flow:
                        db = past_dec(torch.cat([cvs_flow, cs[ref][l], ubfs[l + 1]], dim=-1), comm)
                        bfs[l] = db + ubfs[l + 1] if cfg.residual == 1 else db

                # upsample flow chains (models/pwc.lua:354-390)
                if cfg.skip > 0 or l > l_st:
                    ufs[l] = rows.up_bilinear(fs[l], l)
                    if cfg.past_flow:
                        ubfs[l] = rows.up_bilinear(bfs[l], l)
                    if cfg.rescale_flow == 1:
                        ufs[l] = ufs[l] * 2.0
                        if cfg.past_flow:
                            ubfs[l] = ubfs[l] * 2.0
                    if cfg.skip > 0:
                        su = ufs[l]
                        sub = ubfs[l] if cfg.past_flow else None
                        for k in range(2, l_st):
                            su = rows.up_bilinear(su, l + 1 - k)
                            if cfg.rescale_flow == 1:
                                su = su * 2.0
                            if sub is not None:
                                sub = rows.up_bilinear(sub, l + 1 - k)
                                if cfg.rescale_flow == 1:
                                    sub = sub * 2.0
                        skip_ufs[l] = su
                        if cfg.past_flow:
                            skip_ubfs[l] = sub

                # this level's outputs at resolution level l - l_st + 1
                # (models/pwc.lua:458-489)
                res = l - l_st + 1
                if cfg.skip == 0:
                    flow, flow_past = fs[l], (bfs[l] if cfg.past_flow else None)
                else:
                    flow, flow_past = skip_ufs[l], (skip_ubfs[l] if cfg.past_flow else None)
                occ = (skip_occs[l] if cfg.skip > 0 else occs[l]) if F > 2 else None
                outs[l] = {"flow": place(flow, res),
                           "flow_past": None if flow_past is None else place(flow_past, res),
                           "occ": None if occ is None else place(occ, res)}
                if bands:
                    outs[l]["band"] = rows.band_of(res)

                # warps (models/pwc.lua:392-448)
                for f in range(1, F + 1):
                    if f == ref:
                        continue
                    # feature warp for the next (finer) level's cost volumes
                    if l > l_st and f_i <= f <= l_i:
                        if cfg.rescale_flow == 1:
                            m = factor * (f - ref)
                        else:
                            m = factor * (f - ref) / (2.0 ** (l - 2))
                        ws[f][l - 1] = rows.warp(cs[f][l - 1], ufs[l] * m, l - 1,
                                                 cfg.reference_grads)

                    if not with_warped:
                        continue
                    # image warp at this level's output resolution: the whole
                    # image pyramid by the outputs' rows
                    base = outs[l]["flow_past" if (cfg.past_flow and f < ref) else "flow"]
                    # the past multiplier stays negative even with a separate
                    # past decoder, so hard-model weights transfer
                    # (models/pwc.lua:438-444)
                    if cfg.rescale_flow == 1:
                        m = factor * (f - ref)
                    else:
                        m = factor * (f - ref) / (2.0 ** (l - l_st))
                    src = ds[f][l - l_st]
                    iws[f][l] = (rows.warp_whole(src, base * m, res, cfg.reference_grads) if bands
                                 else warp_bilinear(src, base * m,
                                                    reference_grads=cfg.reference_grads))

        # output groups, FINEST first (models/pwc.lua:458-489)
        return [{**outs[l],
                 "warped": ([iws[f][l] for f in range(1, F + 1) if f != ref]
                            if with_warped else []),
                 "flow_scale": cfg.flow_scales[idx]}
                for idx, l in enumerate(range(l_st, levels + 1))]
