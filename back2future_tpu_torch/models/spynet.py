"""SPyNet variant (torch nn.Module, NHWC).

Counterpart of back2future_tpu/models/spynet.py, itself a rebuild of the
reference spatial-pyramid network (models/spynet.lua:17-173): an input
image pyramid; per level a 5-conv 7x7 stack (32-64-32-16 -> 2-ch flow,
plus a 2-ch softmax occlusion head when frames > 2); non-reference frames
warped by the upsampled coarser flow before entering the level; optional
flow/occ input channels and residual flow.

Faithfully replicated quirk: with residual=1 the reference adds the
upsampled flow twice to the *output* flow (once inside volcon_level,
models/spynet.lua:33-35, and again at models/spynet.lua:144-147) while the
level's internal warps use the singly-added flow; the next level then
upsamples the doubled output flow (models/spynet.lua:99).

Output: list of per-level dicts, FINEST first, the schema of PWCNet
(flow_past always None). `forward(x, with_warped=False)` skips the
per-level output warps, which feed only the photometric loss; the input
warps feed the next level and always run.

A frame's channels of an NHWC stack are a strided view; each warp gets
them as a contiguous tensor of its own, as the warp kernel takes them.

Image rows sharded over a spatial group (parallel/spatial.py), as
models/pwc.py does it: with `net.spatial_comm` set, every slot of the
group takes the whole input and computes the sharded levels of the
`level_plan` on its row band (`RowLayout`, by resolution level: SPyNet's
level l, coarsest first, is resolution level levels + 1 - l; every conv
is 7x7, so a band holds at least 3 rows). The input pyramid (the frames
alone, no gradient) stays whole on every slot and each level takes its
band of it; the trunks and heads exchange 3-row halos; the upsamples of
the coarser flow and occlusion read the whole level's taps; the input
warps warp the whole level's frames by the band's flow through the row
window (`warp_bilinear(..., y0=)`), and the output warps, whose sources
are warped frames with a gradient, gather them first. The outputs come
whole, or with `bands=True` as their bands with the group's "band"
(models/pwc.py).

The forward runs as spans (utils.timing.span, a profiler range only
while a profiler runs): `model.pyramid` (the cast and the input
pyramid), then `model.decode` (`_decode`), inside which each level is
`model.level{r}`, r its resolution level (1 = full resolution), as
models/pwc.py names its levels.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import avg_pool2, spatial_softmax
from ..parallel.spatial import Comm
from ..utils.timing import span
from .layers import Conv
from .pwc import DTYPES, RowLayout

_TRUNK = (32, 64, 32, 16)       # models/spynet.lua:18-21
_KERNEL = 7


@dataclasses.dataclass(frozen=True)
class SPyNetConfig:
    frames: int = 3
    levels: int = 7
    flownet_factor: float = 20.0
    rescale_flow: int = 0
    residual: int = 0
    flow_input: int = 1
    occ_input: int = 0
    dtype: torch.dtype = torch.float32
    reference_grads: bool = True

    @property
    def ref(self) -> int:
        return 1 if self.frames == 2 else (self.frames + 1) // 2

    @property
    def flow_scales(self) -> tuple:
        """Per output level, FINEST first (models/spynet.lua:154-158)."""
        if self.rescale_flow == 1:
            return tuple(self.flownet_factor for _ in range(self.levels))
        return tuple(self.flownet_factor / (2.0 ** k) for k in range(self.levels))

    @property
    def num_output_levels(self) -> int:
        return self.levels


def spynet_config_from_options(opt) -> SPyNetConfig:
    return SPyNetConfig(
        frames=opt.frames, levels=opt.levels,
        flownet_factor=opt.flownet_factor, rescale_flow=opt.rescale_flow,
        residual=opt.residual, flow_input=opt.flow_input,
        occ_input=opt.occ_input, dtype=DTYPES[opt.compute_dtype],
        reference_grads=opt.reference_grads,
    )


class _VolconTrunk(nn.Module):
    """7x7 conv stack 32-64-32-16 with ReLU (models/spynet.lua:18-21)."""

    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = (in_features, *_TRUNK)
        for i in range(len(_TRUNK)):
            self.add_module(f"c{i}", Conv(dims[i], dims[i + 1], kernel=_KERNEL,
                                          generator=generator))

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        for i in range(len(_TRUNK)):
            x = F.relu(getattr(self, f"c{i}")(x, comm))
        return x


class SPyNet(nn.Module):
    """The SPyNet variant. Submodule names are the flax module names
    (`trunk_{l}.c{i}`, `flow_head_{l}`, `occ_head_{l}`), so the params
    bridge maps one tree onto the other by name."""

    spatial_comm: Optional[Comm] = None   # the spatial group's, on a row-sharded slot

    def __init__(self, cfg: SPyNetConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        for l in range(1, cfg.levels + 1):
            self.add_module(f"trunk_{l}", _VolconTrunk(self._level_in_features(l),
                                                       generator=generator))
            self.add_module(f"flow_head_{l}", Conv(_TRUNK[-1], 2, kernel=_KERNEL,
                                                   generator=generator))
            if cfg.frames > 2:
                self.add_module(f"occ_head_{l}", Conv(_TRUNK[-1], 2, kernel=_KERNEL,
                                                      generator=generator))

    def _level_in_features(self, l: int) -> int:
        """Channels of level l's input: the frames alone at level 1; the
        finer levels add the upsampled flow and occlusion where configured."""
        cfg = self.cfg
        c = 3 * cfg.frames
        if l > 1 and cfg.flow_input == 1:
            c += 2
        if l > 1 and cfg.frames > 2 and cfg.occ_input == 1:
            c += 2
        return c

    def _rows(self, height: int) -> RowLayout:
        """The row layout of a forward at `height` rows, by resolution
        level (module docstring): a 7x7 conv's halo of 3 rows."""
        return RowLayout(self.spatial_comm, height, self.cfg.levels, _KERNEL // 2)

    def forward(self, x: torch.Tensor, with_warped: bool = True, bands: bool = False
                ) -> List[Dict[str, Any]]:
        """x: (B, H, W, 3*frames) frame stack, H and W divisible by
        2**(levels-1). `bands`: module docstring."""
        cfg = self.cfg
        levels = cfg.levels
        if x.shape[-1] != 3 * cfg.frames:
            raise ValueError(f"expected {3 * cfg.frames} input channels, got {x.shape[-1]}")
        with span("model.pyramid"):
            x = x.to(cfg.dtype)
            rows = self._rows(x.shape[1])
            # input pyramid, level l in 1..levels (1 = coarsest;
            # models/spynet.lua:85-90), whole
            downs = {levels: x}
            for l in range(levels - 1, 0, -1):
                downs[l] = avg_pool2(downs[l + 1])
        with span("model.decode"):
            return self._decode(downs, rows, with_warped, bands)

    def _decode(self, downs: Dict[int, torch.Tensor], rows: RowLayout, with_warped: bool,
                bands: bool) -> List[Dict[str, Any]]:
        """Coarse to fine over the input pyramid `downs`: each level's
        input warps, trunk, heads and output warps, then the output
        groups, finest first."""
        cfg = self.cfg
        F_, ref, levels = cfg.frames, cfg.ref, cfg.levels
        factor = cfg.flownet_factor
        rg = cfg.reference_grads

        def frame_slice(t, f):
            return t[..., 3 * (f - 1): 3 * f]

        def multiplier(f, exponent):
            if cfg.rescale_flow == 1:
                return factor * (f - ref)
            return factor * (f - ref) / (2.0 ** exponent)

        out_levels: Dict[int, Dict[str, Any]] = {}
        prev_flow = prev_occ = None
        for l in range(1, levels + 1):
            r = levels + 1 - l   # the resolution level of the row layout
            with span(f"model.level{r}"):
                lvl = levels - l  # the reference's `lvl` exponent
                comm = rows.comm(r)
                # the level's frames: the reference frame as it is, the others
                # warped by the upsampled coarser flow (models/spynet.lua:92-111)
                if l == 1:
                    ups_flow = None
                    level_in = rows.band(downs[l], r)
                else:
                    ups_flow = rows.up_bilinear(prev_flow, r + 1)
                    if cfg.rescale_flow == 1:
                        ups_flow = ups_flow * 2.0
                    frames_in = {}
                    for f in range(1, F_ + 1):
                        frame = frame_slice(downs[l], f)
                        frames_in[f] = (rows.band(frame, r) if f == ref else
                                        rows.warp_whole(frame.contiguous(),
                                                        ups_flow * multiplier(f, lvl), r, rg))
                    parts = [frames_in[f] for f in range(1, F_ + 1)]
                    if cfg.flow_input == 1:
                        parts.append(ups_flow)
                    if F_ > 2 and cfg.occ_input == 1:
                        parts.append(rows.up_nearest(prev_occ, r + 1))
                    level_in = torch.cat(parts, dim=-1)

                trunk = getattr(self, f"trunk_{l}")(level_in, comm)
                flow = getattr(self, f"flow_head_{l}")(trunk, comm)
                # residual add inside the level (models/spynet.lua:33-35)
                if ups_flow is not None and cfg.residual == 1:
                    flow = flow + ups_flow

                occ = None
                if F_ > 2:
                    occ = spatial_softmax(getattr(self, f"occ_head_{l}")(trunk, comm))

                # per-level output warps re-warp the level INPUT frames, which
                # for f != ref are already-warped frames (models/spynet.lua:37-57)
                warped = []
                for f in range(1, F_ + 1):
                    if f == ref or not with_warped:
                        continue
                    m = flow * multiplier(f, lvl)
                    warped.append(rows.warp_whole(frame_slice(downs[l], f).contiguous(), m, r, rg)
                                  if l == 1 else rows.warp(frames_in[f], m, r, rg))

                out_flow = flow
                # second residual add on the OUTPUT flow only
                # (models/spynet.lua:144-147)
                if ups_flow is not None and cfg.residual == 1:
                    out_flow = out_flow + ups_flow

                place = (lambda t: t) if bands else (lambda t: rows.whole(t, r))
                out_levels[l] = {
                    "flow": place(out_flow),
                    "flow_past": None,
                    "occ": None if occ is None else place(occ),
                    "warped": [place(w) for w in warped],
                    "flow_scale": cfg.flow_scales[levels - l],
                }
                if bands:
                    out_levels[l]["band"] = rows.band_of(r)
                # the next level upsamples out_level[l-1][1] — the OUTPUT flow,
                # i.e. the doubled flow when residual=1 (models/spynet.lua:99,146)
                prev_flow = out_flow
                prev_occ = occ

        # finest first
        return [out_levels[l] for l in range(levels, 0, -1)]
