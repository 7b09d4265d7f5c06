"""Plain PyTorch reference of the SPyNet variant (Ranjan & Black, CVPR
2017, as JJanai/back2future models/spynet.lua builds it): an image
pyramid; per level, coarsest first, the non-reference frames warped by
the upsampled coarser flow, the frames and that flow into a trunk of
7x7 convs 32-64-32-16 with ReLU, and 7x7 heads for the flow and (with
more than 2 frames) a 2-channel softmax occlusion. For the settings the
benchmark's configurations use: odd `frames`, flow input on, no
residual flow, no occlusion input, no rescaling.

Parameters are a dict of tensors under the names `param_shapes` gives
(`trunk_{l}.c{0..3}`, `flow_head_{l}`, `occ_head_{l}`, level 1 the
coarsest). `forward` returns the output groups, finest first.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .common import Precision, avg_pool2, channel_softmax, conv, frames_of, up_bilinear, warp

TRUNK = (32, 64, 32, 16)
KERNEL = 7


def _check(opt: dict) -> None:
    want = dict(netType="spynet", residual=0, flow_input=1, occ_input=0, rescale_flow=0)
    bad = {k: opt.get(k) for k, v in want.items() if opt.get(k) != v}
    if bad or opt["frames"] % 2 != 1 or opt["frames"] < 3:
        raise ValueError(f"the SPyNet reference does not cover these options: {bad or opt}")


def param_shapes(opt: dict) -> Dict[str, tuple]:
    """Every parameter's shape, by name, in a fixed order."""
    _check(opt)
    shapes: Dict[str, tuple] = {}

    def add(name, c_in, c_out):
        shapes[name + ".weight"] = (c_out, c_in, KERNEL, KERNEL)
        shapes[name + ".bias"] = (c_out,)

    for l in range(1, opt["levels"] + 1):
        dims = (3 * opt["frames"] + (2 if l > 1 else 0),) + TRUNK
        for i in range(len(TRUNK)):
            add(f"trunk_{l}.c{i}", dims[i], dims[i + 1])
        add(f"flow_head_{l}", TRUNK[-1], 2)
        add(f"occ_head_{l}", TRUNK[-1], 2)
    return shapes


def forward(params: dict, x: torch.Tensor, opt: dict, with_warped: bool,
            q: Precision = Precision()) -> List[dict]:
    """x: (B, H, W, 3F) normalised frames, H and W divisible by
    2**(levels-1)."""
    _check(opt)
    frames, levels, factor = opt["frames"], opt["levels"], opt["flownet_factor"]
    ref = (frames + 1) // 2
    downs = {levels: q(x)}
    for l in range(levels - 1, 0, -1):
        downs[l] = q(avg_pool2(downs[l + 1]))

    outs = []
    prev_flow = None
    for l in range(1, levels + 1):
        lvl = levels - l
        imgs = frames_of(downs[l], frames)
        if l == 1:
            level_in, frames_in = downs[1], imgs
        else:
            up = q(up_bilinear(prev_flow))
            frames_in = [imgs[f - 1] if f == ref else
                         warp(imgs[f - 1], up * (factor * (f - ref) / 2.0 ** lvl), q)
                         for f in range(1, frames + 1)]
            level_in = torch.cat(frames_in + [up], dim=-1)
        t = level_in
        for i in range(len(TRUNK)):
            t = torch.relu(conv(t, params, f"trunk_{l}.c{i}", q))
        flow = conv(t, params, f"flow_head_{l}", q)
        occ = q(channel_softmax(conv(t, params, f"occ_head_{l}", q)))
        warped = []
        if with_warped:
            for f in range(1, frames + 1):
                if f != ref:
                    warped.append(warp(frames_in[f - 1], flow * (factor * (f - ref) / 2.0 ** lvl),
                                       q))
        outs.append({"flow": flow, "occ": occ, "warped": warped,
                     "flow_scale": factor / 2.0 ** lvl})
        prev_flow = flow
    return outs[::-1]
