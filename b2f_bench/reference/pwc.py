"""Plain PyTorch reference of the multi-frame PWC network with the
3-state occlusion head (Janai et al., ECCV 2018; JJanai/back2future
models/pwc.lua), for the settings the benchmark's configurations use:
odd `frames` with the centre frame as reference, siamese features,
`pwc_skip` levels skipped at the fine end, no residual flow, no
rescaling, no past-flow decoder, separate (not summed) cost volumes.

Parameters are a dict of tensors under the names `param_shapes` gives
(`feat_{l}.c{0,1}`, `{flow,occ}_decoder_{l}.c{0..4}` and `.out`, each
with `.weight` (out, in, k, k) and `.bias`). `forward` returns the
output groups, finest first: {"flow", "occ", "warped", "flow_scale"}.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .common import (Precision, avg_pool2, channel_softmax, conv, cost_volume, frames_of,
                     up_bilinear, up_nearest, warp)

FEATURES = (16, 32, 64, 96, 128, 192)      # levels 2..7 (models/pwc.lua:89)
DECODER = (128, 128, 96, 64, 32)           # then 2 outputs (models/pwc.lua:76-85)
LEAK = 0.2


def _check(opt: dict) -> None:
    want = dict(netType="pwc", levels=7, pwc_siamese=1, two_frame=0, residual=0,
                rescale_flow=0, occ_input=0, pwc_sum_cvs=False, past_flow=False)
    bad = {k: opt.get(k) for k, v in want.items() if opt.get(k) != v}
    if bad or opt["frames"] % 2 != 1 or opt["frames"] < 3 or opt["pwc_skip"] < 1:
        raise ValueError(f"the PWC reference does not cover these options: {bad or opt}")


def _levels(opt: dict):
    return range(opt["pwc_skip"] + 1, opt["levels"] + 1)


def param_shapes(opt: dict) -> Dict[str, tuple]:
    """Every parameter's shape, by name, in a fixed order."""
    _check(opt)
    fm = (3,) + FEATURES
    nd = opt["pwc_ws"] ** 2
    shapes: Dict[str, tuple] = {}

    def add(name, c_in, c_out, k=3):
        shapes[name + ".weight"] = (c_out, c_in, k, k)
        shapes[name + ".bias"] = (c_out,)

    for l in range(2, opt["levels"] + 1):
        add(f"feat_{l}.c0", fm[l - 2], fm[l - 1])
        add(f"feat_{l}.c1", fm[l - 1], fm[l - 1])
    for l in _levels(opt):
        c = fm[l - 1]
        top = l == opt["levels"]
        for dec, c_in in (("flow_decoder", 2 * nd + (0 if top else c + 2)),
                          ("occ_decoder", 2 * nd + c + (0 if top else 2))):
            dims = (c_in,) + DECODER
            for i in range(len(DECODER)):
                add(f"{dec}_{l}.c{i}", dims[i], dims[i + 1])
            add(f"{dec}_{l}.out", DECODER[-1], 2)
    return shapes


def _leaky(x):
    return torch.nn.functional.leaky_relu(x, LEAK)


def _decoder(x, params, name, q):
    for i in range(len(DECODER)):
        x = _leaky(conv(x, params, f"{name}.c{i}", q))
    return conv(x, params, f"{name}.out", q)


def forward(params: dict, x: torch.Tensor, opt: dict, with_warped: bool,
            q: Precision = Precision()) -> List[dict]:
    """x: (B, H, W, 3F) normalised frames, H and W divisible by
    2**(levels-1)."""
    _check(opt)
    frames, levels, skip, win = opt["frames"], opt["levels"], opt["pwc_skip"], opt["pwc_ws"]
    factor = opt["flownet_factor"]
    ref = (frames + 1) // 2                      # 1-based (models/pwc.lua:130-133)
    l_st = skip + 1
    x = q(x)
    imgs = frames_of(x, frames)
    n = x.shape[0]

    # siamese pyramid: one conv chain over the frames stacked on the batch
    feats = {1: torch.cat(imgs, dim=0)}
    for l in range(2, levels + 1):
        y = _leaky(conv(feats[l - 1], params, f"feat_{l}.c0", q, stride=2))
        feats[l] = _leaky(conv(y, params, f"feat_{l}.c1", q))
    cs = {f: {l: feats[l][(f - 1) * n:f * n] for l in feats} for f in range(1, frames + 1)}

    ds = {}
    if with_warped:
        for f in range(1, frames + 1):
            if f != ref:
                chain = [imgs[f - 1]]
                for _ in range(levels - l_st):
                    chain.append(q(avg_pool2(chain[-1])))
                ds[f] = chain

    ws = {f: {} for f in range(1, frames + 1)}
    ufs, outs = {}, {}
    for l in range(levels, l_st - 1, -1):
        inp = cs if l == levels else ws
        cv_fwd = q(cost_volume(cs[ref][l], [inp[f][l] for f in range(ref + 1, frames + 1)],
                               win, fwd=True))
        cv_bwd = q(cost_volume(cs[ref][l], [inp[f][l] for f in range(ref - 1, 0, -1)],
                               win, fwd=False))
        cvs = torch.cat([cv_fwd, cv_bwd], dim=-1)
        occ_in = [cvs, cs[ref][l]] + ([] if l == levels else [ufs[l + 1]])
        occ = q(channel_softmax(_decoder(torch.cat(occ_in, dim=-1), params,
                                         f"occ_decoder_{l}", q)))
        flow_in = cvs if l == levels else torch.cat([cvs, cs[ref][l], ufs[l + 1]], dim=-1)
        flow = _decoder(flow_in, params, f"flow_decoder_{l}", q)
        ufs[l] = q(up_bilinear(flow))
        # the outputs: upsampled `skip` times to the output resolution
        out_flow, out_occ = ufs[l], up_nearest(occ)
        for _ in range(skip - 1):
            out_flow, out_occ = q(up_bilinear(out_flow)), up_nearest(out_occ)
        warped = []
        for f in range(1, frames + 1):
            if f == ref:
                continue
            if l > l_st:    # the next level's features, warped by this level's flow
                ws[f][l - 1] = warp(cs[f][l - 1], ufs[l] * (factor * (f - ref) / 2.0 ** (l - 2)),
                                    q)
            if with_warped:
                m = factor * (f - ref) / 2.0 ** (l - l_st)
                warped.append(warp(ds[f][l - l_st], out_flow * m, q))
        outs[l] = {"flow": out_flow, "occ": out_occ, "warped": warped,
                   "flow_scale": factor / 2.0 ** (l - l_st)}
    return [outs[l] for l in range(l_st, levels + 1)]
