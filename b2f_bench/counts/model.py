"""Model FLOPs a triplet, from a configuration's layer shapes.

Counted: the multiply-adds of every convolution (2 * k * k * C_in *
C_out per output pixel) and of every cost volume (2 * C * win * win per
pixel and frame term), as 2 operations each. Not counted: the
elementwise work (activations, softmax, pooling, upsampling, the
bilinear samplers), which is small beside these and bound by memory.
A training step counts 3 forwards: the forward, and the two products
of the backward (the input and the weight gradients).
"""

from __future__ import annotations

PWC_FEATURES = (3, 16, 32, 64, 96, 128, 192)   # channels of levels 1..7
PWC_DECODER = (128, 128, 96, 64, 32, 2)
SPYNET_TRUNK = (32, 64, 32, 16)


def _conv(h: int, w: int, c_in: int, c_out: int, k: int = 3) -> int:
    """A k x k conv's operations over an h x w output."""
    return 2 * h * w * k * k * c_in * c_out


def pwc_forward(opt: dict, height: int, width: int) -> int:
    """One triplet through the multi-frame PWC forward: the siamese
    pyramid of every frame, then at each decoded level the cost volumes
    (one term per non-reference frame) and the flow and occlusion
    decoders."""
    frames, levels, skip, win = opt["frames"], opt["levels"], opt["pwc_skip"], opt["pwc_ws"]
    fm = PWC_FEATURES
    nd = win * win
    total = 0
    for l in range(2, levels + 1):
        h, w = height >> (l - 1), width >> (l - 1)
        total += frames * (_conv(h, w, fm[l - 2], fm[l - 1]) + _conv(h, w, fm[l - 1], fm[l - 1]))
    for l in range(skip + 1, levels + 1):
        h, w, c = height >> (l - 1), width >> (l - 1), fm[l - 1]
        top = l == levels
        total += (frames - 1) * 2 * h * w * c * nd
        for c_in in (2 * nd + (0 if top else c + 2), 2 * nd + c + (0 if top else 2)):
            dims = (c_in,) + PWC_DECODER
            total += sum(_conv(h, w, dims[i], dims[i + 1]) for i in range(len(PWC_DECODER)))
    return total


def spynet_forward(opt: dict, height: int, width: int) -> int:
    """One triplet through SPyNet: at each level the 7x7 trunk on the
    frames (and the coarser flow below the coarsest), and the flow and
    occlusion heads."""
    frames, levels = opt["frames"], opt["levels"]
    total = 0
    for l in range(1, levels + 1):
        h, w = height >> (levels - l), width >> (levels - l)
        dims = (3 * frames + (2 if l > 1 else 0),) + SPYNET_TRUNK
        total += sum(_conv(h, w, dims[i], dims[i + 1], 7) for i in range(len(SPYNET_TRUNK)))
        total += 2 * _conv(h, w, SPYNET_TRUNK[-1], 2, 7)
    return total


FORWARD = {"pwc": pwc_forward, "spynet": spynet_forward}


def forward_flops(opt: dict, height: int, width: int) -> int:
    """A triplet's forward FLOPs for the configuration's `netType`."""
    return FORWARD[opt["netType"]](opt, height, width)


def step_flops(opt: dict, height: int, width: int) -> int:
    """A triplet's training FLOPs: 3 forwards."""
    return 3 * forward_flops(opt, height, width)
