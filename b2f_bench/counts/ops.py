"""The least work of each kernel op of the program, by its `b2f::*` name,
from its arguments: the operations the function needs and the bytes it
must move, each input read once and each output written once, whatever
kernel computes it. An argument is a tensor's (shape, bytes an element)
or a scalar. The bound of a call is the larger of its operations over
the peak rate of its type and its bytes over the memory's rate.

  cost_volume(ref, frame, win, ...)       the correlation of every pixel
      with win * win displaced pixels: 2 * C operations each; reads ref
      and frame, writes (B, H, W, win * win)
  cost_volume_dref / _dframe(g, x, win, ...)   the two transposes of the
      same products: 2 * C * win * win a pixel; read g and x, write x's
      shape
  warp_bilinear(images, flow, ...)        4 taps a channel of an output
      pixel, a multiply and an add each; reads the images and the flow,
      writes (flow's B, H, W, images' C)
  warp_dimages(flow, g, h_src, ...)       the transpose of the same taps;
      reads flow and g, writes the image gradient (B, h_src, W, C)
  warp_dflow(images, flow, g, ...)        the 4 corner products of each
      output pixel's channels; reads images, flow and g, writes flow's
      shape
  stem(x, 8 parameters)                   two ConvUnits (3x3 conv stride
      2, 3x3 conv) of 3 -> 16 -> 32 channels; reads x and the
      parameters, writes both units' outputs
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {2: 989e12, 4: 67e12}   # bf16 tensor cores; f32 outside them, by element bytes

Arg = object   # a (shape tuple, element bytes) pair, or a scalar


def _numel(shape: Sequence[int]) -> int:
    return math.prod(shape)


def _bytes(arg) -> int:
    shape, size = arg
    return _numel(shape) * size


def _cost_volume(args):
    ref, frame, win = args[0], args[1], args[2]
    b, h, w, c = ref[0]
    out = b * h * w * win * win * ref[1]
    return 2 * b * h * w * c * win * win, _bytes(ref) + _bytes(frame) + out


def _cost_volume_grad(args):
    g, x, win = args[0], args[1], args[2]
    b, h, w, c = x[0]
    return 2 * b * h * w * c * win * win, _bytes(g) + 2 * _bytes(x)


def _warp_bilinear(args):
    images, flow = args[0], args[1]
    b, h, w, _ = flow[0]
    out = b * h * w * images[0][3]
    return 8 * out, _bytes(images) + _bytes(flow) + out * images[1]


def _warp_dimages(args):
    flow, g = args[0], args[1]
    h_src = args[2] if len(args) > 2 and args[2] >= 0 else g[0][1]
    b, _, w, c = g[0]
    return 8 * _numel(g[0]), _bytes(flow) + _bytes(g) + b * h_src * w * c * g[1]


def _warp_dflow(args):
    images, flow, g = args[0], args[1], args[2]
    return 8 * _numel(g[0]), _bytes(images) + 2 * _bytes(flow) + _bytes(g)


def _stem(args):
    x, params = args[0], args[1:]
    n, h, w, c = x[0]
    h2, w2, h3, w3 = (h + 1) // 2, (w + 1) // 2, (h + 3) // 4, (w + 3) // 4
    ops = 2 * n * 9 * (h2 * w2 * (c * 16 + 16 * 16) + h3 * w3 * (16 * 32 + 32 * 32))
    out = n * (h2 * w2 * 16 + h3 * w3 * 32) * x[1]
    return ops, _bytes(x) + sum(_bytes(p) for p in params) + out


WORK = {
    "cost_volume": _cost_volume,
    "cost_volume_dref": _cost_volume_grad,
    "cost_volume_dframe": _cost_volume_grad,
    "warp_bilinear": _warp_bilinear,
    "warp_dimages": _warp_dimages,
    "warp_dflow": _warp_dflow,
    "stem": _stem,
}


def work(op: str, args: Sequence[Arg]) -> Tuple[int, int]:
    """(operations, bytes) of one call of `b2f::<op>`."""
    return WORK[op](list(args))


def bound_seconds(op: str, args: Sequence[Arg]) -> float:
    """The least time of one call: operations over the peak of the
    inputs' type, or bytes over the memory's rate, the larger."""
    flops, nbytes = work(op, args)
    element = args[0][1]
    return max(flops / PEAK_FLOPS[element], nbytes / HBM_BYTES_PER_S)
