"""Plain PyTorch building blocks of the benchmark's reference models.

Written from the published graphs (JJanai/back2future models/pwc.lua,
models/spynet.lua, CostVolMulti.lua, extras/stnbhwd) and independent of
the program: this package imports nothing of it. Tensors are NHWC, in
float32; the caller turns TF32 off (`exact_math`).

`Precision` carries the one switch a reference run has: "f32", or
"fp8", the control, which rounds every tensor the network makes, and
every conv weight, to float8 e4m3 (values clamped to its range of
+-448) and computes each operation in float32 on the rounded values.
The rounding has an identity gradient, so a training step runs through
it.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


class Precision:
    """What a reference run rounds its tensors to: nothing ("f32") or
    float8 e4m3 ("fp8")."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"precision {name!r}: use 'f32' or 'fp8'")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return t
        rounded = t.detach().clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).float()
        return t + (rounded - t).detach()


@contextlib.contextmanager
def exact_math():
    """float32 convolutions and products without TF32, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv(x: torch.Tensor, params: dict, name: str, q: Precision, stride: int = 1) -> torch.Tensor:
    """A k x k convolution with padding k // 2 (NHWC in and out)."""
    w, b = q(params[name + ".weight"]), q(params[name + ".bias"])
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=w.shape[-1] // 2)
    return q(y.permute(0, 2, 3, 1))


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean, stride 2 (nn.SpatialAveragePooling(2,2,2,2))."""
    return F.avg_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


def up_nearest(x: torch.Tensor) -> torch.Tensor:
    """nn.SpatialUpSamplingNearest(2)."""
    return F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest").permute(0, 2, 3, 1)


def up_bilinear(x: torch.Tensor) -> torch.Tensor:
    """nn.SpatialUpSamplingBilinear(2): align-corners bilinear 2x."""
    h, w = x.shape[1:3]
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(2 * h, 2 * w), mode="bilinear",
                      align_corners=True)
    return y.permute(0, 2, 3, 1)


def channel_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def cost_volume(ref: torch.Tensor, frames: Sequence[torch.Tensor], win: int,
                fwd: bool) -> torch.Tensor:
    """CostVolMulti: for each displacement (qx outer, qy inner) of the win
    x win window, dilated by the frame distance k + 1 and mirrored for
    past frames, sum_c ref(p) * frame_k(p - q), zero outside the image,
    summed over the frames and divided by C * len(frames)."""
    b, h, w, c = ref.shape
    n = (win - 1) // 2
    sign = 1 if fwd else -1
    out = torch.zeros(b, h, w, win * win, dtype=ref.dtype, device=ref.device)
    for k, frame in enumerate(frames):
        d = k + 1
        pad = n * d
        fp = F.pad(frame, (0, 0, pad, pad, pad, pad))
        planes = []
        for qx in range(-n, n + 1):
            for qy in range(-n, n + 1):
                sy, sx = sign * qy * d, sign * qx * d
                shifted = fp[:, pad - sy:pad - sy + h, pad - sx:pad - sx + w]
                planes.append((ref * shifted).sum(-1))
        out = out + torch.stack(planes, dim=-1)
    return out / (c * len(frames))


def _taps(flow: torch.Tensor, h: int, w: int):
    """Source taps of each output pixel of the sampler: the coordinate
    (output pixel + flow, flow channels (x, y)) clamped to the image, its
    corners (the +1 corners clamped too) and weights, and whether each +1
    corner lies inside the image."""
    b, ho, wo, _ = flow.shape
    gx = torch.arange(wo, dtype=flow.dtype, device=flow.device).view(1, 1, wo)
    gy = torch.arange(ho, dtype=flow.dtype, device=flow.device).view(1, ho, 1)
    x = (flow[..., 0] + gx).clamp(0, w - 1)
    y = (flow[..., 1] + gy).clamp(0, h - 1)
    xf, yf = x.floor(), y.floor()
    ax, ay = x - xf, y - yf                   # weights of the +1 corners
    x0, y0 = xf.long(), yf.long()
    x1, y1 = (x0 + 1).clamp(max=w - 1), (y0 + 1).clamp(max=h - 1)
    return (x0, y0, x1, y1), (ax, ay), (x0 + 1 <= w - 1, y0 + 1 <= h - 1)


def _gather(images: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    b = images.shape[0]
    bi = torch.arange(b, device=images.device).view(b, 1, 1)
    return images[bi, yy, xx]


class _Warp(torch.autograd.Function):
    """The reference sampler (BilinearSamplerBHWD with pixel offsets and a
    border clamp). The image gradient is the transpose of the gather; the
    flow gradient is the sampler's own formula, the difference of the
    corners weighted by the other axis, at the clamped coordinate and not
    zeroed where it clamps (BilinearSamplerBHWD.cu:287-295)."""

    @staticmethod
    def forward(ctx, images, flow):
        h, w = images.shape[1:3]
        (x0, y0, x1, y1), (ax, ay), _ = _taps(flow, h, w)
        ax, ay = ax.unsqueeze(-1), ay.unsqueeze(-1)
        out = ((1 - ay) * ((1 - ax) * _gather(images, y0, x0) + ax * _gather(images, y0, x1))
               + ay * ((1 - ax) * _gather(images, y1, x0) + ax * _gather(images, y1, x1)))
        ctx.save_for_backward(images, flow)
        return out

    @staticmethod
    def backward(ctx, g):
        images, flow = ctx.saved_tensors
        b, h, w, c = images.shape
        (x0, y0, x1, y1), (ax, ay), (x_in, y_in) = _taps(flow, h, w)
        d_images = d_flow = None
        corners = (((y0, x0), (1 - ax) * (1 - ay), None), ((y0, x1), ax * (1 - ay), x_in),
                   ((y1, x0), (1 - ax) * ay, y_in), ((y1, x1), ax * ay, x_in & y_in))
        if ctx.needs_input_grad[0]:
            d_images = torch.zeros(b * h * w, c, dtype=g.dtype, device=g.device)
            base = torch.arange(b, device=g.device).view(b, 1, 1) * h
            for (yy, xx), weight, _ in corners:
                d_images.index_add_(0, ((base + yy) * w + xx).reshape(-1),
                                    (weight.unsqueeze(-1) * g).reshape(-1, c))
            d_images = d_images.view(b, h, w, c)
        if ctx.needs_input_grad[1]:
            dots = []
            for (yy, xx), _, inside in corners:
                dot = (_gather(images, yy, xx) * g).sum(-1)
                dots.append(dot if inside is None else torch.where(inside, dot, 0.0))
            tl, tr, bl, br = dots
            d_flow = torch.stack([(1 - ay) * (tr - tl) + ay * (br - bl),
                                  (1 - ax) * (bl - tl) + ax * (br - tr)], dim=-1)
        return d_images, d_flow


def warp(images: torch.Tensor, flow: torch.Tensor, q: Precision) -> torch.Tensor:
    """`images` sampled at (pixel + flow); rounded as the run's precision
    says."""
    return q(_Warp.apply(images, q(flow)))


def frames_of(x: torch.Tensor, frames: int) -> List[torch.Tensor]:
    """The (B, H, W, 3) frames of a (B, H, W, 3F) stack."""
    return [x[..., 3 * f:3 * f + 3] for f in range(frames)]
