"""Pyramid resampling ops with Torch-parity numerics (NHWC), plain torch.

Counterpart of back2future_tpu/ops/pyramid.py, same conventions:

  avg_pool2             nn.SpatialAveragePooling(2,2,2,2), floor for odd sizes
  subsample2            nn.SpatialAveragePooling(1,1,2,2)
  upsample_nearest2x    nn.SpatialUpSamplingNearest(2)
  upsample_bilinear2x   nn.SpatialUpSamplingBilinear(2), align-corners
  resize_bilinear       align-corners: src = dst*(in-1)/(out-1)
  resize_nearest        src = floor(dst*in/out) (torch image.scale 'simple')
  spatial_softmax       softmax over the channel axis

The bilinear resize takes the same two taps per output as the JAX
package's interpolation matrices (positions in float64, weights and sums
in f32), so the two agree to float rounding.

`upsample_bilinear2x_rows` computes a band of rows of the 2x upsample of
a row-sharded level (parallel/spatial.py): the taps are those of the
whole level's sizes, so each output row is the whole upsample's row bit
for bit. `avg_pool2`, `upsample_nearest2x` and `spatial_softmax` are
row-local: on a band whose first row is even they give the band of the
whole result.
"""

from __future__ import annotations

import torch


def avg_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 mean pooling, stride 2 (floor semantics for odd sizes)."""
    b, h, w, c = x.shape
    h2, w2 = h // 2, w // 2
    x = x[:, : h2 * 2, : w2 * 2]
    return x.reshape(b, h2, 2, w2, 2, c).sum(dim=(2, 4)) * 0.25


def subsample2(x: torch.Tensor) -> torch.Tensor:
    """1x1 kernel stride-2 'pooling' == top-left subsampling."""
    return x[:, ::2, ::2, :]


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)


def _interp_taps_uncached(in_size: int, out_size: int, device: torch.device):
    """Align-corners taps: src = dst*(in-1)/(out-1) in float64, as the
    JAX package builds its interpolation matrix -> (i0, i1, w0, w1).
    Made outside inference mode: the cached tensors may later meet
    autograd."""
    with torch.inference_mode(False):
        pos = torch.arange(out_size, dtype=torch.float64, device=device) * (
            (in_size - 1) / max(out_size - 1, 1))
        i0 = torch.floor(pos).long()
        i1 = torch.clamp(i0 + 1, max=in_size - 1)
        fr = (pos - i0).float()
        return i0, i1, 1.0 - fr, fr


def _nearest_index_uncached(in_size: int, out_size: int, device: torch.device):
    """src = floor(dst*in/out), in float64 like the JAX package."""
    with torch.inference_mode(False):
        pos = torch.arange(out_size, dtype=torch.float64, device=device) * (
            in_size / out_size)
        return torch.clamp(pos.long(), max=in_size - 1)


_CACHE_SIZE = 128   # entries per table; the oldest goes first
_TAPS: dict = {}
_NEAREST: dict = {}


def _cached(table: dict, build, in_size: int, out_size: int, device: torch.device):
    """`build(in_size, out_size, device)`, kept per arguments in `table`.

    Eager calls fill the table. While torch.export or torch.compile
    traces, whose tensors are fakes that must never reach the table (a
    later eager call would get them back), an entry an eager call made is
    read, and enters the traced program as a constant; a missing one is
    built and traced, and not kept."""
    key = (in_size, out_size, device)
    hit = table.get(key)
    if hit is not None:
        return hit
    value = build(in_size, out_size, device)
    if not torch.compiler.is_compiling():
        if len(table) >= _CACHE_SIZE:
            del table[next(iter(table))]
        table[key] = value
    return value


def _interp_taps(in_size: int, out_size: int, device: torch.device):
    return _cached(_TAPS, _interp_taps_uncached, in_size, out_size, device)


def _nearest_index(in_size: int, out_size: int, device: torch.device):
    return _cached(_NEAREST, _nearest_index_uncached, in_size, out_size, device)


def _axis_linear(x: torch.Tensor, out_size: int, dim: int) -> torch.Tensor:
    """Align-corners 1-D linear interpolation along `dim` (1 or 2): the
    two taps of each output, weighted and summed in f32."""
    in_size = x.shape[dim]
    if in_size == out_size:
        return x
    if in_size == 1:
        return x.repeat_interleave(out_size, dim=dim)
    i0, i1, w0, w1 = _interp_taps(in_size, out_size, x.device)
    shape = [1, 1, 1, 1]
    shape[dim] = out_size
    xf = x.float()
    y = (xf.index_select(dim, i0) * w0.view(shape)
         + xf.index_select(dim, i1) * w1.view(shape))
    return y.to(x.dtype)


def resize_bilinear(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Align-corners bilinear resize (separable)."""
    return _axis_linear(_axis_linear(x, out_h, dim=1), out_w, dim=2)


def upsample_bilinear2x(x: torch.Tensor) -> torch.Tensor:
    return resize_bilinear(x, x.shape[1] * 2, x.shape[2] * 2)


def upsample_bilinear2x_rows(x: torch.Tensor, in_h: int, x_y0: int, out_y0: int,
                             out_h: int) -> torch.Tensor:
    """Rows out_y0 .. out_y0 + out_h - 1 of the 2x align-corners upsample
    of a level of `in_h` rows, of which `x` holds rows x_y0 .. (every row
    that those output rows read: a band with one row of halo on each
    side, or the whole level)."""
    i0, i1, w0, w1 = _interp_taps(in_h, 2 * in_h, x.device)
    rows = slice(out_y0, out_y0 + out_h)
    shape = (1, out_h, 1, 1)
    xf = x.float()
    y = (xf.index_select(1, i0[rows] - x_y0) * w0[rows].view(shape)
         + xf.index_select(1, i1[rows] - x_y0) * w1[rows].view(shape))
    return _axis_linear(y.to(x.dtype), x.shape[2] * 2, dim=2)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize with src = floor(dst * in/out) (torch 'simple')."""
    h, w = x.shape[1], x.shape[2]
    return (x.index_select(1, _nearest_index(h, out_h, x.device))
            .index_select(2, _nearest_index(w, out_w, x.device)))


def spatial_softmax(x: torch.Tensor) -> torch.Tensor:
    """Softmax over the channel (last) axis at each spatial position."""
    return torch.softmax(x, dim=-1)
