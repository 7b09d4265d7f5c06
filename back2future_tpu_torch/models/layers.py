"""Building blocks with Torch-parity initialization (NHWC interface).

Counterpart of back2future_tpu/models/layers.py. ConvUnit and Decoder
mirror the reference blocks (models/pwc.lua:58-85); initialization is
torch nn.SpatialConvolution's uniform(-1/sqrt(kW*kH*nIn), +1/sqrt(...))
for weights AND biases, drawn from an explicit generator.

Parameters are kept in f32 and cast to the compute dtype per call, as
flax's `dtype=` does. Tensors stay NHWC between modules; a conv runs on
the NCHW view `x.permute(0, 3, 1, 2)`, which is channels_last in memory,
so no copy is made.

On a row band of a sharded level (parallel/spatial.py) each block takes
its spatial group's communicator, `comm`: a conv exchanges a halo of
k//2 rows with the neighbouring bands (zeros at the image's edge) and
convolves with no row padding. At stride 2 the bands of the input are
twice the output's and start on an even row, so output row r still
reads input rows 2r-1 .. 2r+1 (the halo below goes unread).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..parallel.spatial import Comm, halo_rows


class Conv(nn.Module):
    """k x k conv (default 3x3) with padding k//2 on each side, so a
    stride-2 output is ceil(H/2) as in flax; torch init; NHWC."""

    def __init__(self, in_features: int, features: int, kernel: int = 3,
                 stride: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.padding = kernel // 2
        self.weight = nn.Parameter(torch.empty(features, in_features, kernel, kernel))
        self.bias = nn.Parameter(torch.empty(features))
        stdv = 1.0 / (kernel * kernel * in_features) ** 0.5
        with torch.no_grad():
            self.weight.uniform_(-stdv, stdv, generator=generator)
            self.bias.uniform_(-stdv, stdv, generator=generator)

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        w = self.weight.to(x.dtype, memory_format=torch.channels_last)
        padding = self.padding
        if comm is not None:   # a row band: the halo stands in for the row padding
            x, padding = halo_rows(x, self.padding, comm), (0, self.padding)
        y = F.conv2d(x.permute(0, 3, 1, 2), w, self.bias.to(x.dtype),
                     stride=self.stride, padding=padding)
        return y.permute(0, 2, 3, 1).contiguous()


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """nn.LeakyReLU(0.2) (models/pwc.lua:61,63)."""
    return F.leaky_relu(x, 0.2)


class ConvUnit(nn.Module):
    """conv3x3(stride s) + LeakyReLU + conv3x3 + LeakyReLU
    (models/pwc.lua:58-65)."""

    def __init__(self, in_features: int, features: int, stride: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.c0 = Conv(in_features, features, stride=stride, generator=generator)
        self.c1 = Conv(features, features, generator=generator)

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        return leaky_relu(self.c1(leaky_relu(self.c0(x, comm)), comm))


class Decoder(nn.Module):
    """Six 3x3 convs 128-128-96-64-32-2 with LeakyReLU between
    (models/pwc.lua:76-85; d=16)."""

    def __init__(self, in_features: int, widths: Sequence[int] = (128, 128, 96, 64, 32),
                 out_features: int = 2, generator: Optional[torch.Generator] = None):
        super().__init__()
        dims = [in_features, *widths]
        for i in range(len(widths)):
            self.add_module(f"c{i}", Conv(dims[i], dims[i + 1], generator=generator))
        self.out = Conv(dims[-1], out_features, generator=generator)
        self.n_hidden = len(widths)

    def forward(self, x: torch.Tensor, comm: Optional[Comm] = None) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = leaky_relu(getattr(self, f"c{i}")(x, comm))
        return self.out(x, comm)
