"""Fused feature-pyramid stem: the level-2 and level-3 ConvUnits in two
kernels (counterpart of back2future_tpu/ops/stem_pallas.py).

`fused_stem(x, unit2, unit3)` computes `(f2, f3) = (unit2(x),
unit3(unit2(x)))` for the default net's stem (3 -> 16 -> 16 stride 2,
then 16 -> 32 -> 32 stride 2; models/pwc.lua:58-65) by the op `b2f::stem`
(ops/route.py), which takes the frames and both units' raw OIHW
parameters:

  * on CUDA tensors it launches K5 (`b2f_stem_unit_a`, unit 2) and then
    K6 (`b2f_stem_unit_b`, unit 3) on K5's output, each one fused
    ConvUnit whose mid map stays in shared memory: in bf16 on the tensor
    cores (csrc/stem_unit_a_mma.cu, csrc/stem_unit_b_mma.cu), in f32 on
    the CUDA cores (csrc/stem_fwd.cu); on CPU tensors, or under
    `plain_ops()`, the plain twin `stem_reference`; a fake gives both
    outputs' shapes. `stem_unit_a_cuda_cores` keeps K5's old bf16 kernel
    callable, for comparison on the card only.
  * its Autograd kernel (`register_function`, ops/route.py) has
    `_stem_bwd`'s formula (stem_pallas.py:463-466): the twin chain is
    recomputed from the detached frames and parameters and
    differentiated by autograd, so unit 3's gradients are taken at the
    twin's f2, not the kernel's; the TPU kernel has no backward kernel,
    so none is written here. One op and not one per unit for that
    reason.

As in the JAX package the fused stem is off by default; `B2F_STEM_PALLAS=1`
turns it on in both packages, for the shapes `stem_eligible` admits.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from ..runtime.cuda_build import Kernel
from .cost_volume import _bf16_info
from .route import (DTYPE_CODES, below_autograd, check_kernel_input, define, ptr,
                    register_function, stream_ptr)

# (x, w1, b1, w2, b2, out, dtype, N, H, W, stream)
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_UNIT_A = Kernel("b2f_stem_unit_a", _ARGS)   # K5: 3 -> 16 -> 16
_UNIT_B = Kernel("b2f_stem_unit_b", _ARGS)   # K6: 16 -> 32 -> 32
_UNIT_A_CUDA_CORES = Kernel("b2f_stem_unit_a_cuda_cores", _ARGS)   # K5's old kernel
_UNITS = {"a": (_UNIT_A, 3, 16), "b": (_UNIT_B, 16, 32)}   # kernel, c_in, c_out


def stem_enabled() -> bool:
    """`B2F_STEM_PALLAS` in ("1", "true", "yes", "on"), parsed as the JAX
    package parses it (stem_pallas.py:62-68); off by default."""
    v = os.environ.get("B2F_STEM_PALLAS", "").strip().lower()
    return v in ("1", "true", "yes", "on")


def stem_eligible(h: int, w: int, c_in: int, fm2: int, fm3: int) -> bool:
    """The shapes the JAX package fuses (stem_pallas.py:71-75): the
    default stem (3 -> 16 -> 32) on inputs with H % 4 == 0, W % 64 == 0,
    H >= 8 and W >= 64. The kernels take any size; the same shapes take
    the same path in both packages."""
    return (c_in == 3 and fm2 == 16 and fm3 == 32
            and h % 4 == 0 and w % 64 == 0 and h >= 8 and w >= 64)


UnitParams = Sequence[torch.Tensor]   # (c0.weight, c0.bias, c1.weight, c1.bias), OIHW


def unit_params(unit: torch.nn.Module) -> Tuple[torch.Tensor, ...]:
    """A ConvUnit's parameters in the order the stem takes them."""
    return unit.c0.weight, unit.c0.bias, unit.c1.weight, unit.c1.bias


def _conv_leaky(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, stride: int) -> torch.Tensor:
    """models.layers.Conv + leaky_relu: parameters cast to the compute
    dtype, padding 1, NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.to(x.dtype, memory_format=torch.channels_last),
                 b.to(x.dtype), stride=stride, padding=1)
    return F.leaky_relu(y.permute(0, 2, 3, 1).contiguous(), 0.2)


def unit_reference(x: torch.Tensor, p: UnitParams) -> torch.Tensor:
    """Plain torch twin of one kernel (K5 or K6): a ConvUnit, conv stride
    2 + bias + leaky 0.2, then conv + bias + leaky, in the compute dtype."""
    return _conv_leaky(_conv_leaky(x, p[0], p[1], 2), p[2], p[3], 1)


def stem_reference(x: torch.Tensor, p2: UnitParams, p3: UnitParams
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch twin of K5 + K6 (`_stem_xla`, stem_pallas.py:433-446)."""
    f2 = unit_reference(x, p2)
    return f2, unit_reference(f2, p3)


def _launch_unit(kernel: Kernel, c_in: int, c_out: int, x: torch.Tensor, p: UnitParams,
                 unit: str) -> torch.Tensor:
    n, h, w = x.shape[:3]
    check_kernel_input(f"stem unit {unit} input", x, (n, h, w, c_in), x.dtype)
    shapes = ((c_out, c_in, 3, 3), (c_out,), (c_out, c_out, 3, 3), (c_out,))
    for t, shape in zip(p, shapes):
        if tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f"stem unit {unit}: parameter of shape {tuple(t.shape)} on "
                             f"{t.device}, expected {shape} on {x.device}")
    w1, b1, w2, b2 = (t.detach().to(x.dtype).float() for t in p)
    w1, w2 = (k.permute(2, 3, 1, 0).contiguous() for k in (w1, w2))   # OIHW -> HWIO
    b1, b2 = b1.contiguous(), b2.contiguous()
    out = torch.empty((n, (h + 1) // 2, (w + 1) // 2, c_out), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        kernel(ptr(x), ptr(w1), ptr(b1), ptr(w2), ptr(b2), ptr(out), DTYPE_CODES[x.dtype],
               n, h, w, stream_ptr(x.device))
    return out


def stem_unit_cuda(x: torch.Tensor, p: UnitParams, unit: str) -> torch.Tensor:
    """One fused ConvUnit on a CUDA tensor: K5 (`unit="a"`, 3 -> 16) or K6
    (`"b"`, 16 -> 32); (N, H, W, Cin) -> (N, ceil(H/2), ceil(W/2), Cout)
    in the dtype of `x`. The weights go to the kernel in f32 HWIO, rounded
    to the compute dtype as the unfused conv rounds them."""
    return _launch_unit(*_UNITS[unit], x, p, unit)


def stem_unit_a_cuda_cores(x: torch.Tensor, p: UnitParams) -> torch.Tensor:
    """K5 on its CUDA-core kernel (csrc/stem_fwd.cu), f32 or bf16, CUDA
    tensors only: the bf16 design that the tensor-core kernel replaced,
    kept to compare the two on the card."""
    return _launch_unit(_UNIT_A_CUDA_CORES, 3, 16, x, p, "a")


def stem_unit_a_bf16_info() -> dict:
    """What the build and the runtime made of K5's bf16 kernel
    (csrc/stem_unit_a_mma.cu): registers and local memory per thread,
    static shared memory per block, resident blocks per SM."""
    return _bf16_info("b2f_stem_unit_a_bf16_info")


def stem_unit_b_bf16_info() -> dict:
    """The same for K6's bf16 kernel (csrc/stem_unit_b_mma.cu), whose
    shared memory is dynamic."""
    return _bf16_info("b2f_stem_unit_b_bf16_info")


def _stem_kernels(x: torch.Tensor, *params: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5, then K6 on its output: `b2f::stem`'s CUDA implementation."""
    f2 = stem_unit_cuda(x, params[:4], "a")
    return f2, stem_unit_cuda(f2, params[4:], "b")


def _stem_fake(x, *params):
    n, h, w = x.shape[:3]
    f2 = x.new_empty((n, (h + 1) // 2, (w + 1) // 2, 16))
    return f2, x.new_empty((n, (h + 3) // 4, (w + 3) // 4, 32))


class _StemGrad(torch.autograd.Function):
    """`b2f::stem`'s Autograd kernel (`register_function`): the op below
    autograd; backward as `_stem_bwd`, the twin chain recomputed from x
    and differentiated."""

    @staticmethod
    def forward(ctx, x, *params):
        ctx.save_for_backward(x, *params)
        return below_autograd(torch.ops.b2f.stem.default, x, *params)

    @staticmethod
    def backward(ctx, g2, g3):
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, ctx.needs_input_grad)]
        with torch.enable_grad():
            f2, f3 = stem_reference(inputs[0], inputs[1:5], inputs[5:])
            grads = iter(torch.autograd.grad((f2, f3), [t for t in inputs if t.requires_grad],
                                             (g2, g3)))
        return tuple(next(grads) if t.requires_grad else None for t in inputs)


_STEM = define("stem", "(Tensor x, Tensor w1a, Tensor b1a, Tensor w2a, Tensor b2a, Tensor w1b, "
                       "Tensor b1b, Tensor w2b, Tensor b2b) -> (Tensor, Tensor)",
               lambda x, *p: stem_reference(x, p[:4], p[4:]), _stem_kernels, _stem_fake)
register_function("stem", _StemGrad)


def fused_stem(x: torch.Tensor, unit2: torch.nn.Module, unit3: torch.nn.Module
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Levels 2 and 3 of the pyramid, (f2, f3) = (unit2(x), unit3(f2)),
    for (N, H, W, 3) NHWC frames; `unit2`/`unit3` are the net's ConvUnits
    (`feat_2`, `feat_3`), whose parameters receive the gradients. The
    caller checks `stem_eligible` first, as in the JAX package."""
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"fused_stem takes (N, H, W, 3) frames, got {tuple(x.shape)}")
    return _STEM(x.contiguous(), *unit_params(unit2), *unit_params(unit3))
