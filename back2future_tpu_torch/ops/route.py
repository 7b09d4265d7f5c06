"""Where a kernel-backed op runs: its CUDA kernel or its plain torch twin.

One rule for every op: a CUDA tensor goes through the hand-written
kernel, a CPU tensor through the plain twin. `plain_ops()` is the one
exception, for comparing the two on the card; nothing on the serving or
training path enters it. An op that has a backward decides its route in
its forward and keeps it for the backward, which autograd runs on
another thread (where `plain_ops()`, a context variable, is not set).
Kernels are called on tensors inside `autograd.Function.forward` and
`backward`, where autograd records nothing.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes

import torch

_PLAIN = contextvars.ContextVar("b2f_plain_ops", default=False)

# dtype codes of the C interface (csrc/common.cuh, b2f::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@contextlib.contextmanager
def plain_ops():
    """Route CUDA tensors through the plain torch twins, not the kernels."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (outside `plain_ops()`), False on the CPU."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"back2future_tpu_torch ops run on cpu or cuda, "
                         f"got a tensor on {t.device}")
    return not _PLAIN.get()


def check_kernel_input(name: str, t: torch.Tensor, shape, dtype) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of `shape` and `dtype`
    (f32 or bf16)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: the kernel takes CUDA tensors, got one on {t.device}")
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{name}: dtype {t.dtype} not supported by the "
                        f"kernel (float32 or bfloat16)")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous (NHWC)")


def stream_ptr(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
