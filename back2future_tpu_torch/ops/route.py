"""The port's kernel ops: their `torch.library` registration and route.

Every kernel entry point on a path is a custom op in the `b2f`
namespace (`torch.ops.b2f.<name>`), defined with `Library.define` and
given three implementations by `define`:

  CPU   the plain torch twin;
  CUDA  the hand-written kernel, launched through ctypes on the tensors'
        data pointers and the current stream (runtime.cuda_build); a
        failed build or launch raises, never falls back to the twin;
  fake  the output's shape and dtype, for FakeTensor tracing
        (torch.export, opcheck), where no data pointer exists.

An op with a backward gets an Autograd kernel from `register_function`:
an `autograd.Function`, in its own module, whose forward runs the op
below autograd and whose backward calls the backward ops. It does what
`torch.library.register_autograd` does with less host work a call (no
default-argument filling or key-set bookkeeping in Python; the train
steps are host-bound). An exported program (api.FlowEstimator.export)
keeps the ops as graph nodes, so loading one needs this package's ops
imported.

One rule routes every op: a CUDA tensor goes through the kernel, a CPU
tensor through the twin. `plain_ops()` is the one exception, for
comparing the two on the card: inside it an op's CUDA implementation
runs the twin. Nothing on the serving or training path enters it. An op
with a backward fixes its route in the forward (its `setup_context`
reads `plain_active()`) and keeps it for the backward, which autograd
runs on another thread (where `plain_ops()`, a context variable, is not
set): the plain route's backward is the twins' backward, never autograd
through the twin's forward.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
from typing import Callable

import torch

_PLAIN = contextvars.ContextVar("b2f_plain_ops", default=False)

# dtype codes of the C interface (csrc/common.cuh, b2f::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

LIB = torch.library.Library("b2f", "DEF")


@contextlib.contextmanager
def plain_ops():
    """Route CUDA tensors through the plain torch twins, not the kernels."""
    token = _PLAIN.set(True)
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_active() -> bool:
    """True inside `plain_ops()` on this thread."""
    return _PLAIN.get()


def use_kernel(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (outside `plain_ops()`), False on the CPU."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"back2future_tpu_torch ops run on cpu or cuda, "
                         f"got a tensor on {t.device}")
    return not _PLAIN.get()


def define(name: str, schema: str, twin: Callable, kernel: Callable,
           fake: Callable) -> torch._ops.OpOverload:
    """Define `b2f::<name><schema>` with `twin` on the CPU, `kernel` on
    CUDA (the twin inside `plain_ops()`) and `fake` for tracing; return
    its overload, `torch.ops.b2f.<name>.default`."""
    def cuda(*args):
        return twin(*args) if _PLAIN.get() else kernel(*args)

    LIB.define(name + schema)
    LIB.impl(name, twin, "CPU")
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"b2f::{name}", fake, lib=LIB)
    return getattr(torch.ops.b2f, name).default


def below_autograd(op: torch._ops.OpOverload, *args):
    """`op(*args)` dispatched past the Autograd key: an op's Function
    forward runs its CPU, CUDA or fake implementation through this."""
    with torch._C._AutoDispatchBelowAutograd():
        return op(*args)


def register_function(name: str, function: type) -> None:
    """Register `function` as `b2f::<name>`'s Autograd kernel: its
    `apply` where grad mode is on and a tensor argument requires grad,
    else the op below autograd. `function.forward(ctx, *args)` saves what
    its backward needs and returns `below_autograd(op, *args)`."""
    op = getattr(torch.ops.b2f, name).default

    def autograd(*args):
        if torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad for a in args):
            return function.apply(*args)
        return below_autograd(op, *args)

    LIB.impl(name, autograd, "Autograd")


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
