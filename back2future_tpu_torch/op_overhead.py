"""Host cost of one cost-volume call by the way its autograd is registered.

    python -m back2future_tpu_torch.op_overhead [--cpu] [--turns 6] [--calls 300]

Times the host µs of one call, forward with autograd and forward +
backward (`out.sum().backward()`), of the cost volume at 1x8x16x32 bf16
(win 9), in turns, over the same three implementations (forward, d_ref,
d_frame), registered four ways:

  function    an `autograd.Function` calling the implementations directly
              (the port's design before its kernels were ops);
  op          a custom op whose Autograd kernel is an `autograd.Function`
              with `forward(ctx, ...)` that runs the op below autograd and
              calls the backward ops (`ops/route.py` `register_function`,
              what `b2f::cost_volume` does);
  op_setup    the same with a separate `setup_context`, which makes
              `Function.apply` bind its arguments by signature every call;
  generated   a custom op with `torch.library.register_autograd`.

On the card the implementations are the cost volume's kernels (K1, K2,
K3); with `--cpu` they are `torch.empty_like`, so that only the
registration's host work is timed. Prints the card's name and power
limit, then one line per way and measure: the median µs and each turn's.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

ARGS = (9, 1, True, 0.1)   # win, dilation, fwd, scale
_WAYS: dict = {}           # device -> the registered ways, one library a process


def _impls(device: str):
    """(forward, d_ref, d_frame) of the cost volume on `device`."""
    if device == "cuda":
        import importlib
        cv = importlib.import_module("back2future_tpu_torch.ops.cost_volume")
        return cv._fwd_kernel, cv._dref_kernel, cv._dframe_kernel

    def fwd(ref, frame, *args):
        return ref.new_empty((*ref.shape[:3], 81))
    return fwd, (lambda g, frame, *args: torch.empty_like(frame)), \
        (lambda g, ref, *args: torch.empty_like(ref))


def register(device: str) -> dict:
    """The four ways (module docstring) of calling the cost volume,
    registered once a process."""
    if device in _WAYS:
        return _WAYS[device]
    fwd, dref, dframe = _impls(device)
    key = device.upper()
    lib = torch.library.Library(f"b2f_overhead_{device}", "DEF")
    schema = "(Tensor {}, Tensor {}, int win, int dilation, bool fwd, float scale) -> Tensor"
    for name, impl, args in (("dref", dref, ("g", "frame")), ("dframe", dframe, ("g", "ref"))):
        lib.define(name + schema.format(*args))
        lib.impl(name, impl, key)
    ns = getattr(torch.ops, f"b2f_overhead_{device}")

    def backward_ops(ctx, g):
        ref, frame = ctx.saved_tensors
        g = g.to(ref.dtype).contiguous()
        return ns.dref.default(g, frame, *ctx.args), ns.dframe.default(g, ref, *ctx.args), \
            None, None, None, None

    class Function(torch.autograd.Function):
        @staticmethod
        def forward(ctx, ref, frame, *args):
            ctx.args = args
            ctx.save_for_backward(ref, frame)
            return fwd(ref, frame, *args)

        @staticmethod
        def backward(ctx, g):
            ref, frame = ctx.saved_tensors
            g = g.to(ref.dtype).contiguous()
            return dref(g, frame, *ctx.args), dframe(g, ref, *ctx.args), None, None, None, None

    def below(op, *args):
        with torch._C._AutoDispatchBelowAutograd():
            return op(*args)

    def setup(ctx, inputs, output):
        ref, frame, *args = inputs
        ctx.args = args
        ctx.save_for_backward(ref, frame)

    class Own(torch.autograd.Function):
        @staticmethod
        def forward(ctx, ref, frame, *args):
            ctx.args = args
            ctx.save_for_backward(ref, frame)
            return below(ns.own.default, ref, frame, *args)

        backward = staticmethod(backward_ops)

    class OwnSetup(torch.autograd.Function):
        @staticmethod
        def forward(ref, frame, win, dilation, fwd_, scale):
            return below(ns.own_setup.default, ref, frame, win, dilation, fwd_, scale)

        setup_context = staticmethod(setup)
        backward = staticmethod(backward_ops)

    for name, function in (("own", Own), ("own_setup", OwnSetup), ("generated", None)):
        lib.define(name + schema.format("ref", "frame"))
        lib.impl(name, fwd, key)
        if function is None:
            torch.library.register_autograd(f"b2f_overhead_{device}::{name}", backward_ops,
                                            setup_context=setup, lib=lib)
            continue

        def autograd(*args, function=function, op=getattr(ns, name).default):
            if torch.is_grad_enabled() and any(
                    isinstance(a, torch.Tensor) and a.requires_grad for a in args):
                return function.apply(*args)
            return below(op, *args)
        lib.impl(name, autograd, "Autograd")
    _WAYS[device] = {"function": Function.apply, "op": ns.own.default,
                     "op_setup": ns.own_setup.default, "generated": ns.generated.default,
                     "library": lib}
    return _WAYS[device]


def host_us(fn, calls: int, device: str) -> float:
    """Mean host µs of `fn` over `calls` calls, ending in a synchronise."""
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    for _ in range(20):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--cpu", action="store_true", help="trivial implementations on the CPU")
    p.add_argument("--turns", type=int, default=6)
    p.add_argument("--calls", type=int, default=300)
    a = p.parse_args(argv)
    device = "cpu" if a.cpu else "cuda"
    if device == "cuda":
        from .runtime import cuda_build
        cuda_build.build()
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip(), f"torch {torch.__version__}")
    else:
        torch.set_num_threads(1)
        print(f"cpu, torch {torch.__version__}")
    ways = register(device)
    gen = torch.Generator(device=device).manual_seed(0)
    ref, frame = (torch.randn((1, 8, 16, 32), generator=gen, device=device)
                  .to(torch.bfloat16).requires_grad_() for _ in range(2))
    cases = {}
    for way in ("function", "op", "op_setup", "generated"):
        call = ways[way]
        cases[f"{way} forward"] = lambda call=call: call(ref, frame, *ARGS)
        cases[f"{way} forward+backward"] = \
            lambda call=call: call(ref, frame, *ARGS).sum().backward()
    times = {k: [] for k in cases}
    for turn in range(a.turns):
        for k, fn in (cases.items() if turn % 2 == 0 else reversed(cases.items())):
            times[k].append(host_us(fn, a.calls, device))
    for k, v in times.items():
        print(f"{k}: median {statistics.median(v):.1f} µs a call "
              f"({' / '.join(f'{x:.1f}' for x in v)})")
    return {k: statistics.median(v) for k, v in times.items()}


if __name__ == "__main__":
    main()
