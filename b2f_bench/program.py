"""What the benchmark takes from the program under test, the PyTorch and
CUDA package `back2future_tpu_torch`: its options, its network on the
device with the benchmark's weights bound into it, its train step, and
the names and arguments of its kernel ops (`b2f::*`) as one call of the
timed entry dispatches them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from . import weights

OP_NAMESPACE = "b2f"


def options(cell):
    """The program's `Options` for the cell: its defaults, then the
    configuration's and the traffic mix's options."""
    from back2future_tpu_torch.config import Options

    fields = {f.name for f in dataclasses.fields(Options)}
    opts = cell.options
    unknown = sorted(set(opts) - fields)
    if unknown:
        raise ValueError(f"options the program does not have: {unknown}")
    return Options(**opts).derive()


def check_stem(cell) -> None:
    """The configuration states whether the fused stem runs; the program
    reads it from its environment."""
    from back2future_tpu_torch.ops.stem import stem_enabled

    if stem_enabled() != bool(cell.config.get("stem", False)):
        raise RuntimeError(f"the configuration states stem={cell.config.get('stem', False)}, "
                           f"the program's environment has it {stem_enabled()}")


def network(cell, opt, params: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """The program's network for `opt`, built on `device`, its parameters
    the tensors of `params` (names and shapes checked)."""
    from back2future_tpu_torch.models.factory import model_and_config

    check_stem(cell)
    with torch.device(device):
        net, _ = model_and_config(opt)
    weights.bind(net, params)
    return net


def train_step(net: torch.nn.Module, opt):
    """The program's train state over `net` and its train step."""
    from back2future_tpu_torch.losses import build_criterions
    from back2future_tpu_torch.train import create_train_state, make_train_step

    return create_train_state(net, opt), make_train_step(net, opt, build_criterions(opt))


def _describe(a):
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.element_size())
    return a


class OpRecorder(TorchDispatchMode):
    """Records each `b2f::*` call dispatched while it is active, with its
    arguments: tensors as (shape, element bytes), scalars as they are."""

    def __init__(self):
        super().__init__()
        self.calls: List[Tuple[str, list]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if getattr(func, "namespace", None) == OP_NAMESPACE:
            self.calls.append((func._opname, [_describe(a) for a in args]))
        return func(*args, **(kwargs or {}))


def record_ops(fn) -> List[Tuple[str, list]]:
    """The `b2f::*` calls that `fn()` makes, the backward's included."""
    with OpRecorder() as rec:
        fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return rec.calls
