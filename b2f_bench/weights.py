"""Seeded weights, made on the device in a few large calls.

Every parameter is drawn as the reference networks initialise a conv
(torch nn.SpatialConvolution): uniform in +-1/sqrt(k * k * C_in), for
the weight and for the bias. All of them live in one flat float32
buffer drawn by one generator on the device; each parameter is a view
of it, in the order the reference's `param_shapes` gives.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict

import torch


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run, from the run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def _bounds(shapes: Dict[str, tuple]) -> Dict[str, float]:
    """Each parameter's init bound: its conv's 1/sqrt(k * k * C_in)."""
    out = {}
    for name, shape in shapes.items():
        conv = name.rsplit(".", 1)[0]
        _, c_in, kh, kw = shapes[conv + ".weight"]
        out[name] = 1.0 / math.sqrt(kh * kw * c_in)
    return out


def make_params(shapes: Dict[str, tuple], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for `shapes`, views of one buffer drawn
    from `seed`."""
    device = torch.device(device)
    counts = [math.prod(s) for s in shapes.values()]
    bounds = _bounds(shapes)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.rand(sum(counts), generator=gen, device=device).mul_(2).sub_(1)
    scale = torch.repeat_interleave(
        torch.tensor([bounds[n] for n in shapes], dtype=torch.float32, device=device),
        torch.tensor(counts, device=device))
    flat.mul_(scale)
    return {name: part.view(shape)
            for (name, shape), part in zip(shapes.items(), flat.split(counts))}


def bind(model: torch.nn.Module, params: Dict[str, torch.Tensor]) -> None:
    """Make each of `model`'s parameters the tensor of its name; the
    names and shapes must be the reference's."""
    mine = dict(model.named_parameters())
    if set(mine) != set(params):
        raise ValueError(f"the program's parameters differ from the reference's: "
                         f"{sorted(set(mine) ^ set(params))[:8]}")
    for name, p in mine.items():
        if tuple(p.shape) != tuple(params[name].shape):
            raise ValueError(f"{name}: program {tuple(p.shape)}, reference "
                             f"{tuple(params[name].shape)}")
        p.data = params[name]
