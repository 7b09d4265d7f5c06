"""Params bridge between the flax param tree and the torch modules.

The JAX package's params are a nested dict keyed by flax module names:
`feat_{l}/c{0,1}/conv/{kernel,bias}` and
`{flow,occ,past}_decoder_{l}/{c0..c4,out}/conv/{kernel,bias}`
(back2future_tpu/models/pwc.py, models/layers.py). The torch modules use
the same names without the `conv` level: `feat_{l}.c0.weight`. Kernels
are HWIO in flax and OIHW in torch. Values cross as numpy arrays, so the
bridge needs neither jax nor flax.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

_TO_TORCH = {"kernel": "weight", "bias": "bias"}
_TO_FLAX = {v: k for k, v in _TO_TORCH.items()}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _flax_path_to_torch(path: tuple) -> str:
    """('feat_2', 'c0', 'conv', 'kernel') -> 'feat_2.c0.weight'."""
    if len(path) < 2 or path[-2] != "conv" or path[-1] not in _TO_TORCH:
        raise KeyError(f"not a conv param path: {'/'.join(path)}")
    return ".".join(path[:-2] + (_TO_TORCH[path[-1]],))


def flax_to_torch_names(tree: Mapping) -> Dict[str, np.ndarray]:
    """A flax-named tree (nested dict of arrays, optionally under a
    top-level "params" key) as torch parameter names -> float32 numpy
    arrays, kernels HWIO -> OIHW. The one name and layout map of the
    bridge: params and optimiser moments (train/checkpoint.py) cross by it."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out = {}
    for path, value in _flatten(tree).items():
        name = _flax_path_to_torch(path)
        value = np.asarray(value, np.float32)
        if name.endswith(".weight"):
            value = value.transpose(3, 2, 0, 1)   # HWIO -> OIHW
        out[name] = np.ascontiguousarray(value)
    return out


def check_names(module: nn.Module, flat: Mapping[str, np.ndarray]) -> Dict[str, nn.Parameter]:
    """`module`'s parameters by name, after checking that `flat` (torch
    names -> arrays) holds each of them once, at its shape: KeyError on a
    missing or extra entry, ValueError on a shape mismatch."""
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(flat))
    extra = sorted(set(flat) - set(params))
    if missing or extra:
        raise KeyError(f"flax tree does not match the module: missing "
                       f"{missing}, extra {extra}")
    for name, value in flat.items():
        if value.shape != tuple(params[name].shape):
            raise ValueError(f"{name}: flax shape {value.shape} does not match "
                             f"torch shape {tuple(params[name].shape)}")
    return params


def load_flax_params(module: nn.Module, tree: Mapping) -> None:
    """Copy a flax param tree (nested dict of arrays, optionally under a
    top-level "params" key) into `module`'s parameters, in place.

    Raises KeyError on a missing or extra entry and ValueError on a
    shape mismatch; nothing is copied unless every entry matches."""
    flat = flax_to_torch_names(tree)
    params = check_names(module, flat)
    with torch.no_grad():
        for name, value in flat.items():
            params[name].copy_(torch.from_numpy(value))


def to_flax_params(module: nn.Module) -> Dict[str, Any]:
    """The inverse of `load_flax_params`: a nested dict of float32 numpy
    arrays with flax names and HWIO kernels."""
    tree: Dict[str, Any] = {}
    for name, p in module.named_parameters():
        *mods, leaf = name.split(".")
        value = p.detach().cpu().float().numpy()
        if leaf == "weight":
            value = value.transpose(2, 3, 1, 0)   # OIHW -> HWIO
        node = tree
        for m in mods + ["conv"]:
            node = node.setdefault(m, {})
        node[_TO_FLAX[leaf]] = np.ascontiguousarray(value)
    return tree
