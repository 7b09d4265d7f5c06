"""netType -> (model, config) dispatch (counterpart of
back2future_tpu/models/factory.py; model.lua:38-44's createModel switch).
One place so the train loop, checkpoint loading and the eval CLI agree on
which graph a set of Options describes.

Only the PWC family is ported; SPyNet is ROADMAP.md queue 1 item 10.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .pwc import PWCConfig, PWCNet, pwc_config_from_options

_SPYNET = "netType='spynet' is not ported yet (ROADMAP.md queue 1 item 10)"


def config_for_options(opt) -> PWCConfig:
    """The model config that `opt` describes, without building a module."""
    if opt.netType == "pwc":
        return pwc_config_from_options(opt)
    if opt.netType == "spynet":
        raise NotImplementedError(_SPYNET)
    raise ValueError(f"unknown netType {opt.netType!r} (pwc | spynet)")


def model_and_config(opt, generator: Optional[torch.Generator] = None
                     ) -> Tuple[PWCNet, PWCConfig]:
    """Build the module (on the CPU, weights drawn from `generator`) and
    its config for opt.netType."""
    cfg = config_for_options(opt)
    return PWCNet(cfg, generator=generator), cfg


def model_for_config(cfg, generator: Optional[torch.Generator] = None) -> PWCNet:
    """Rebuild the module that a restored config describes."""
    if isinstance(cfg, PWCConfig):
        return PWCNet(cfg, generator=generator)
    raise TypeError(f"unknown model config type {type(cfg).__name__}")
