"""netType -> (model, config) dispatch (counterpart of
back2future_tpu/models/factory.py; model.lua:38-44's createModel switch).
One place so the train loop, checkpoint loading and the eval CLI agree on
which graph a set of Options describes: `PWCNet` for "pwc", `SPyNet` for
"spynet".
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .pwc import PWCConfig, PWCNet, pwc_config_from_options
from .spynet import SPyNet, SPyNetConfig, spynet_config_from_options

ModelConfig = Union[PWCConfig, SPyNetConfig]
Model = Union[PWCNet, SPyNet]


def config_for_options(opt) -> ModelConfig:
    """The model config that `opt` describes, without building a module."""
    if opt.netType == "pwc":
        return pwc_config_from_options(opt)
    if opt.netType == "spynet":
        return spynet_config_from_options(opt)
    raise ValueError(f"unknown netType {opt.netType!r} (pwc | spynet)")


def model_and_config(opt, generator: Optional[torch.Generator] = None
                     ) -> Tuple[Model, ModelConfig]:
    """Build the module (on the CPU, weights drawn from `generator`) and
    its config for opt.netType."""
    cfg = config_for_options(opt)
    return model_for_config(cfg, generator=generator), cfg


def model_for_config(cfg, generator: Optional[torch.Generator] = None) -> Model:
    """Rebuild the module that a restored config describes."""
    if isinstance(cfg, PWCConfig):
        return PWCNet(cfg, generator=generator)
    if isinstance(cfg, SPyNetConfig):
        return SPyNet(cfg, generator=generator)
    raise TypeError(f"unknown model config type {type(cfg).__name__}")
