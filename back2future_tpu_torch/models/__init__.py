"""Torch modules of the port (counterpart of back2future_tpu.models)."""

from .bridge import load_flax_params, to_flax_params
from .layers import Conv, ConvUnit, Decoder, leaky_relu
from .pwc import PWCConfig, PWCNet, pwc_config_from_options

__all__ = [
    "Conv",
    "ConvUnit",
    "Decoder",
    "leaky_relu",
    "PWCConfig",
    "PWCNet",
    "pwc_config_from_options",
    "load_flax_params",
    "to_flax_params",
]
