"""Torch modules of the port (counterpart of back2future_tpu.models)."""

from .bridge import load_flax_params, to_flax_params
from .layers import Conv, ConvUnit, Decoder, leaky_relu
from .pwc import PWCConfig, PWCNet, pwc_config_from_options
from .spynet import SPyNet, SPyNetConfig, spynet_config_from_options
from .surgery import convert_hard_to_soft, convert_net_hard_to_soft

__all__ = [
    "Conv",
    "ConvUnit",
    "Decoder",
    "leaky_relu",
    "PWCConfig",
    "PWCNet",
    "pwc_config_from_options",
    "SPyNet",
    "SPyNetConfig",
    "spynet_config_from_options",
    "load_flax_params",
    "to_flax_params",
    "convert_hard_to_soft",
    "convert_net_hard_to_soft",
]
