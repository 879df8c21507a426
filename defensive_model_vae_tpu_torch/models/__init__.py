from .cvae import (
    CVAEConfig,
    decode,
    encode,
    encode_condition,
    forward,
    init_params,
    reparameterize,
    sample,
    to_relative,
)
from .conv_cvae import (
    ConvCVAEConfig,
    conv_decode,
    conv_encode,
    conv_forward,
    conv_sample,
    init_conv_params,
)
from .losses import LossWeights, cvae_loss

__all__ = [
    "CVAEConfig",
    "decode",
    "encode",
    "encode_condition",
    "forward",
    "init_params",
    "reparameterize",
    "sample",
    "to_relative",
    "LossWeights",
    "cvae_loss",
    "ConvCVAEConfig",
    "conv_decode",
    "conv_encode",
    "conv_forward",
    "conv_sample",
    "init_conv_params",
]
