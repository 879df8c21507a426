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
]
