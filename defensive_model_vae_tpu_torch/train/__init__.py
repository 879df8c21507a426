from .checkpoint import (
    load_checkpoint,
    params_from_numpy,
    params_to_numpy,
    require_cvae_config,
    save_checkpoint,
)
from .train import TrainConfig, train

__all__ = [
    "TrainConfig",
    "train",
    "load_checkpoint",
    "params_from_numpy",
    "params_to_numpy",
    "require_cvae_config",
    "save_checkpoint",
]
