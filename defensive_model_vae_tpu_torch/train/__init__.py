from .checkpoint import (
    load_checkpoint,
    params_from_numpy,
    params_to_numpy,
    require_cvae_config,
    save_checkpoint,
)
from .train import TrainConfig, train, train_conditioned, train_multi_scenario

__all__ = [
    "TrainConfig",
    "train",
    "train_conditioned",
    "train_multi_scenario",
    "load_checkpoint",
    "params_from_numpy",
    "params_to_numpy",
    "require_cvae_config",
    "save_checkpoint",
]
