from .checkpoint import (
    load_checkpoint,
    load_history,
    load_opt_state,
    params_from_numpy,
    params_to_numpy,
    require_cvae_config,
    save_checkpoint,
    save_opt_state,
)
from .train import TrainConfig, train, train_conditioned, train_conv, train_multi_scenario

__all__ = [
    "TrainConfig",
    "train",
    "train_conditioned",
    "train_conv",
    "train_multi_scenario",
    "load_checkpoint",
    "load_history",
    "load_opt_state",
    "params_from_numpy",
    "params_to_numpy",
    "require_cvae_config",
    "save_checkpoint",
    "save_opt_state",
]
