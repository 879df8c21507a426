from .fused_scale import fused_scale_reference, fused_train_scale, fused_train_scale_dp
from .fused_trainer import (FUSED_METRIC_KEYS, fused_call, fused_train, fused_train_multi,
                            fused_train_seeds)

__all__ = ["FUSED_METRIC_KEYS", "fused_call", "fused_scale_reference", "fused_train",
           "fused_train_multi", "fused_train_scale", "fused_train_scale_dp",
           "fused_train_seeds"]
