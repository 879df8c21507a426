from .fused_trainer import FUSED_METRIC_KEYS, fused_call, fused_train

__all__ = ["FUSED_METRIC_KEYS", "fused_call", "fused_train"]
