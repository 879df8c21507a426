from .mpc import MPCConfig, rollout, track, track_batch
from .reference import PathReference

__all__ = ["MPCConfig", "PathReference", "rollout", "track", "track_batch"]
