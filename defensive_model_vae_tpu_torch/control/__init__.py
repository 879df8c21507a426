from .device_reference import (
    build_reference_device,
    cubic_eval,
    make_serve_fn,
    notaknot_coeffs,
    select_valid_trajectory,
)
from .mpc import MPCConfig, rollout, track, track_batch
from .reference import PathReference

__all__ = [
    "MPCConfig",
    "PathReference",
    "build_reference_device",
    "cubic_eval",
    "make_serve_fn",
    "notaknot_coeffs",
    "rollout",
    "select_valid_trajectory",
    "track",
    "track_batch",
]
