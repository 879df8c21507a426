from .device_reference import (
    build_reference_device,
    cubic_eval,
    make_serve_fn,
    notaknot_coeffs,
    select_valid_trajectory,
)
from .linear_mpc import LinearMPCConfig, simulate_tracking, sine_road_demo, solve_ltv_qp
from .mpc import MPCConfig, rollout, track, track_batch
from .reference import PathReference
from .sweep import SweepResult, sweep_horizons

__all__ = [
    "LinearMPCConfig",
    "MPCConfig",
    "PathReference",
    "build_reference_device",
    "cubic_eval",
    "make_serve_fn",
    "notaknot_coeffs",
    "rollout",
    "select_valid_trajectory",
    "simulate_tracking",
    "sine_road_demo",
    "solve_ltv_qp",
    "SweepResult",
    "sweep_horizons",
    "track",
    "track_batch",
]
