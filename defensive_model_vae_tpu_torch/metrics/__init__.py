"""Validation metrics (host numpy and scipy), ported from
``defensive_model_vae_tpu/metrics``.  ``surrogate`` (TTC, PET, jerk over SUT
episodes) is not here: it comes with the SUT slice.
"""

from .distribution import (
    extract_velocities,
    human_velocities,
    velocity_js_divergence,
)
from .spatial import (
    subsample_points,
    extract_coordinates,
    rmse_frequency,
    rmse_frequency_trajcount,
    count_trajectories_per_grid,
    build_stv_surface,
    surface_rmse,
    spatiotemporal_plane_rmse,
    model_stv_data,
    human_stv_data,
)
from .thw import start_velocities, thw_values

__all__ = [
    "extract_velocities",
    "human_velocities",
    "velocity_js_divergence",
    "subsample_points",
    "extract_coordinates",
    "rmse_frequency",
    "rmse_frequency_trajcount",
    "count_trajectories_per_grid",
    "build_stv_surface",
    "surface_rmse",
    "spatiotemporal_plane_rmse",
    "model_stv_data",
    "human_stv_data",
    "start_velocities",
    "thw_values",
]
