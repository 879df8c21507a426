"""Validation metrics (host numpy and scipy), ported from
``defensive_model_vae_tpu/metrics``, with the same ``__all__``: the
distribution, spatial and THW metrics, and the surrogate safety metrics
(TTC, PET, jerk) over SUT episodes.
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
from .surrogate import (
    slice_episode,
    ttc_1d,
    pet_rays,
    jerk,
    compute_metric,
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
    "slice_episode",
    "ttc_1d",
    "pet_rays",
    "jerk",
    "compute_metric",
    "start_velocities",
    "thw_values",
]
