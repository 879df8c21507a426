"""DNDA risk scoring (drivable area and risk level) of SUT episodes.

Port of ``defensive_model_vae_tpu/dnda``, with the same ``__all__``.
"""

from .spline import fmm_spline_coeffs, spline_eval, spline_curvature
from .frenet import cartesian_to_frenet, Way
from .geometry import Road, Vehicle, SurroundingVehicle
from .paths import generate_ego_cluster
from .collision import predict_surrounding_rectangles, collision_indices, sat_collision
from .risk import drivable_area, risk_level, shoelace_area
from .core import drivable_area_risk_level
from .calculator import DndaResult, process_episode, baseline_for, score_directory

__all__ = [
    "fmm_spline_coeffs",
    "spline_eval",
    "spline_curvature",
    "cartesian_to_frenet",
    "Way",
    "Road",
    "Vehicle",
    "SurroundingVehicle",
    "generate_ego_cluster",
    "predict_surrounding_rectangles",
    "collision_indices",
    "sat_collision",
    "drivable_area",
    "risk_level",
    "shoelace_area",
    "drivable_area_risk_level",
    "DndaResult",
    "process_episode",
    "baseline_for",
    "score_directory",
]
