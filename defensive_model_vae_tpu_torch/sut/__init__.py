"""SUT write-back: tracked trajectories into their source episode CSVs.

Port of ``defensive_model_vae_tpu/sut``, with the same ``__all__``.
"""

from .writeback import (
    parse_tracked_npy_name,
    expected_csv_name,
    compute_ego_kinematics,
    merge_trajectory_into_csv,
    find_best_start_row,
    writeback_npy_to_csv,
)

__all__ = [
    "parse_tracked_npy_name",
    "expected_csv_name",
    "compute_ego_kinematics",
    "merge_trajectory_into_csv",
    "find_best_start_row",
    "writeback_npy_to_csv",
]
