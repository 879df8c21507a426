"""Host-side data layer: CARLA episode CSVs → training windows, start
conditions and human tracks, without pandas (``csv_io.Frame`` over the
native loader)."""

from .windows import (
    process_csv,
    iter_windows,
    collect_trajectories,
    save_windows,
    generate_random_trajectories,
    build_dataset,
)
from .conditions import (
    StartConditions,
    get_start_conditions,
    get_human_and_bv_trajectories,
    align_model_trajectory,
    trim_human_trajectory,
    collect_csv_files,
)

__all__ = [
    "process_csv",
    "iter_windows",
    "collect_trajectories",
    "save_windows",
    "generate_random_trajectories",
    "build_dataset",
    "StartConditions",
    "get_start_conditions",
    "get_human_and_bv_trajectories",
    "align_model_trajectory",
    "trim_human_trajectory",
    "collect_csv_files",
]
