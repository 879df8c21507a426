"""CSV condition / trajectory extraction (host side).

Port of ``defensive_model_vae_tpu/data/conditions.py`` over the port's
column table (``csv_io.Frame``), with the same semantics bit for bit.
Behavioral re-implementation of reference ``Tools.py:69-256`` and
``Distribution.py:22-48,213-245``: start conditions for generation,
human/background-vehicle track extraction, model-track time alignment, and
the per-scenario human-track trimming used before velocity statistics.
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .. import scenarios
from .csv_io import read_csv


@dataclasses.dataclass(frozen=True)
class StartConditions:
    x: float
    y: float
    angle: float  # radians
    vx: float
    vy: float

    def as_state(self) -> np.ndarray:
        """[x, y, theta, vx, vy] initial state for the tracker."""
        return np.array([self.x, self.y, self.angle, self.vx, self.vy])


def get_start_conditions(
    csv_path: str, scenario: "scenarios.Scenario | str"
) -> StartConditions:
    """First row satisfying the scenario start mask → start state.

    Mirrors reference ``Tools.get_start_conditions_from_csv`` (``:69-134``)
    including the hardcoded per-scenario fallbacks when no row matches or the
    file is unreadable (fallback vx/vy are 0 — the reference returns only
    3 values in that case and callers unpack 5, crashing; we fix that latent
    defect by always returning 5, see SURVEY §5).

    "Unreadable" is a missing file, one the loader refuses, or a missing
    column; a loader that does not build still raises.
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    fx, fy, fa = sce.start_fallback
    try:
        df = read_csv(csv_path)
        hits = np.flatnonzero(np.asarray(sce.start_condition_mask(df)))
        if not len(hits):
            return StartConditions(fx, fy, fa, 0.0, 0.0)
        row = df.row(int(hits[0]))
        return StartConditions(
            row["ego_x"],
            row["ego_y"],
            row["ego_yaw"] * np.pi / 180.0,
            row["ego_vx"],
            row["ego_vy"],
        )
    except (OSError, ValueError, KeyError):
        return StartConditions(fx, fy, fa, 0.0, 0.0)


def get_human_and_bv_trajectories(
    csv_path: str, scenario: "scenarios.Scenario | str"
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
    """Extract human ego track and background-vehicle tracks as [x, y, t].

    Mirrors reference ``Tools.get_human_and_bv_trajectories`` (``:138-214``):
    slice rows between the first start-mask hit and the first end-mask hit
    (end row included; file end if no hit), synthesize time as
    ``arange(len) * dt``.  sce4 returns a single background vehicle.
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    df = read_csv(csv_path)

    start_hits = np.flatnonzero(np.asarray(sce.human_start_mask(df)))
    if not len(start_hits):
        return None, None, None
    start_idx = int(start_hits[0])

    # the end search starts AT the start row; the JAX package's
    # ``df.loc[start_idx:end_idx]`` includes the end row
    df_after = df.rows(start_idx)
    end_hits = np.flatnonzero(np.asarray(sce.human_end_mask(df_after)))
    end_idx = start_idx + int(end_hits[0]) if len(end_hits) else len(df) - 1
    if start_idx >= end_idx:
        return None, None, None

    seg = df.rows(start_idx, end_idx + 1)
    time_column = np.arange(len(seg)) * sce.dt

    human = np.column_stack((seg[["ego_x", "ego_y"]], time_column))
    bv1 = np.column_stack((seg[["sv1_x", "sv1_y"]], time_column))
    if sce.n_background_vehicles >= 2:
        bv2 = np.column_stack((seg[["sv2_x", "sv2_y"]], time_column))
    else:
        bv2 = None
    return human, bv1, bv2


def align_model_trajectory(
    human_traj: np.ndarray,
    start_x: float,
    start_y: float,
    model_states: np.ndarray,
    time_step: float,
) -> Optional[np.ndarray]:
    """Attach human-timeline times to the tracked model states.

    Mirrors reference ``Tools.process_model_trajectory`` (``:219-256``): find
    the human row that exactly matches the start point, take the human times
    from there, truncate or linearly extend to match the model length.
    Returns [x, y, t] rows.
    """
    model_coord = model_states[:, :2]
    hit = np.flatnonzero(
        (human_traj[:, 0] == start_x) & (human_traj[:, 1] == start_y)
    )
    if len(hit) == 0:
        return None
    times = human_traj[hit[0]:, 2]
    n_coord, n_time = model_coord.shape[0], times.shape[0]
    if n_time > n_coord:
        times = times[:n_coord]
    elif n_time < n_coord:
        last = times[-1] if n_time > 0 else 0.0
        extra = last + time_step * np.arange(1, n_coord - n_time + 1)
        times = np.concatenate([times, extra])
    return np.column_stack((model_coord, times))


def trim_human_trajectory(
    human_traj: np.ndarray, scenario: "scenarios.Scenario | str"
) -> np.ndarray:
    """Per-scenario trimming applied before velocity statistics.

    Mirrors reference ``Distribution.load_human_trajectories`` (``:228-244``):
    sce1 splices masked (x, y) rows with the *first* len(masked) time values;
    the other scenarios drop rows before the first mask hit (or keep all when
    nothing matches).
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    mask = sce.human_trim_mask(human_traj)
    if sce.human_trim_mode == "sce1_splice":
        xy = human_traj[mask][:, [0, 1]]
        t = human_traj[: len(xy), [2]]
        return np.hstack((xy, t))
    first = int(np.argmax(mask)) if np.any(mask) else 0
    return human_traj[first:]


def collect_csv_files(
    base_folder: str, actions: Sequence[str] = scenarios.ACTIONS
) -> List[str]:
    """All CSVs under the maneuver subfolders of one scenario folder
    (reference ``Distribution.collect_csv_files``, ``:22-48``)."""
    csv_files: List[str] = []
    for sub in actions:
        folder = os.path.join(base_folder, sub)
        if os.path.exists(folder):
            csv_files.extend(sorted(glob.glob(os.path.join(folder, "*.csv"))))
    return csv_files
