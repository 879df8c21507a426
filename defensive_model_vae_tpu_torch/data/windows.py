"""Trajectory-window dataset builder.

Port of ``defensive_model_vae_tpu/data/windows.py`` over the port's column
table (``csv_io.Frame``) instead of pandas, with the same semantics bit for
bit.  Behavioral re-implementation of the reference extraction pipeline
(``Traj_Data_Process.py:72-151``): scan each CARLA CSV log for the scenario's
start/end predicates, slice the ego track, subsample to a fixed number of
points at equal index spacing, and synthesize the time column.  Output is a
``(N, target_points, 3)`` float array of ``[t, x, y]`` windows.

This layer is host-side (numpy); arrays it produces are fed to the device
as one batch (the full corpus fits trivially in device memory).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from .. import scenarios
from .csv_io import read_csv


def process_csv(
    csv_path: str,
    scenario: "scenarios.Scenario | str",
    target_points: int = 10,
    point_mode: str = "normal",
    time_interval: Optional[float] = None,
    dataset_variant: str = "shipped",
) -> Optional[np.ndarray]:
    """Extract one ``(target_points, 3)`` [t, x, y] window from a CSV log.

    Mirrors reference ``Traj_Data_Process.process_csv`` (``:72-122``):
    - first row satisfying the scenario start predicate opens the window
    - the first subsequent row satisfying the end predicate closes it
      (exclusive), scanning strictly after the start row
    - equal-interval integer index subsampling including both endpoints
    - ``extend_mid`` mode replaces interior samples by ceil-midpoints
    - time column: ``arange(P) * time_interval * (len(window)-1)/(P-1)``

    ``time_interval=None`` (the default) resolves the SCENARIO's registered
    ``dt`` — per-scenario constants live in the registry, never as literal
    defaults here (CLAUDE.md; the reference hand-sets 0.02/0.025/0.015/0.02
    per scenario, ``Traj_Data_Process.py:165-166``).

    ``dataset_variant``: "shipped" uses the in-tree Traj_Data_Process
    predicate (reproduces the shipped npy datasets); "artifact" uses the
    predicate the published results were trained with where it differs
    (``Scenario.artifact_dataset_start`` — currently sce1's ego_y>=40).
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    if time_interval is None:
        time_interval = sce.dt
    if dataset_variant not in ("shipped", "artifact"):
        # the shipped/artifact fork IS the stale-predicate quirk this
        # parameter selects — a typo must not silently pick "shipped"
        raise ValueError(f"unknown dataset_variant: {dataset_variant!r}")
    df = read_csv(csv_path)

    start_pred = sce.dataset_start
    if dataset_variant == "artifact" and sce.artifact_dataset_start is not None:
        start_pred = sce.artifact_dataset_start
    start_mask = np.asarray(start_pred(df))
    start_hits = np.flatnonzero(start_mask)
    if len(start_hits) == 0:
        return None
    start_idx = int(start_hits[0])

    sub_df = df.rows(start_idx)
    # end row = first hit strictly after the start row, evaluated over the
    # whole tail at once (the registry predicates apply elementwise); the
    # JAX package's ``sub_df.loc[: end_label - 1]`` keeps the rows from the
    # start up to the end row, which is excluded
    tail = sub_df.rows(1)
    if len(tail):
        end_hits = np.flatnonzero(np.asarray(sce.dataset_end_row(tail)))
        if len(end_hits):
            sub_df = sub_df.rows(0, 1 + int(end_hits[0]))  # end row excluded

    if "ego_x" not in sub_df or "ego_y" not in sub_df:
        return None
    traj = sub_df[["ego_x", "ego_y"]]
    if len(traj) < target_points:
        return None

    indices = np.linspace(0, len(traj) - 1, target_points, dtype=int)
    if point_mode == "normal":
        sampled = traj[indices]
    elif point_mode == "extend_mid":
        mids = np.ceil((indices[:-1] + indices[1:]) / 2).astype(int)
        idx_new = np.append(np.insert(mids[:-1], 0, indices[0]), indices[-1])
        sampled = traj[idx_new]
    else:
        raise ValueError(f"unknown point_mode: {point_mode!r}")

    times = (
        np.arange(target_points)
        * time_interval
        * ((len(sub_df) - 1) / (target_points - 1))
    )
    return np.column_stack((times, sampled))


def iter_windows(
    data_root: str,
    scenario: "scenarios.Scenario | str",
    actions: Sequence[str] = scenarios.DATASET_ACTIONS,
    target_points: int = 10,
    point_mode: str = "normal",
    time_interval: Optional[float] = None,
    dataset_variant: str = "shipped",
):
    """Yield ``(csv_filename, window)`` for one scenario, in the canonical
    enumeration order (action order of the dataset ``__main__``,
    lexicographically sorted per-folder files).

    The SINGLE walker behind both :func:`collect_trajectories` (windows)
    and ``features.window_trial_suffixes`` (per-window provenance): the
    two must enumerate identically for suffix↔window row alignment, so
    the loop exists exactly once.
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    scene_path = os.path.join(data_root, sce.town)
    for action in actions:
        action_path = os.path.join(scene_path, action)
        if not os.path.exists(action_path):
            continue
        for fname in sorted(os.listdir(action_path)):
            if not fname.endswith(".csv"):
                continue
            traj = process_csv(
                os.path.join(action_path, fname),
                sce,
                target_points,
                point_mode,
                time_interval,
                dataset_variant,
            )
            if traj is not None and len(traj) == target_points:
                yield fname, traj


def collect_trajectories(
    data_root: str,
    scenario_keys: Sequence[str],
    actions: Sequence[str] = scenarios.DATASET_ACTIONS,
    target_points: int = 10,
    point_mode: str = "normal",
    time_interval: Optional[float] = None,
    dataset_variant: str = "shipped",
) -> List[np.ndarray]:
    """Walk ``data_root/<town>/<action>/*.csv`` and extract all windows.

    Mirrors reference ``Traj_Data_Process.collect_trajectories`` (``:125-141``)
    under the dataset ``__main__``'s action order (``:162``) with
    lexicographically sorted per-folder files — the effective enumeration
    the shipped npy artifacts were generated with (the reference's bare
    ``os.listdir`` returned sorted names on its NTFS filesystem), proven by
    the row-for-row byte-exact parity test.  ``time_interval=None``
    resolves each scenario's registered ``dt`` (see :func:`process_csv`).
    """
    all_trajs: List[np.ndarray] = []
    for key in scenario_keys:
        all_trajs.extend(
            w for _, w in iter_windows(
                data_root, key, actions, target_points, point_mode,
                time_interval, dataset_variant,
            )
        )
    return all_trajs


def build_dataset(
    data_root: str,
    scenario_key: str,
    target_points: int = 10,
    point_mode: str = "normal",
    time_interval: Optional[float] = None,
    dataset_variant: str = "shipped",
) -> np.ndarray:
    """Build the ``(N, P, 3)`` float32 window array for one scenario.

    Uses the scenario's registered ``dt`` when ``time_interval`` is omitted
    (the reference hand-sets 0.02/0.025/0.015/0.02 per scenario,
    ``Traj_Data_Process.py:165-166``).  ``dataset_variant="artifact"``
    selects the published-artifact extraction predicate where it differs
    from the shipped one (see :func:`process_csv`).
    """
    sce = scenarios.get(scenario_key)
    dt = sce.dt if time_interval is None else time_interval
    if point_mode == "extend_mid":
        trajs = collect_trajectories(
            data_root, [sce.key], scenarios.DATASET_ACTIONS, target_points,
            "normal", dt, dataset_variant,
        ) + collect_trajectories(
            data_root, [sce.key], scenarios.DATASET_ACTIONS, target_points,
            "extend_mid", dt, dataset_variant,
        )
    else:
        trajs = collect_trajectories(
            data_root, [sce.key], scenarios.DATASET_ACTIONS, target_points,
            point_mode, dt, dataset_variant,
        )
    if not trajs:
        raise RuntimeError(f"no trajectories extracted for {scenario_key}")
    return np.asarray(trajs, dtype=np.float32)


def save_windows(trajs: Sequence[np.ndarray], save_path: str) -> np.ndarray:
    """Stack and save windows (reference ``pad_and_save``, ``:144-151``)."""
    arr = np.asarray(trajs)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    np.save(save_path, arr)
    return arr


def generate_random_trajectories(
    num_trajs: int,
    traj_length: int,
    max_angle_deviation: float = 5.0,
    seed: Optional[int] = None,
) -> np.ndarray:
    """Unit-step random-walk trajectories (reference ``:31-69``), vectorized.

    Heading performs a bounded random walk; positions are the cumulative sum
    of unit steps.  Returns ``(num_trajs, traj_length, 2)``.
    """
    rng = np.random.default_rng(seed) if seed is not None else np.random.default_rng()
    max_rad = np.radians(max_angle_deviation)
    dtheta = rng.uniform(-max_rad, max_rad, size=(num_trajs, traj_length - 1))
    angles = np.cumsum(dtheta, axis=1)
    steps = np.stack([np.cos(angles), np.sin(angles)], axis=-1)
    traj = np.zeros((num_trajs, traj_length, 2))
    traj[:, 1:] = np.cumsum(steps, axis=1)
    return traj
