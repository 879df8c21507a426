"""SUT write-back: inject tracked trajectories into their source CSVs.

Port of ``defensive_model_vae_tpu/sut/writeback.py`` without pandas.  It
re-implements ``SUT_Testing/Defensive_Testing.py``: parse the tracked-npy
name back to its source CSV, find the CSV row nearest the trajectory start,
derive ego kinematics (vx, vy, ax, ay, yaw°) from [x, y, theta, v] via
``np.gradient`` over the row clock, overwrite the ego columns from that row
on, and truncate the CSV tail if the trajectory is shorter.

An episode is a ``data.csv_io.Frame`` (every column float64, a non-numeric
field NaN, which is what ``pd.to_numeric(errors="coerce")`` gives), and the
merged episode is written by ``data.csv_io.write_csv``: each value its
shortest ``repr``, so it parses back to the same float64 values.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Tuple, Union

import numpy as np

from .. import scenarios
from ..data.csv_io import Frame, read_csv, write_csv

_EGO_COLS = ("ego_x", "ego_y", "ego_vx", "ego_vy", "ego_ax", "ego_ay", "ego_yaw")

# match any sce\d+, but validate the parsed key against the registry
# strictly: scenarios.get's substring fallback would resolve an unknown
# 'sce10' to sce1 and write back into the wrong town's CSV (the reference
# raises on unknown keys — Defensive_Testing.py:40-52)
_NPY_RE = re.compile(
    r"tracked_trajectory_(sce\d+)_exp(\d+)_(\d+)\.npy$", re.IGNORECASE
)


def parse_tracked_npy_name(filename: Union[str, Path]) -> Tuple[str, str, str]:
    """``tracked_trajectory_sce1_exp1_3.npy → ('sce1', '1', '3')``
    (reference ``:34-52``)."""
    name = os.path.basename(str(filename))
    m = _NPY_RE.match(name)
    if not m:
        raise ValueError(f"cannot parse tracked npy name: {name}")
    key = m.group(1).lower()
    if key not in scenarios.REGISTRY:
        raise ValueError(
            f"unknown scenario key {key!r} in tracked npy name {name!r}"
        )
    return key, m.group(2), m.group(3)


def expected_csv_name(sce_key: str, exp_num: str, suffix_num: str) -> str:
    town = scenarios.get(sce_key).town
    return f"exp_{exp_num}_control_{town}_{suffix_num}.csv"


def compute_ego_kinematics(theta: np.ndarray, v: np.ndarray, t: np.ndarray):
    """vx = v cosθ, vy = v sinθ; ax/ay = gradient over t; yaw in degrees
    (reference ``compute_ego_kinematics``, ``:130-153``)."""
    theta = np.asarray(theta, float)
    v = np.asarray(v, float)
    t = np.asarray(t, float)
    vx, vy = v * np.cos(theta), v * np.sin(theta)
    yaw_deg = np.rad2deg(theta)
    if len(theta) == 1:
        z = np.zeros(1)
        return vx, vy, z, z, yaw_deg
    return vx, vy, np.gradient(vx, t), np.gradient(vy, t), yaw_deg


def _fill_nan(t: np.ndarray) -> np.ndarray:
    """pandas' ``Series.interpolate(limit_direction="both").bfill().ffill()``:
    interior NaNs linear in the position, leading and trailing ones the
    nearest value (``np.interp`` holds its ends, as pandas' linear method
    does); all NaN stays all NaN."""
    nan = np.isnan(t)
    if nan.all():
        return t
    pos = np.arange(len(t))
    t = t.copy()
    t[nan] = np.interp(pos[nan], pos[~nan], t[~nan])
    return t


def _row_times(df: Frame, start_row: int, L: int) -> np.ndarray:
    """Clock for the replaced rows: 'frame' column, else 'time', else index
    (reference ``row_times_seconds``, ``:107-127``)."""
    if L <= 0:
        return np.array([])
    if "frame" in df:
        t = df["frame"][start_row: start_row + L]
    elif "time" in df:
        t = df["time"][start_row: start_row + L]
    else:
        t = np.arange(L, dtype=float)
    if np.any(np.isnan(t)):
        t = _fill_nan(t)
    return np.asarray(t, float)


def find_best_start_row(df: Frame, x0: float, y0: float) -> int:
    """CSV row whose ego position is nearest the trajectory start
    (reference ``:156-163``)."""
    ex, ey = df["ego_x"], df["ego_y"]
    return int(np.nanargmin((ex - x0) ** 2 + (ey - y0) ** 2))


def merge_trajectory_into_csv(df: Frame, traj_xytv: np.ndarray, start_row: int) -> Frame:
    """Overwrite ego columns from ``start_row`` with the trajectory-derived
    kinematics; truncate the tail if the trajectory is shorter
    (reference ``merge_trajectory_into_csv``, ``:166-205``)."""
    for col in _EGO_COLS:
        if col not in df:
            raise KeyError(f'CSV missing column "{col}"')
    traj = np.asarray(traj_xytv, float)
    if traj.ndim != 2 or traj.shape[1] < 4:
        raise ValueError("trajectory must be (N, ≥4) [x, y, theta, v]")

    remain = len(df) - start_row
    if remain <= 0:
        raise ValueError("start row beyond CSV length")
    L = min(len(traj), remain)
    seg = traj[:L]
    t = _row_times(df, start_row, L)
    vx, vy, ax, ay, yaw_deg = compute_ego_kinematics(seg[:, 2], seg[:, 3], t)

    new = {}
    for col, values in zip(_EGO_COLS, (seg[:, 0], seg[:, 1], vx, vy, ax, ay, yaw_deg)):
        c = df[col].copy()
        c[start_row: start_row + L] = values
        new[col] = c
    out = df.assign(**new)
    if L < remain:
        out = out.rows(0, start_row + L)
    return out


def writeback_npy_to_csv(
    npy_path: Union[str, Path],
    defensive_data_root: Union[str, Path],
    out_dir: Union[str, Path],
) -> Path:
    """Full write-back for one tracked npy (reference ``main``, ``:208-240``)
    → the path of ``<source stem>_def.csv`` in ``out_dir``."""
    npy_path = Path(npy_path)
    traj = np.asarray(np.load(npy_path))[:, :4].astype(float)
    sce_key, exp_num, suffix = parse_tracked_npy_name(npy_path.name)
    csv_name = expected_csv_name(sce_key, exp_num, suffix)

    matches = [
        p for p in Path(defensive_data_root).rglob(csv_name) if p.is_file()
    ]
    if not matches:
        raise FileNotFoundError(f"{csv_name} not found under {defensive_data_root}")
    if len(matches) > 1:
        raise RuntimeError(f"multiple CSVs named {csv_name}")
    df = read_csv(str(matches[0]))
    start_row = find_best_start_row(df, traj[0, 0], traj[0, 1])
    merged = merge_trajectory_into_csv(df, traj, start_row)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{matches[0].stem}_def.csv"
    write_csv(out_path, merged)
    return out_path
