"""Spatial / spatiotemporal validation metrics.

Port of ``defensive_model_vae_tpu/metrics/spatial.py``: the same numpy
and scipy operations in the same order, over the port's scenario registry.

Vectorized re-implementation of the reference metric library
(``Spatial_Distribution.py``):

- point subsampling to ≤150 per track (``:18-91``)
- RMSE_frequency over the scenario grid — point-count (``:94-161``) and
  trajectory-count ("new", each track counts once per cell, ``:387-492``)
  variants
- space-time-velocity surface: per-cell mean speed + Gaussian smoothing
  σ=2 (``:863-931``) and its RMSE (``:1540-1583``)
- spatiotemporal plane-centroid RMSE over 0.5 s time slices (``:1357-1429``)

All loops over points are replaced by ``histogram2d`` / ``bincount``
scatter-adds; only tiny per-track loops remain where the reference's
semantics are inherently sequential.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
from scipy import ndimage

from .. import scenarios


def _grid_edges(scenario, grid_size: float = 1.0):
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    x_edges = np.arange(sce.grid_x[0], sce.grid_x[1], grid_size)
    y_edges = np.arange(sce.grid_y[0], sce.grid_y[1], grid_size)
    return x_edges, y_edges


def subsample_points(xy: np.ndarray, max_points: int = 150, rng=None) -> np.ndarray:
    """Uniform index subsampling to ≤ max_points (reference ``:33-51``),
    including both endpoints; deduplicated indices are topped up randomly."""
    n = xy.shape[0]
    if n <= max_points:
        return xy
    idx = np.unique(np.linspace(0, n - 1, max_points, dtype=int))
    if len(idx) < max_points:
        rng = rng or np.random.default_rng()
        unused = np.setdiff1d(np.arange(n), idx)
        extra = rng.choice(unused, size=max_points - len(idx), replace=False)
        idx = np.sort(np.concatenate([idx, extra]))
    return xy[idx]


def extract_coordinates(
    trajectories: Iterable[np.ndarray], max_points: int = 150
) -> np.ndarray:
    """Stack subsampled (x, y) points of all tracks (reference ``:18-91``;
    works for both [N,4] state traces and [N,3] human tracks)."""
    pts = [subsample_points(np.asarray(t)[:, :2], max_points) for t in trajectories]
    return np.vstack(pts) if pts else np.zeros((0, 2))


def _histogram(coords: np.ndarray, x_edges, y_edges) -> np.ndarray:
    if len(coords) == 0:
        return np.zeros((len(y_edges) - 1, len(x_edges) - 1))
    H, _, _ = np.histogram2d(coords[:, 0], coords[:, 1], bins=[x_edges, y_edges])
    return H.T


def rmse_frequency(
    generated_coords: np.ndarray,
    human_coords: np.ndarray,
    scenario,
    grid_size: float = 1.0,
) -> float:
    """Point-count RMSE_frequency over cells where either histogram is
    nonzero (reference ``calculate_rmse_frequency``, ``:94-161``)."""
    x_edges, y_edges = _grid_edges(scenario, grid_size)
    f_sim = _histogram(generated_coords, x_edges, y_edges).ravel()
    f_obs = _histogram(human_coords, x_edges, y_edges).ravel()
    mask = (f_sim > 0) | (f_obs > 0)
    if not mask.any():
        return 0.0
    return float(np.sqrt(np.mean((f_sim[mask] - f_obs[mask]) ** 2)))


def count_trajectories_per_grid(
    trajectories: Sequence[np.ndarray], scenario, grid_size: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell count of how many tracks visit the cell (each track counts
    once per cell; reference ``_count_trajectories_per_grid``, ``:387-430``)."""
    x_edges, y_edges = _grid_edges(scenario, grid_size)
    ny, nx = len(y_edges) - 1, len(x_edges) - 1
    H = np.zeros((ny, nx), dtype=int)
    for traj in trajectories:
        xy = np.asarray(traj)[:, :2]
        xi = np.clip(np.digitize(xy[:, 0], x_edges) - 1, 0, nx - 1)
        yi = np.clip(np.digitize(xy[:, 1], y_edges) - 1, 0, ny - 1)
        flat = np.unique(yi * nx + xi)
        H.ravel()[flat] += 1
    return H, x_edges, y_edges


def rmse_frequency_trajcount(
    generated_trajectories: Sequence[np.ndarray],
    human_trajectories: Sequence[np.ndarray],
    scenario,
    grid_size: float = 1.0,
) -> float:
    """Trajectory-count RMSE_frequency (reference ``:433-492``) — the
    variant whose per-scenario values are published in
    ``results/ModelValidation/JS_divergence.txt``."""
    H_sim, x_edges, y_edges = count_trajectories_per_grid(
        generated_trajectories, scenario, grid_size
    )
    H_obs, _, _ = count_trajectories_per_grid(human_trajectories, scenario, grid_size)
    f_sim, f_obs = H_sim.ravel().astype(float), H_obs.ravel().astype(float)
    mask = (f_sim > 0) | (f_obs > 0)
    if not mask.any():
        return 0.0
    return float(np.sqrt(np.mean((f_sim[mask] - f_obs[mask]) ** 2)))


# ---------------------------------------------------------------------------
# space-time-velocity surfaces
# ---------------------------------------------------------------------------

def model_stv_data(
    trajectories: Sequence[np.ndarray], scenario, axis: str = "x"
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """(coord, time, speed) series per tracked [N,4] trace; time is
    ``arange(N) * dt`` (reference ``_prepare_model_stv_data``, ``:708-740``)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    ci = 0 if axis == "x" else 1
    coords, times, vs = [], [], []
    for traj in trajectories:
        traj = np.asarray(traj)
        if traj.shape[1] < 4:
            continue
        coords.append(traj[:, ci])
        times.append(np.arange(traj.shape[0]) * sce.dt)
        vs.append(traj[:, 3])
    return coords, times, vs


def human_stv_data(
    human_trajectories: Sequence[np.ndarray], axis: str = "x"
) -> Tuple[List[np.ndarray], List[np.ndarray], List[np.ndarray]]:
    """(coord, time, speed) series per human [N,3] track (reference
    ``_prepare_human_stv_data``, ``:743-797``)."""
    from .distribution import _track_velocities

    ci = 0 if axis == "x" else 1
    coords, times, vs = [], [], []
    for traj in human_trajectories:
        traj = np.asarray(traj)
        if traj.shape[1] < 3 or traj.shape[0] < 2:
            continue
        coords.append(traj[:, ci])
        times.append(traj[:, 2])
        vs.append(_track_velocities(traj))
    return coords, times, vs


def build_stv_surface(
    coords_list: Sequence[np.ndarray],
    times_list: Sequence[np.ndarray],
    v_list: Sequence[np.ndarray],
    num_coord_bins: int = 40,
    num_time_bins: int = 40,
    coord_range: Optional[Tuple[float, float]] = None,
    time_range: Optional[Tuple[float, float]] = None,
    smooth_sigma: float = 2.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell mean speed over a (time, coord) grid, Gaussian-smoothed
    (reference ``_build_surface_from_stv``, ``:863-931``).  Empty cells are
    zero before smoothing, as in the reference.

    Returns (coord_grid, time_grid, v_surface[T, C])."""
    all_c = np.concatenate(coords_list)
    all_t = np.concatenate(times_list)
    all_v = np.concatenate(v_list)

    cmin, cmax = (
        coord_range if coord_range is not None else (all_c.min(), all_c.max())
    )
    tmin, tmax = (
        time_range if time_range is not None else (all_t.min(), all_t.max())
    )
    c_edges = np.linspace(cmin, cmax, num_coord_bins + 1)
    t_edges = np.linspace(tmin, tmax, num_time_bins + 1)

    ci = np.clip(np.digitize(all_c, c_edges) - 1, 0, num_coord_bins - 1)
    ti = np.clip(np.digitize(all_t, t_edges) - 1, 0, num_time_bins - 1)
    flat = ti * num_coord_bins + ci
    n_cells = num_time_bins * num_coord_bins
    sums = np.bincount(flat, weights=all_v, minlength=n_cells)
    counts = np.bincount(flat, minlength=n_cells)
    v_surface = np.where(counts > 0, sums / np.maximum(counts, 1), 0.0)
    v_surface = v_surface.reshape(num_time_bins, num_coord_bins)
    v_surface = ndimage.gaussian_filter(v_surface, sigma=smooth_sigma, mode="nearest")

    c_centers = 0.5 * (c_edges[:-1] + c_edges[1:])
    t_centers = 0.5 * (t_edges[:-1] + t_edges[1:])
    coord_grid, time_grid = np.meshgrid(c_centers, t_centers)
    return coord_grid, time_grid, v_surface


def surface_rmse(
    model_surface: np.ndarray,
    human_surface: np.ndarray,
    include_zero_velocity: bool = True,
) -> Tuple[float, int]:
    """Point-wise RMSE of two speed surfaces (reference ``:1540-1583``)."""
    if model_surface.shape != human_surface.shape:
        raise ValueError("surface shapes differ")
    diff = model_surface - human_surface
    if include_zero_velocity:
        mask = np.ones_like(diff, bool)
    else:
        mask = (model_surface != 0.0) | (human_surface != 0.0)
    vals = diff[mask]
    if vals.size == 0:
        return 0.0, 0
    return float(np.sqrt(np.mean(vals**2))), int(vals.size)


def spatiotemporal_plane_rmse(
    human_trajectories: Sequence[np.ndarray],
    model_trajectories: Sequence[np.ndarray],
    scenario,
    time_interval: float = 0.5,
) -> Tuple[float, List[float]]:
    """Centroid-distance RMSE over time slices (reference ``:1357-1429``).

    Human tracks are [x, y, t]; model tracks are [N, 4] state traces whose
    times are ``arange(N) * dt``.  Slices missing either side are skipped.
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario

    def _points(trs, is_model):
        rows = []
        for tr in trs:
            tr = np.asarray(tr)
            if is_model:
                if tr.shape[1] < 4:
                    continue
                t = np.arange(tr.shape[0]) * sce.dt
            else:
                if tr.shape[1] < 3:
                    continue
                t = tr[:, 2]
            rows.append(np.column_stack([tr[:, 0], tr[:, 1], t]))
        return np.vstack(rows) if rows else np.zeros((0, 3))

    hp = _points(human_trajectories, False)
    mp = _points(model_trajectories, True)
    if len(hp) == 0 or len(mp) == 0:
        return float("nan"), []

    t_min = min(hp[:, 2].min(), mp[:, 2].min())
    t_max = max(hp[:, 2].max(), mp[:, 2].max())
    edges = np.arange(t_min, t_max + 1e-9, time_interval)
    if len(edges) < 2:
        return float("nan"), []

    errors = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        ph = hp[(hp[:, 2] >= lo) & (hp[:, 2] < hi), :2]
        pm = mp[(mp[:, 2] >= lo) & (mp[:, 2] < hi), :2]
        if len(ph) == 0 or len(pm) == 0:
            continue
        errors.append(float(np.linalg.norm(ph.mean(0) - pm.mean(0))))
    if not errors:
        return float("nan"), []
    return float(np.sqrt(np.mean(np.square(errors)))), errors
