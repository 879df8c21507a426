"""Static figures: velocity distributions, spatial heatmaps, tracking
results, SUT speed curves, case figures, histograms, 3D spatiotemporal
clusters.

Port of ``defensive_model_vae_tpu/viz/plots.py``: host-side matplotlib over
numpy arrays, the per-scenario geometry from the port's scenario registry.
The SUT episodes of :func:`plot_speed_time_curves` are the port's
``data.csv_io.Frame`` tables (JAX's are pandas frames).  ``viz/`` is the
port's only matplotlib user and runs on the host only: nothing the card
path imports reaches it.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .. import scenarios

MODEL_COLOR = (0, 0.4470, 0.7410)
HUMAN_COLOR = (0.7961, 0.1255, 0.1765)
BV_COLOR = (0.4660, 0.6740, 0.1880)


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, save_path):
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=150, bbox_inches="tight", facecolor="white")
    import matplotlib.pyplot as plt

    plt.close(fig)
    return save_path


def draw_lane_lines(ax, scenario):
    """Scenario lane geometry (reference ``Tools.py:343-368`` etc.)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    for line in sce.lane_lines:
        style = "k-" if line.style == "solid" else "k--"
        span = np.linspace(*line.span, 100)
        if line.axis == "x":
            ax.plot([line.value] * len(span), span, style, linewidth=1.5, alpha=0.7)
        else:
            ax.plot(span, [line.value] * len(span), style, linewidth=1.5, alpha=0.7)


def plot_velocity_distribution(
    generated_velocities, human_velocities, save_path, js_divergence=None
):
    """Histogram + boxplot comparison (reference ``Distribution.py:299-385``)."""
    plt = _plt()
    generated_velocities = np.asarray(generated_velocities, float)
    human_velocities = np.asarray(human_velocities, float)
    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    # an empty side (zero valid tracks) must not crash after the expensive
    # pipeline compute — render an annotated empty figure instead
    if generated_velocities.size == 0 or human_velocities.size == 0:
        axes[0].set_title("velocity distribution unavailable (empty input)")
        return _save(fig, save_path)
    vmax = max(np.max(generated_velocities), np.max(human_velocities))
    bins = np.linspace(0, vmax, 50)
    axes[0].hist(
        generated_velocities, bins=bins, alpha=0.6, density=True,
        label=f"Model (n={len(generated_velocities)})", color=MODEL_COLOR,
    )
    axes[0].hist(
        human_velocities, bins=bins, alpha=0.6, density=True,
        label=f"Human (n={len(human_velocities)})", color=HUMAN_COLOR,
    )
    axes[0].set_xlabel("Velocity (m/s)")
    axes[0].set_ylabel("Density")
    title = "Velocity Distribution Comparison"
    if js_divergence is not None:
        title += f" (JS={js_divergence:.4f})"
    axes[0].set_title(title)
    axes[0].legend()
    axes[0].grid(alpha=0.3)

    bp = axes[1].boxplot(
        [generated_velocities, human_velocities],
        tick_labels=["Model", "Human"], patch_artist=True,
    )
    for patch, color in zip(bp["boxes"], [MODEL_COLOR, HUMAN_COLOR]):
        patch.set_facecolor(color)
    axes[1].set_ylabel("Velocity (m/s)")
    axes[1].set_title("Velocity Distribution Statistics")
    axes[1].grid(alpha=0.3, axis="y")
    fig.tight_layout()
    return _save(fig, save_path)


def plot_spatial_distribution(
    coordinates=None, scenario=None, save_path=None, title="Spatial Distribution",
    grid_size=1.0, vmin=None, vmax=None, trajectories=None,
):
    """Per-cell heatmap over the scenario grid with lane lines.

    Point-count mode (``coordinates`` given — reference
    ``plot_spatial_distribution``) or trajectory-count mode
    (``trajectories`` given: each track counts once per cell — reference
    ``plot_spatial_distribution_new``, ``Spatial_Distribution.py:540-683``).
    """
    from matplotlib.colors import LinearSegmentedColormap

    from ..metrics.spatial import _grid_edges

    plt = _plt()
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    x_edges, y_edges = _grid_edges(sce, grid_size)
    if trajectories is not None:
        from ..metrics import count_trajectories_per_grid

        # count matrix is already (ny, nx) — exactly pcolormesh's layout,
        # no transpose round-trip
        H_plot, _, _ = count_trajectories_per_grid(trajectories, sce, grid_size)
    else:
        H, _, _ = np.histogram2d(
            coordinates[:, 0], coordinates[:, 1], bins=[x_edges, y_edges]
        )
        H_plot = H.T  # histogram2d returns (nx, ny)
    cmap = LinearSegmentedColormap.from_list(
        "sky_to_darkred",
        ["#87CEEB", "#D4E8F0", "#FFFFE0", "#FFD260", "#FF6E30", "#F04228", "#CD2626"],
    )
    fig, ax = plt.subplots(figsize=(10, 10))
    im = ax.pcolormesh(x_edges, y_edges, H_plot, cmap=cmap, vmin=vmin, vmax=vmax, shading="flat")
    fig.colorbar(im, ax=ax, label="Number of Points")
    draw_lane_lines(ax, sce)
    ax.set_title(title)
    ax.set_aspect("equal", adjustable="box")
    if "x" in sce.axis_flip:
        ax.invert_xaxis()
    if "y" in sce.axis_flip:
        ax.invert_yaxis()
    return _save(fig, save_path)


def plot_tracking_results(
    times, states, controls, waypoints, path_reference, save_path, axis_flip="none"
):
    """6-panel MPC result figure (reference ``PathTracker.plot_results``,
    ``MPC_Tracking.py:525-616``): path, position error, velocity tracking,
    heading tracking, acceleration, steering."""
    plt = _plt()
    fig, axes = plt.subplots(2, 3, figsize=(15, 10))

    axes[0, 0].plot(waypoints[:, 0], waypoints[:, 1], "ro-", label="Reference Path", markersize=4)
    axes[0, 0].plot(states[:, 0], states[:, 1], "b-", label="Actual Path", linewidth=2)
    axes[0, 0].set_xlabel("X (m)"); axes[0, 0].set_ylabel("Y (m)")
    axes[0, 0].set_title("Path Tracking"); axes[0, 0].legend(); axes[0, 0].grid(True)
    axes[0, 0].axis("equal")
    if "x" in axis_flip:
        axes[0, 0].invert_xaxis()
    if "y" in axis_flip:
        axes[0, 0].invert_yaxis()

    err = path_reference.position_error(times, states[:, :2])
    axes[0, 1].plot(times, err, "r-", linewidth=2)
    axes[0, 1].set_ylim(0, 5.0)
    axes[0, 1].set_xlabel("Time (s)"); axes[0, 1].set_ylabel("Δs (m)")
    axes[0, 1].set_title("Position Error"); axes[0, 1].grid(True)

    _, _, vx, vy = path_reference.get_reference(times)
    axes[0, 2].plot(times, states[:, 3], "b-", label="Actual Velocity", linewidth=2)
    axes[0, 2].plot(times, np.hypot(vx, vy), "r--", label="Reference Velocity", linewidth=2)
    axes[0, 2].set_xlabel("Time (s)"); axes[0, 2].set_ylabel("V (m/s)")
    axes[0, 2].set_title("Velocity Tracking"); axes[0, 2].legend(); axes[0, 2].grid(True)

    axes[1, 0].plot(times, np.degrees(states[:, 2]), "b-", label="Actual Heading", linewidth=2)
    axes[1, 0].plot(times, np.degrees(path_reference.get_reference_heading(times)),
                    "r--", label="Reference Heading", linewidth=2)
    axes[1, 0].set_xlabel("Time (s)"); axes[1, 0].set_ylabel("Heading (°)")
    axes[1, 0].set_title("Heading Tracking"); axes[1, 0].legend(); axes[1, 0].grid(True)

    axes[1, 1].plot(times[:-1], controls[:, 0], "g-", linewidth=2)
    axes[1, 1].set_xlabel("Time (s)"); axes[1, 1].set_ylabel("Acc (m/s²)")
    axes[1, 1].set_title("Acceleration"); axes[1, 1].grid(True)

    axes[1, 2].plot(times[:-1], np.degrees(controls[:, 1]), "g-", linewidth=2)
    axes[1, 2].set_xlabel("Time (s)"); axes[1, 2].set_ylabel("Steering Angle (°)")
    axes[1, 2].set_title("Steering Angle"); axes[1, 2].grid(True)

    fig.tight_layout()
    return _save(fig, save_path)


def plot_speed_time_curves(episodes: Dict[str, "Frame"], scenario, save_path):  # noqa: F821
    """Ego speed-vs-time per SUT model (reference ``Data_Plot.py``);
    ``episodes`` maps a label to its episode as a ``data.csv_io.Frame``."""
    plt = _plt()
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    fig, ax = plt.subplots(figsize=(10, 6))
    for label, df in episodes.items():
        v = np.hypot(df["ego_vx"], df["ego_vy"])
        # the reference uses the log's own clock (sim_time - sim_time[0],
        # Data_Plot.py); synthesize from sce.dt only when the column is
        # absent, so logs with dropped frames or other rates plot true
        if "sim_time" in df:
            st = df["sim_time"]
            t = st - st[0]
        else:
            t = np.arange(len(df)) * sce.dt
        ax.plot(t, v, linewidth=1.5, label=label)
    ax.set_xlabel("Time (s)"); ax.set_ylabel("Speed (m/s)")
    ax.set_title(f"Ego Speed — {sce.town}")
    ax.legend(); ax.grid(alpha=0.3)
    return _save(fig, save_path)


def plot_static_case(
    model_traj, human_trajs, bv_trajs, scenario, save_path, interval_s=0.2
):
    """Static paper figure (reference ``Plot_case.py``): time-subsampled
    scatter of model vs human vs background trajectories."""
    plt = _plt()
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario

    def subsample(traj):  # [x, y, t] rows at ≥ interval_s spacing
        if traj is None or len(traj) == 0:
            return np.zeros((0, 3))
        keep = [0]
        for i in range(1, len(traj)):
            if traj[i, 2] - traj[keep[-1], 2] >= interval_s - 1e-9:
                keep.append(i)
        return traj[keep]

    fig, ax = plt.subplots(figsize=(10, 10))
    draw_lane_lines(ax, sce)
    for h in human_trajs:
        s = subsample(h)
        ax.scatter(s[:, 0], s[:, 1], s=12, color=HUMAN_COLOR, alpha=0.6)
    for b in bv_trajs:
        s = subsample(b)
        ax.scatter(s[:, 0], s[:, 1], s=12, color=BV_COLOR, alpha=0.6)
    if model_traj is not None:
        s = subsample(model_traj)
        ax.scatter(s[:, 0], s[:, 1], s=16, color=MODEL_COLOR, alpha=0.9, label="Model")
    ax.set_xlim(sce.plot_xlim); ax.set_ylim(sce.plot_ylim)
    ax.set_aspect("equal")
    if "x" in sce.axis_flip:
        ax.invert_xaxis()
    if "y" in sce.axis_flip:
        ax.invert_yaxis()
    ax.set_title(f"Trajectories — {sce.town}")
    return _save(fig, save_path)


def plot_histogram(values, save_path, title, xlabel, bin_width=0.5, x_max=None):
    """Start-velocity / THW histograms (reference ``Get_THW.py``)."""
    plt = _plt()
    values = np.asarray(values, float)
    if x_max is None:  # `or` would treat an explicit 0 as unset
        finite = values[np.isfinite(values)]
        x_max = float(finite.max()) * 1.1 if finite.size else bin_width
    x_max = max(float(x_max), bin_width)  # guarantee >= 1 valid bin
    fig, ax = plt.subplots(figsize=(10, 6))
    # + bin_width: np.arange's exclusive stop would drop the last edge,
    # silently excluding data above it (and a bare [0.] single-edge case
    # draws nothing) — the reference never hit this only because its
    # hardcoded x_max (Get_THW.py:15,66) was generous
    ax.hist(values, bins=np.arange(0, x_max + bin_width, bin_width),
            alpha=0.8, color="skyblue", edgecolor="black", density=True)
    ax.set_xlim(0, x_max)
    ax.set_title(title); ax.set_xlabel(xlabel); ax.set_ylabel("Density")
    ax.grid(alpha=0.3)
    return _save(fig, save_path)


def plot_generated_vs_training(
    generated: np.ndarray, training: np.ndarray, scenario, save_path,
):
    """Generated-vs-training trajectory overlay (the reference's training
    'visualization' mode, ``Training_VAE.py:396-431`` — whose helper
    crashes as shipped, SURVEY §5 defect 1).  Both arrays are (N, T, 3)
    [t, x, y] windows."""
    plt = _plt()
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    fig, ax = plt.subplots(figsize=(10, 10))
    draw_lane_lines(ax, sce)
    for tr in training:
        ax.plot(tr[:, 1], tr[:, 2], color=HUMAN_COLOR, alpha=0.5, linewidth=1.2)
    for tr in np.atleast_3d(generated).reshape(-1, generated.shape[-2], generated.shape[-1]):
        ax.plot(tr[:, 1], tr[:, 2], color=MODEL_COLOR, alpha=0.8, linewidth=1.5)
    ax.plot([], [], color=HUMAN_COLOR, label="Training")
    ax.plot([], [], color=MODEL_COLOR, label="Generated")
    ax.legend()
    ax.set_aspect("equal")
    if "x" in sce.axis_flip:
        ax.invert_xaxis()
    if "y" in sce.axis_flip:
        ax.invert_yaxis()
    ax.set_title(f"Generated vs training trajectories — {sce.town}")
    return _save(fig, save_path)


def plot_velocity_and_lateral_offset(
    model_traj: np.ndarray,
    human_traj: np.ndarray,
    scenario,
    save_path,
):
    """Speed and lateral-offset-vs-lane-center curves (reference
    ``Plot_Gif.py:295-427``).  Both trajectories are [x, y, t] rows; the
    lane CENTERLINE is the scenario's hardcoded reference value
    (``lateral_offset_center`` — Plot_Gif.py:327-338), not a painted
    lane line."""
    plt = _plt()
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    center_axis, center_value = sce.lateral_offset_center

    def speed(tr):
        d = np.linalg.norm(np.diff(tr[:, :2], axis=0), axis=1)
        dt = np.maximum(np.diff(tr[:, 2]), 1e-9)
        v = d / dt
        return tr[1:, 2], v

    def offset(tr):
        coord = tr[:, 0] if center_axis == "x" else tr[:, 1]
        return tr[:, 2], coord - center_value

    fig, axes = plt.subplots(1, 2, figsize=(14, 5))
    for tr, color, label in ((model_traj, MODEL_COLOR, "Model"),
                             (human_traj, HUMAN_COLOR, "Human")):
        if tr is None:
            continue
        t, v = speed(tr)
        axes[0].plot(t, v, color=color, linewidth=2, label=label)
        t2, off = offset(tr)
        axes[1].plot(t2, off, color=color, linewidth=2, label=label)
    axes[0].set_xlabel("Time (s)"); axes[0].set_ylabel("Speed (m/s)")
    axes[0].set_title("Speed"); axes[0].legend(); axes[0].grid(alpha=0.3)
    axes[1].set_xlabel("Time (s)"); axes[1].set_ylabel("Lateral offset (m)")
    axes[1].axhline(0.0, color="k", linewidth=1, alpha=0.5)
    axes[1].set_title("Lateral offset vs lane center")
    axes[1].legend(); axes[1].grid(alpha=0.3)
    fig.tight_layout()
    return _save(fig, save_path)


def unified_colorbar_range(
    coordinate_sets=None, scenario=None, grid_size=1.0, trajectory_sets=None
):
    """Shared (vmin, vmax) across several spatial distributions so paired
    heatmaps are comparable (reference ``calculate_unified_colorbar_range``
    / ``_new``, ``Spatial_Distribution.py:164-209,495-537``).

    Pass ``coordinate_sets`` (list of (N, 2) arrays, point counting) or
    ``trajectory_sets`` (list of track lists, per-track counting)."""
    from ..metrics.spatial import _grid_edges

    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    maxima, minima = [], []
    if trajectory_sets is not None:
        from ..metrics import count_trajectories_per_grid

        hists = [
            count_trajectories_per_grid(trajs, sce, grid_size)[0]
            for trajs in trajectory_sets if len(trajs)
        ]
    else:
        x_edges, y_edges = _grid_edges(sce, grid_size)
        hists = []
        for coords in coordinate_sets or []:
            if len(coords) == 0:
                continue
            H, _, _ = np.histogram2d(
                coords[:, 0], coords[:, 1], bins=[x_edges, y_edges]
            )
            hists.append(H)
    for H in hists:
        nz = H[H > 0]
        if len(nz):
            maxima.append(H.max())
            minima.append(nz.min())
    if not maxima:
        return 0, 1
    return float(min(minima)), float(max(maxima))


def plot_space_time_velocity(
    coords_list, times_list, v_list, save_path_lines, save_path_surface,
    axis="x", title_prefix="Model", scenario=None,
    num_coord_bins=40, num_time_bins=40,
    coord_range=None, time_range=None, vmin=None, vmax=None,
):
    """3-D coordinate–time–velocity figures: per-track curves plus the
    grid-averaged Gaussian-smoothed surface (reference
    ``plot_space_time_velocity_{model,human}``,
    ``Spatial_Distribution.py:934-1197``).  Feed with
    ``metrics.model_stv_data`` / ``metrics.human_stv_data`` (same ``axis``
    argument in both places).  When ``scenario`` is given, the spatial axis
    is inverted for every scenario except sce1, matching the reference's
    published figure orientation (``:991-992``).

    Returns the speed surface (also the input to ``surface_rmse``)."""
    from ..metrics import build_stv_surface

    if not len(coords_list):
        import warnings

        warnings.warn("no trajectories to plot for space-time-velocity")
        return None

    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    invert = sce is not None and sce.stv_invert_axis
    axis_label = "X" if axis == "x" else "Y"
    plt = _plt()

    def style(ax):
        ax.set_xlabel(f"{axis_label} (m)")
        ax.set_ylabel("Time (s)")
        ax.set_zlabel("Velocity (m/s)")
        if coord_range is not None:
            ax.set_xlim(coord_range)
        if time_range is not None:
            ax.set_ylim(time_range)
        if vmin is not None and vmax is not None:
            ax.set_zlim(vmin, vmax)
        if invert:
            ax.invert_xaxis()

    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(111, projection="3d")
    for coords, times, v in zip(coords_list, times_list, v_list):
        ax.plot(coords, times, v, alpha=0.8)
    ax.set_title(f"{title_prefix} Trajectories: {axis_label}-Time-Velocity")
    style(ax)
    _save(fig, save_path_lines)

    coord_grid, time_grid, surface = build_stv_surface(
        coords_list, times_list, v_list, num_coord_bins, num_time_bins,
        coord_range, time_range,
    )
    fig2 = plt.figure(figsize=(10, 10))
    ax2 = fig2.add_subplot(111, projection="3d")
    surf = ax2.plot_surface(
        coord_grid, time_grid, surface, cmap="viridis", edgecolor="none",
        antialiased=True, alpha=0.95, vmin=vmin, vmax=vmax,
    )
    fig2.colorbar(surf, ax=ax2, shrink=0.5, aspect=10, pad=0.1, label="Velocity (m/s)")
    ax2.set_title(f"{title_prefix} Trajectories Surface: {axis_label}-Time-Velocity")
    style(ax2)
    _save(fig2, save_path_surface)
    return surface


def plot_spatiotemporal(
    human_trajs, model_trajs, scenario, save_dir, elev=20, azim=-35
):
    """3D (x, y, t) trajectory clusters, one figure each for human and
    model (reference ``plot_spatiotemporal_trajectories``,
    ``Spatial_Distribution.py:1200-1354``)."""
    plt = _plt()
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    os.makedirs(save_dir, exist_ok=True)
    paths = []
    for name, trajs, is_model in (
        ("human", human_trajs, False), ("model", model_trajs, True)
    ):
        if not len(trajs):
            continue
        fig = plt.figure(figsize=(10, 10))
        ax = fig.add_subplot(111, projection="3d")
        for tr in trajs:
            tr = np.asarray(tr)
            t = np.arange(len(tr)) * sce.dt if is_model else tr[:, 2]
            ax.plot(tr[:, 0], tr[:, 1], t, alpha=0.6, linewidth=0.8)
        ax.set_xlabel("X (m)"); ax.set_ylabel("Y (m)"); ax.set_zlabel("Time (s)")
        ax.set_title(f"{name.capitalize()} Spatiotemporal Trajectories")
        ax.view_init(elev=elev, azim=azim)
        ax.set_box_aspect((0.6, 1.4, 1))
        p = os.path.join(save_dir, f"{name}_spatio-temporal_{sce.key}.png")
        paths.append(_save(fig, p))
    return paths
