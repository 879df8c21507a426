"""GIF / animation toolkit.

Re-implements the reference animation stack (``Plot_Gif.py``,
``Tools.py:260-637``, ``MPC/Drawing_Tools.py``): rotated-rectangle vehicle
rendering, human-vs-model comparison animations with background vehicles
and scenario lane geometry, MPC tracking animations, and cubic-spline
trajectory smoothing with a start-heading boundary condition.  One set of
functions driven by the scenario registry replaces the diverged
Tools/Plot_Gif copies (SURVEY §5 defect 5).

Port of ``defensive_model_vae_tpu/viz/gif.py`` (matplotlib's
``PillowWriter``; host only, as all of ``viz/``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .. import scenarios
from .plots import BV_COLOR, HUMAN_COLOR, MODEL_COLOR, draw_lane_lines


def vehicle_rectangle(center_x, center_y, yaw, length=4.0, width=2.0):
    """(4, 2) rotated rectangle corners (reference
    ``create_vehicle_rectangle``, ``Tools.py:260-300``)."""
    half_l, half_w = length / 2, width / 2
    corners = np.array(
        [[-half_l, -half_w], [half_l, -half_w], [half_l, half_w], [-half_l, half_w]]
    )
    c, s = np.cos(yaw), np.sin(yaw)
    R = np.array([[c, -s], [s, c]])
    return corners @ R.T + np.array([center_x, center_y])


def smooth_curve(
    points: np.ndarray,
    start_heading: Optional[float] = None,
    n: Optional[int] = None,
    time_interval: float = 0.015,
):
    """Cubic-spline smoothing of [t, x, y] trajectories, mirroring the
    reference ``create_smooth_curve`` (``Tools.py:775-830``): x and y are
    splined against the NORMALIZED CUMULATIVE CHORD LENGTH (not time) with
    natural boundary conditions; ``start_heading`` clamps the start
    first-derivative to (cos, sin)·(mean segment length), end stays
    natural.  The output time column is ``arange(0, t_end, time_interval)``
    and the curve is sampled at ``num_points`` uniform parameter values —
    pass ``n`` to override the sample count (the reference derives it from
    ``time_interval``).

    Returns an (num_points, 3) [t, x, y] array.
    """
    from scipy.interpolate import CubicSpline

    pts = np.asarray(points, float)
    time_series, x, y = pts[:, 0], pts[:, 1], pts[:, 2]

    smooth_time = np.arange(0.0, time_series[-1], time_interval)
    num_points = len(smooth_time) if n is None else n
    if n is not None:
        smooth_time = np.linspace(0.0, time_series[-1], n, endpoint=False)

    # chord-length parameterization, normalized to [0, 1] (reference :799-801)
    seg = np.sqrt(np.diff(x) ** 2 + np.diff(y) ** 2)
    t_param = np.zeros(len(x))
    t_param[1:] = np.cumsum(seg)
    t_param /= t_param[-1]

    if start_heading is not None:
        avg_dist = float(np.mean(seg))
        bc_x = ((1, np.cos(start_heading) * avg_dist), "natural")
        bc_y = ((1, np.sin(start_heading) * avg_dist), "natural")
    else:
        bc_x = bc_y = "natural"
    cs_x = CubicSpline(t_param, x, bc_type=bc_x)
    cs_y = CubicSpline(t_param, y, bc_type=bc_y)

    new_t = np.linspace(0.0, 1.0, num_points)
    return np.column_stack([smooth_time, cs_x(new_t), cs_y(new_t)])


def _heading_series(xy: np.ndarray) -> np.ndarray:
    """Per-point headings from finite differences (held at the end)."""
    d = np.diff(xy, axis=0)
    th = np.arctan2(d[:, 1], d[:, 0])
    return np.append(th, th[-1] if len(th) else 0.0)


def constant_speed_trajectory(
    waypoints: np.ndarray, speed: float = 3.0, dt: float = 0.05
) -> np.ndarray:
    """(N, 2) positions of a vehicle moving through ``waypoints`` at
    constant ``speed`` — the moving-background-vehicle path of the MPC
    tracking gifs (reference
    ``Drawing_Tools.calculate_moving_bg_vehicle_trajectory``, ``:116-160``),
    vectorized: per-segment times from arc length, one interp per axis."""
    wp = np.asarray(waypoints, float)[:, :2]
    seg = np.hypot(*np.diff(wp, axis=0).T)
    t_wp = np.concatenate([[0.0], np.cumsum(seg / speed)])
    t = np.arange(0.0, t_wp[-1] + dt, dt)
    return np.column_stack([np.interp(t, t_wp, wp[:, 0]),
                            np.interp(t, t_wp, wp[:, 1])])


def animate_human_vs_model(
    human_traj: Optional[np.ndarray],
    bv1_traj: Optional[np.ndarray],
    bv2_traj: Optional[np.ndarray],
    model_traj: np.ndarray,
    scenario,
    save_path: str,
    fps: int = 25,
    frame_stride: int = 4,
):
    """Human-vs-model GIF with background vehicles and lane geometry
    (reference ``plot_gif_human_vs_model``, ``Tools.py:304-637``).

    All trajectories are [x, y, t] rows; frames advance on the shared
    clock.  sce3's first background vehicle renders at bicycle size, as in
    the reference (``Tools.py:397-400``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches
    from matplotlib.animation import FuncAnimation, PillowWriter

    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario

    fig, ax = plt.subplots(figsize=(8, 8))
    ax.set_xlim(sce.plot_xlim)
    ax.set_ylim(sce.plot_ylim)
    ax.grid(True, alpha=0.2)
    ax.set_aspect("equal")
    draw_lane_lines(ax, sce)
    # display orientation matches the reference animation and every other
    # repo figure (Tools.py:436-439: x inverted for sce1/2, y for sce3/4)
    if "x" in sce.axis_flip:
        ax.invert_xaxis()
    if "y" in sce.axis_flip:
        ax.invert_yaxis()

    tracks = []

    def add_track(traj, color, label, size=(4.0, 2.0)):
        if traj is None:
            return
        line, = ax.plot([], [], color=color, linewidth=2, label=label)
        rect = patches.Polygon(
            vehicle_rectangle(1e3, 1e3, 0, *size).tolist(),
            facecolor=color, edgecolor="none",
        )
        ax.add_patch(rect)
        tracks.append((np.asarray(traj), _heading_series(np.asarray(traj)[:, :2]), line, rect, size))

    bv_size = sce.bv1_plot_size
    add_track(model_traj, MODEL_COLOR, "Model")
    add_track(human_traj, HUMAN_COLOR, "Human")
    add_track(bv1_traj, BV_COLOR, "BV", bv_size)
    add_track(bv2_traj, BV_COLOR, None)
    ax.legend(loc="upper right")
    # live clock HUD (reference ``Tools.py:421,610``)
    time_text = ax.text(0.02, 0.98, "", transform=ax.transAxes, fontsize=12,
                        verticalalignment="top")

    # advance every track on the shared CLOCK, not by frame index: tracks
    # differ in length, start time, and sampling rate, and the reference
    # synchronizes them by nearest time (``Tools.py:443-485``)
    t_max = max(float(t[0][-1, 2]) for t in tracks)
    frame_dt = sce.dt * frame_stride
    frames = np.arange(0.0, t_max + frame_dt, frame_dt)

    def update(now):
        artists = []
        for traj, headings, line, rect, size in tracks:
            j = int(np.argmin(np.abs(traj[:, 2] - now)))
            past = traj[:, 2] <= now
            line.set_data(traj[past, 0], traj[past, 1])
            rect.set_xy(
                vehicle_rectangle(traj[j, 0], traj[j, 1], headings[j], *size)
            )
            artists += [line, rect]
        time_text.set_text(f"Time: {now:.2f}s")
        artists.append(time_text)
        return artists

    anim = FuncAnimation(fig, update, frames=frames, blit=True)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    anim.save(save_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return save_path


def animate_tracking(
    waypoints: np.ndarray,
    states: np.ndarray,
    scenario,
    save_path: str,
    fps: int = 25,
    frame_stride: int = 8,
    draw_lanes: bool = False,
    static_bv_xy: Optional[np.ndarray] = None,
    moving_bv_waypoints: Optional[np.ndarray] = None,
    moving_bv_speed: float = 3.0,
):
    """MPC tracking GIF: reference path + moving tracked vehicle, with the
    full scene dressing of the reference's two Drawing_Tools variants
    (``create_path_tracking_gif`` ``:208-349`` — lane lines, static +
    constant-speed moving background vehicles — and
    ``create_path_tracking_gif_with_reference`` ``:352-458`` — the static
    reference path, which is the always-drawn waypoint line here).

    The HUD additionally shows live time AND speed from the tracked state's
    v column (the reference variants have no telemetry readout).

    - ``draw_lanes``: scenario lane geometry from the registry
      (``Drawing_Tools.draw_lane_lines`` used hardcoded demo lanes).
    - ``static_bv_xy``: (2,) parked background vehicle position
      (``draw_background_vehicle``, ``:79-113``).
    - ``moving_bv_waypoints``: (M, 2) path for a constant-speed background
      vehicle (``calculate_moving_bg_vehicle_trajectory``, ``:116-160``).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib import patches
    from matplotlib.animation import FuncAnimation, PillowWriter

    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    fig, ax = plt.subplots(figsize=(8, 8))
    pad = 10
    ax.set_xlim(states[:, 0].min() - pad, states[:, 0].max() + pad)
    ax.set_ylim(states[:, 1].min() - pad, states[:, 1].max() + pad)
    ax.set_aspect("equal")
    ax.grid(alpha=0.2)
    if draw_lanes:
        draw_lane_lines(ax, sce)
    if static_bv_xy is not None:
        ax.add_patch(patches.Polygon(
            vehicle_rectangle(static_bv_xy[0], static_bv_xy[1], 0.0).tolist(),
            facecolor=BV_COLOR, edgecolor="none",
        ))
    ax.plot(waypoints[:, 0], waypoints[:, 1], "ro--", markersize=4, label="Waypoints")
    trail, = ax.plot([], [], color=MODEL_COLOR, linewidth=2, label="Tracked")
    rect = patches.Polygon(
        vehicle_rectangle(1e3, 1e3, 0).tolist(), facecolor=MODEL_COLOR, edgecolor="none"
    )
    ax.add_patch(rect)

    bv_path = bv_head = bv_rect = bv_trail = None
    if moving_bv_waypoints is not None:
        dt = sce.dt * frame_stride
        bv_path = constant_speed_trajectory(moving_bv_waypoints, moving_bv_speed, dt)
        bv_head = _heading_series(bv_path)
        bv_trail, = ax.plot([], [], color=BV_COLOR, linewidth=2, alpha=0.8,
                            label="BV")
        bv_rect = patches.Polygon(
            vehicle_rectangle(1e3, 1e3, 0, 2.0, 1.0).tolist(),
            facecolor=BV_COLOR, edgecolor="none",
        )
        ax.add_patch(bv_rect)
    ax.legend()
    hud = ax.text(0.02, 0.98, "", transform=ax.transAxes, fontsize=12,
                  verticalalignment="top")

    frames = range(0, len(states), frame_stride)

    def update(i):
        trail.set_data(states[: i + 1, 0], states[: i + 1, 1])
        rect.set_xy(vehicle_rectangle(states[i, 0], states[i, 1], states[i, 2]))
        artists = [trail, rect]
        if bv_path is not None:
            j = min(i // frame_stride, len(bv_path) - 1)
            bv_trail.set_data(bv_path[: j + 1, 0], bv_path[: j + 1, 1])
            bv_rect.set_xy(
                vehicle_rectangle(bv_path[j, 0], bv_path[j, 1], bv_head[j],
                                  2.0, 1.0)
            )
            artists += [bv_trail, bv_rect]
        t_now = i * sce.dt
        if states.shape[1] >= 4:
            hud.set_text(f"Time: {t_now:.2f}s   Speed: {states[i, 3]:.1f} m/s")
        else:
            hud.set_text(f"Time: {t_now:.2f}s")
        artists.append(hud)
        return artists

    anim = FuncAnimation(fig, update, frames=frames, blit=True)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    anim.save(save_path, writer=PillowWriter(fps=fps))
    plt.close(fig)
    return save_path
