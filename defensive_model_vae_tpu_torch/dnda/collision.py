"""Surrounding-vehicle prediction + batched SAT collision sweep.

- ``predict_surrounding_rectangles``: constant-acceleration prediction of
  every surrounding vehicle's occupancy rectangle at each horizon step,
  with the reference's stop-on-reversal semantics (a vehicle freezes at
  the step before its velocity reverses or vanishes —
  ``Generate_surVehicle_Traj``, ``dnda_functions.py:1343-1451``).
- ``collision_indices``: the path × step × vehicle separating-axis sweep
  (``Collison_Detection``/``collison_detection``, ``:1464-1616``) as one
  dense batched tensor op (the reference's triple Python loop with early
  exit).  The sweep is the DNDA hot kernel; here it is a handful of
  einsums over a (paths × ego-points × vehicles) tensor.

Port of ``defensive_model_vae_tpu/dnda/collision.py``, unchanged: host numpy,
the exactness oracle of the batched torch sweep (:mod:`.device_sweep`).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .geometry import SurroundingVehicle


def predict_surrounding_rectangles(
    vehicles: Sequence[SurroundingVehicle],
    time_horizon: float,
    time_step: float,
) -> np.ndarray:
    """(V, T+1, 2, 4) occupancy rectangles, T = horizon/step."""
    n_steps = int(time_horizon / time_step) + 1
    t = np.arange(n_steps) * time_step  # (T+1,)
    rects = np.zeros((len(vehicles), n_steps, 2, 4))
    for vi, veh in enumerate(vehicles):
        vx = veh.speed_x + veh.acc_x * t
        vy = veh.speed_y + veh.acc_y * t
        # stop when the velocity direction reverses (dot of consecutive
        # velocities ≤ 0) or the speed vanishes at t > 0
        dots = vx[:-1] * vx[1:] + vy[:-1] * vy[1:]  # (T,)
        sp2 = vx**2 + vy**2
        stop_at = np.full(n_steps, False)
        stop_at[1:] = (dots <= 0) | (sp2[1:] == 0)
        stopped = np.cumsum(stop_at) > 0  # True from the first stop step on
        # frozen clock: T_j = t_j while not stopped, else the last free time
        if stopped.any():
            j_stop = int(np.argmax(stop_at))
            t_eff = np.where(np.arange(n_steps) < j_stop, t, t[j_stop - 1] if j_stop > 0 else 0.0)
        else:
            t_eff = t
        x = veh.x + veh.speed_x * t_eff + 0.5 * veh.acc_x * t_eff**2
        y = veh.y + veh.speed_y * t_eff + 0.5 * veh.acc_y * t_eff**2

        # heading: arctan(vy/vx) (reference uses arctan of the ratio, not
        # atan2); special cases per reference
        with np.errstate(divide="ignore", invalid="ignore"):
            theta_free = np.arctan(vy / np.where(vx == 0, np.nan, vx))
        theta_free = np.where(vx == 0, 1.5708, theta_free)
        if sp2[0] == 0:
            theta_free[0] = veh.heading + 1.57
        # Post-stop heading follows the reference's per-BRANCH freeze
        # (``:1405-1420``): the arctan branch carries the previous heading
        # while stopFlag is set and the speed²==0 branch carries too, but
        # the vx==0 (speed²!=0) branch assigns 1.5708 UNCONDITIONALLY —
        # even on frozen steps.  So theta forward-fills from the last
        # "set" step: every pre-stop step, plus frozen vx==0 overrides.
        override = (vx == 0) & (sp2 != 0)
        if stopped.any():
            frozen = np.arange(n_steps) >= int(np.argmax(stop_at))
        else:
            frozen = np.zeros(n_steps, bool)
        set_mask = ~frozen | override
        set_mask[0] = True  # j=0 always assigns (one of the three branches)
        fill = np.maximum.accumulate(
            np.where(set_mask, np.arange(n_steps), -1)
        )
        theta = theta_free[fill]

        base = np.array(
            [
                [veh.length / 2, -veh.length / 2, -veh.length / 2, veh.length / 2],
                [-veh.width / 2, -veh.width / 2, veh.width / 2, veh.width / 2],
            ]
        )
        c, s = np.cos(theta), np.sin(theta)
        R = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], axis=-2)
        r = np.einsum("tij,jk->tik", R, base)
        r += np.stack([x, y], axis=1)[:, :, None]
        rects[vi] = r
    return rects


def sat_collision(rect_a: np.ndarray, rect_b: np.ndarray) -> np.ndarray:
    """Vectorized separating-axis test for rectangle pairs.

    rect_a, rect_b: (..., 2, 4) corner matrices (columns = corners in
    order).  Returns boolean (…,) — True = overlap.  Axes checked are the
    two edge directions of each rectangle (for rectangles this equals the
    face-normal set); projection radius per axis is the sum over all four
    half-edge vectors of |axis·half_edge|, and the centers are taken from
    corners 1 and 3, exactly as the reference does (``:1526-1616``)."""
    rect_a, rect_b = np.broadcast_arrays(rect_a, rect_b)

    def edges(r):
        e1 = r[..., :, 1] - r[..., :, 0]
        e2 = r[..., :, 2] - r[..., :, 1]
        return e1, e2

    a1, a2 = edges(rect_a)
    b1, b2 = edges(rect_b)
    check = np.stack([a1, a2, b1, b2], axis=-2)  # (..., 4, 2)
    norms = np.linalg.norm(check, axis=-1, keepdims=True)
    unit = check / np.where(norms == 0, 1.0, norms)

    center_a = (rect_a[..., :, 1] + rect_a[..., :, 3]) / 2
    center_b = (rect_b[..., :, 1] + rect_b[..., :, 3]) / 2
    center_vec = center_b - center_a  # (..., 2)

    # radius along each axis: sum over the 4 half-edges
    proj = np.abs(np.einsum("...ik,...jk->...ij", unit, 0.5 * check))  # (...,4,4)
    radius = proj.sum(axis=-1)  # (..., 4)
    center_line = np.abs(np.einsum("...ik,...k->...i", unit, center_vec))
    separated = center_line > radius  # (..., 4)
    return ~separated.any(axis=-1)


def collision_indices(
    ego_rects: List[np.ndarray],
    sur_rects: np.ndarray,
    ego_speed: float,
    unit_arc_paths: Sequence[float],
    time_horizon: float,
    time_step: float,
) -> np.ndarray:
    """First-collision ego-point index per usable path.

    Reference scan (``Collison_Detection``, ``:1491-1524``): for each path,
    walk horizon steps j; at step j check ego points n in
    [ceil(v·j·Δt/u), ceil(v·(j+1)·Δt/u)) against every vehicle's rectangle
    at step j; on the first hit record n−1 and stop.  Default (no hit):
    ceil(v·H/u).

    Dense equivalent: each ego point n belongs to exactly one step
    j(n) = the j whose window contains n (windows are consecutive), so we
    evaluate hit[n] = any_vehicle SAT(ego[n], sur[:, j(n)]) for all n in
    parallel and take the first True.
    """
    n_paths = len(ego_rects)
    n_time = int(time_horizon / time_step)
    out = np.zeros(n_paths, dtype=int)
    for i in range(n_paths):
        u = unit_arc_paths[i]
        default = int(np.ceil((ego_speed * time_horizon) / u))
        bounds = np.ceil(ego_speed * np.arange(n_time + 1) * time_step / u).astype(int)
        n_pts = ego_rects[i].shape[0]
        # j(n): the step whose [bounds[j], bounds[j+1]) window holds n
        n_idx = np.arange(n_pts)
        j_of_n = np.searchsorted(bounds, n_idx, side="right") - 1
        checked = (j_of_n >= 0) & (j_of_n < n_time) & (n_idx < bounds[-1])
        # points never inside any window are unchecked
        in_window = checked & (n_idx >= bounds[np.clip(j_of_n, 0, n_time)])
        j_clip = np.clip(j_of_n, 0, sur_rects.shape[1] - 1)
        if sur_rects.shape[0] == 0:
            out[i] = default
            continue
        ego_n = ego_rects[i][:, None, :, :]  # (n, 1, 2, 4)
        sur_n = sur_rects[:, j_clip].transpose(1, 0, 2, 3)  # (n, V, 2, 4)
        hits = sat_collision(ego_n, sur_n).any(axis=1) & in_window
        if hits.any():
            out[i] = int(np.argmax(hits)) - 1
        else:
            out[i] = default
    return out
