"""Reference-trajectory construction for the MPC tracker (host side).

A numpy/scipy copy of ``defensive_model_vae_tpu/control/reference.py`` (all
of it), kept here so the port imports nothing of the JAX package.

Re-implements the behavior of the reference ``PathInterpolator``
(``MPC/MPC_Tracking.py:89-277``) and of the per-step reference build in
``PathTracker.step`` (``:454-478``) — cubic time-parameterized position
splines, midpoint-time velocity splines seeded with the initial velocity,
the start/end-heading heuristics (45°/90° jump guards, −2.8 rad wrap),
constant-velocity extrapolation past the last waypoint, and the
low-speed heading hold.

Everything here is a *pure function of the waypoints and the clock*, not of
the vehicle state — so the entire ``(num_steps, P+1, 2)`` [theta_ref, v_ref]
tensor is precomputed once on the host (scipy splines for exact numeric
parity) and shipped to the device, where the tracking loop runs batched
(``control/mpc.py``).  The reference rebuilds this row-by-row inside its control
loop; hoisting it out is what makes the device loop collective-free and
batchable."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
from scipy.interpolate import interp1d

_WRAP_LIMIT = -2.8  # reference normalizes angles below -2.8 rad by +2π


def _wrap(theta: np.ndarray) -> np.ndarray:
    return np.where(theta >= _WRAP_LIMIT, theta, theta + 2 * np.pi)


def _interp_kind(n: int) -> str:
    if n >= 4:
        return "cubic"
    if n >= 3:
        return "quadratic"
    return "linear"


@dataclasses.dataclass
class PathReference:
    """Precomputed reference for tracking one waypoint path.

    Args:
        waypoints: (N, 3) [x, y, t] rows, t strictly increasing.
        initial_state: (5,) [x, y, theta, vx, vy].
        raw_jump_guard: semantics of the 90° heading-jump guard in
            :meth:`get_reference`.  The reference tree is internally
            inconsistent here: the IN-TREE code (``MPC_Tracking.py:243``)
            compares the RAW arctan2 heading against the wrapped start
            heading, which on westbound paths (raw heading ≈ −π vs wrapped
            start ≈ +π) substitutes the end velocity over essentially the
            whole path — but the PUBLISHED sce2 artifacts show varied
            speed profiles (13% of steps end-velocity-dominated vs 57%
            under raw semantics), i.e. they predate that behavior, exactly
            like the stale sce1 masks/dataset.  Default False = wrapped
            comparison (published-artifact semantics); True mirrors the
            in-tree code for differential tests against the live reference.
    """

    waypoints: np.ndarray
    initial_state: np.ndarray
    raw_jump_guard: bool = False

    def __post_init__(self):
        wp = np.asarray(self.waypoints, float)
        t, x, y = wp[:, 2], wp[:, 0], wp[:, 1]
        if len(t) < 2:
            raise ValueError("at least 2 waypoints required")
        if not np.all(np.diff(t) > 0):
            raise ValueError("waypoint times must be strictly increasing")
        self.t_start, self.t_end = float(t[0]), float(t[-1])
        self._t = t

        kind = _interp_kind(len(t))
        try:
            self._x = interp1d(t, x, kind=kind, bounds_error=False, fill_value="extrapolate")
            self._y = interp1d(t, y, kind=kind, bounds_error=False, fill_value="extrapolate")
        except Exception:
            # linear fallback, mirroring the reference's robustness
            # (``MPC_Tracking.py:138-142``)
            self._x = interp1d(t, x, kind="linear", bounds_error=False, fill_value="extrapolate")
            self._y = interp1d(t, y, kind="linear", bounds_error=False, fill_value="extrapolate")

        dt = np.diff(t)
        dt = np.where(dt == 0, 1e-6, dt)
        # positions at the knots are exact, so velocities are knot diffs
        vx = np.diff(self._x(t)) / dt
        vy = np.diff(self._y(t)) / dt
        vx = np.concatenate(([self.initial_state[-2]], vx))
        vy = np.concatenate(([self.initial_state[-1]], vy))
        t_vel = np.concatenate(([0.0], t[:-1] + np.diff(t) / 2))
        vkind = _interp_kind(len(t_vel))
        try:
            self._vx = interp1d(t_vel, vx, kind=vkind, bounds_error=False, fill_value="extrapolate")
            self._vy = interp1d(t_vel, vy, kind=vkind, bounds_error=False, fill_value="extrapolate")
        except Exception:
            # linear fallback (reference ``MPC_Tracking.py:182-186``)
            self._vx = interp1d(t_vel, vx, kind="linear", bounds_error=False, fill_value="extrapolate")
            self._vy = interp1d(t_vel, vy, kind="linear", bounds_error=False, fill_value="extrapolate")

        self.end_x = float(self._x(self.t_end))
        self.end_y = float(self._y(self.t_end))
        self.start_vx = float(self._vx(self.t_start))
        self.start_vy = float(self._vy(self.t_start))
        self.start_theta = float(_wrap(np.arctan2(self.start_vy, self.start_vx)))

        # end-velocity heuristic: scan the heading at 1 ms resolution; on the
        # first jump > 45° from the start heading, freeze the end velocity at
        # the LAST segment's midpoint (t[-1]+t[-2])/2 — the final velocity
        # knot (reference ``:204-218``, MPC_Tracking.py:213).
        scan_t = np.arange(0.0, t[-1] + 0.001, 0.001)
        th = _wrap(np.arctan2(self._vy(scan_t), self._vx(scan_t)))
        jumped = np.abs(th - self.start_theta) > np.deg2rad(45)
        if np.any(jumped):
            t_mid = (t[-1] + t[-2]) / 2
            self.end_vx = float(self._vx(t_mid))
            self.end_vy = float(self._vy(t_mid))
        else:
            self.end_vx = float(self._vx(self.t_end))
            self.end_vy = float(self._vy(self.t_end))
        self.end_theta = float(_wrap(np.arctan2(self.end_vy, self.end_vx)))

    # -- scalar queries (vectorized over arrays of times) -------------------

    def get_reference(self, t) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(x_ref, y_ref, vx_ref, vy_ref) at time(s) t."""
        t = np.asarray(t, float)
        inside = t <= self.t_end
        ti = np.where(inside, t, self.t_end)
        x = np.where(inside, self._x(ti), self.end_x + self.end_vx * (t - self.t_end))
        y = np.where(inside, self._y(ti), self.end_y + self.end_vy * (t - self.t_end))
        vx = np.where(inside, self._vx(ti), self.end_vx)
        vy = np.where(inside, self._vy(ti), self.end_vy)
        # 90° jump guard: inside the path, if the instantaneous heading is
        # >90° off the start heading, substitute the end velocity — see the
        # raw_jump_guard docstring for the in-tree vs published-artifact
        # semantics choice
        theta = np.arctan2(vy, vx)
        if not self.raw_jump_guard:
            theta = _wrap(theta)
        jump = inside & (np.abs(theta - self.start_theta) > np.pi / 2)
        vx = np.where(jump, self.end_vx, vx)
        vy = np.where(jump, self.end_vy, vy)
        return x, y, vx, vy

    def get_reference_heading(self, t) -> np.ndarray:
        t = np.asarray(t, float)
        _, _, vx, vy = self.get_reference(t)
        theta = np.arctan2(vy, vx)
        theta = np.where(t > self.t_end, self.end_theta, theta)
        return _wrap(theta)

    # -- the full device-ready reference tensor -----------------------------

    def build(self, num_steps: int, horizon: int, dt: float) -> np.ndarray:
        """(num_steps, horizon+1) x [theta_ref, v_ref] tensor.

        Row i column j is the reference at time (i + j) * dt with the
        reference's low-speed heading hold: inside each row, entries with
        v < 0.1 m/s reuse the previous entry's heading (0.0 at row start,
        reference ``step`` ``:466-478``).
        """
        grid_t = np.arange(num_steps + horizon + 1) * dt
        _, _, vx, vy = self.get_reference(grid_t)
        v = np.hypot(vx, vy)
        # heading from the SAME (vx, vy): get_reference_heading would
        # re-evaluate every spline over the grid (2x the host build cost)
        # for bit-identical values — this is its body minus that call
        theta = np.arctan2(vy, vx)
        theta = np.where(grid_t > self.t_end, self.end_theta, theta)
        theta = _wrap(theta)

        idx = np.arange(num_steps)[:, None] + np.arange(horizon + 1)[None, :]
        v_win = v[idx]
        th_win = theta[idx]
        # low-speed hold: forward-fill headings within each row
        valid = v_win >= 0.1
        th_held = np.where(valid, th_win, np.nan)
        for j in range(1, horizon + 1):  # horizon is small (≤ ~30)
            col = th_held[:, j]
            th_held[:, j] = np.where(np.isnan(col), th_held[:, j - 1], col)
        th_held = np.where(np.isnan(th_held), 0.0, th_held)
        return np.stack([th_held, v_win], axis=-1)

    def position_error(self, times: np.ndarray, states_xy: np.ndarray) -> np.ndarray:
        """Euclidean tracking error per step (for validation/plots)."""
        x, y, _, _ = self.get_reference(times)
        return np.hypot(states_xy[:, 0] - x, states_xy[:, 1] - y)
