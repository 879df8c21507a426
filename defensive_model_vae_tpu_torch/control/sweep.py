"""Horizon parameter sweep of the MPC tracker.

Port of ``defensive_model_vae_tpu/control/sweep.py`` (``sweep_horizons``
:30), the reference's control-horizon study (``MPC/test_control_horizon.py``)
as an API: each (prediction, control)-horizon pair tracks the same waypoint
path with the port's ``track`` and reports its position error against the
path's reference.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

from .._device import resolve_device
from .mpc import MPCConfig, track
from .reference import PathReference


@dataclasses.dataclass
class SweepResult:
    prediction_horizon: int
    control_horizon: int
    max_error: float
    mean_error: float
    final_error: float


def sweep_horizons(waypoints: np.ndarray, initial_state: np.ndarray,
                   combos: Sequence[Tuple[int, int]] = ((10, 5), (20, 10), (30, 20),
                                                        (40, 30)),
                   dt: float = 0.02, device="cuda") -> List[SweepResult]:
    """Track ``waypoints`` ((N, 3) [x, y, t]) from ``initial_state`` ([x, y,
    theta, vx, vy]) once per (P, M) in ``combos``; → one ``SweepResult``
    each, its errors in metres."""
    dev = resolve_device(device)
    ref = PathReference(np.asarray(waypoints, float), np.asarray(initial_state, float))
    out: List[SweepResult] = []
    for P, M in combos:
        cfg = MPCConfig(prediction_horizon=P, control_horizon=M, dt=dt)
        times, states, _ = track(waypoints, initial_state, cfg, device=dev)
        err = ref.position_error(times, states[:, :2])
        out.append(SweepResult(P, M, float(err.max()), float(err.mean()), float(err[-1])))
    return out
