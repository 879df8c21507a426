"""The tracker's inputs at the serve configuration, from the sce4 fixture:
what ``chip_smoke.py``, ``scripts/tracker_profile.py`` and the card tests
of the captured step (``tests/test_torch_mpc_graph_card.py``) feed
``mpc._simulate``.

Each of the fixture's windows is a waypoint path read as
``tests/test_mpc.py`` reads one ([x, y, t], its first time 0, the initial
velocity from its first two points); its references are built by the
host ``PathReference`` at P 30, M 20, dt 0.02, and the rows repeat to the
batch.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import scenarios
from .mpc import MPCConfig, _initial_tracker_state
from .reference import PathReference

CFG = MPCConfig(prediction_horizon=30, control_horizon=20, dt=0.02)


def inputs(rows: int, steps: int, dev, cfg: MPCConfig = CFG):
    """(states0 (B, 4), refs (B, S, P+1, 2), last0 (B, 2)) on ``dev``,
    B = ``rows`` and S = ``steps``, P and dt ``cfg``'s."""
    w = np.load(scenarios.get("sce4").fixture_windows)
    w = w[np.arange(rows) % len(w)]
    s0, refs = [], []
    for win in w:
        wp = win[:, [1, 2, 0]].astype(float)
        wp[0, 2] = 0.0
        v0 = (wp[1, :2] - wp[0, :2]) / (wp[1, 2] - wp[0, 2])
        init = np.array([wp[0, 0], wp[0, 1], np.arctan2(v0[1], v0[0]), v0[0], v0[1]])
        refs.append(PathReference(wp, init).build(steps, cfg.prediction_horizon, cfg.dt))
        s0.append(_initial_tracker_state(init))
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.tensor(np.stack(s0), **f32), torch.tensor(np.stack(refs), **f32),
            torch.zeros((rows, 2), **f32))
