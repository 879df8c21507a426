"""Start-velocity and time-headway (THW) analysis.

Port of ``defensive_model_vae_tpu/metrics/thw.py``, over the port's
start conditions (``data.get_start_conditions``).

Re-implements ``Get_THW.py``: per-CSV start speed from the scenario start
conditions, THW = scenario trigger distance / start speed (60 m for sce1,
80 m for sce3; sce4 uses 40 m for trial suffix '3' else 30 m —
``Get_THW.py:66-104``).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np

from .. import scenarios
from ..data import get_start_conditions


def start_velocities(
    csv_files: Sequence[str], scenario
) -> List[Tuple[str, float]]:
    """(csv_name, start_speed) per file (reference ``:15-63``)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    out = []
    for path in csv_files:
        sc = get_start_conditions(path, sce)
        # maneuver-qualified name: the three subfolders may reuse file
        # names, and dict-keyed consumers would silently collapse them
        name = os.path.join(
            os.path.basename(os.path.dirname(path)), os.path.basename(path)
        )
        out.append((name, float(np.hypot(sc.vx, sc.vy))))
    return out


def thw_values(
    start_vs: Sequence[Tuple[str, float]], scenario
) -> np.ndarray:
    """THW = trigger distance / start speed (reference ``:66-104``)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    thws = []
    for name, v in start_vs:
        if sce.thw_distance is not None:
            d = sce.thw_distance
        elif sce.thw_distance_by_suffix is not None:
            suffix = name.rsplit(".", 1)[0].rsplit("_", 1)[-1]
            d = sce.thw_distance_by_suffix.get(
                suffix, sce.thw_distance_by_suffix["default"]
            )
        else:
            raise ValueError(f"no THW distance defined for {sce.key}")
        thws.append(d / v if v > 0 else np.nan)
    return np.asarray(thws)
