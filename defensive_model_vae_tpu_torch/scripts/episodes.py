"""Write CARLA-format episode CSVs from training windows.

    python -m defensive_model_vae_tpu_torch.scripts.episodes --out DIR \\
        [--scenarios sce1 sce2 sce3 sce4]

An instrument for checking the data and validation path where no CARLA
episode CSV is at hand: each committed window ``fixtures/trajectory_<sce>_
cond.npy`` becomes one episode, written so that ``data.build_dataset`` turns
the tree back into the same windows, bit for bit once cast to float32.

Layout: ``DIR/<town>/<maneuver>/exp_<n>_control_<town>_<suffix>.csv``.  The
windows are split in three runs over ``scenarios.DATASET_ACTIONS`` (the order
``build_dataset`` walks), numbered with zero padding so that each folder's
names sort as strings in window order; the trial suffix cycles 1, 2, 3.

An episode of a window [t, x, y] × 10 of a scenario with step ``dt``:

- ``LEAD_IN`` lead-in rows, the ego run back from the first point at its
  first velocity, where the scenario's dataset start predicate is held false
  through a background-vehicle column (``_HOLD``);
- L = round(t₉ / dt) + 1 ego rows, the first of which opens the window: the
  window's points sit at the indices ``np.linspace(0, L - 1, 10, dtype=int)``
  (⌊i·(L−1)/9⌋) that the extraction samples, with linear interpolation
  between them, so the extraction's time column ``arange(10)·dt·(L−1)/9``
  is the window's;
- one end row, the motion continued one step, with the column of the
  scenario's end predicate set so that it fires (where a window ended short
  of the threshold, the ego jumps to it in that row).

``ego_vx``/``ego_vy`` are forward differences of the track over ``dt`` (the
last ego row repeats its predecessor's), ``ego_yaw`` their heading in
degrees; accelerations, controls and the unused vehicles are 0.  Every mask
of the scenario — dataset start and end, start condition, human start and
end — is defined on every row and hits: the start condition and the human
track start at the first ego row (sce1's ``ego_y >= 40`` where the track
reaches it), and the human track ends at the end row.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Sequence

import numpy as np

from .. import scenarios

LEAD_IN = 10
COLUMNS = ["frame", "id", "throttle", "steer", "brake"] + [
    f"{v}_{q}" for v in ["ego"] + [f"sv{i}" for i in range(1, 7)]
    for q in ("x", "y", "vx", "vy", "ax", "ay", "yaw")]

# each scenario's background-vehicle columns in the lead-in and in the ego
# rows: the dataset start predicate false, then true (and the end predicate
# false); sce4's vehicle 1 is moved beside the ego in the ego rows
_HOLD = {
    "sce1": ({"sv2_vx": 0.0, "sv2_vy": 0.0}, {"sv2_vx": 1.0, "sv2_vy": 1.0}),
    "sce2": ({"sv1_yaw": 0.0}, {"sv1_yaw": -175.0}),
    "sce3": ({"sv1_vx": 0.0, "sv1_vy": 0.0}, {"sv1_vx": 1.0, "sv1_vy": 1.0}),
    "sce4": ({"sv1_yaw": -90.0}, {"sv1_yaw": 0.0}),
}


def _fire_end(key: str, row: dict):
    """Set the end row's columns so that the scenario's end predicate fires."""
    if key == "sce1":
        row["ego_y"] = max(row["ego_y"], 95.0)
    elif key == "sce2":
        row["ego_x"] = min(row["ego_x"], -186.5)
    elif key == "sce3":
        row["ego_y"] = min(row["ego_y"], -80.0)
    else:
        row["sv1_x"], row["sv1_y"], row["sv1_yaw"] = 16.0, row["ego_y"], -90.0


def episode_rows(window: np.ndarray, scenario) -> np.ndarray:
    """The (LEAD_IN + L + 1, len(COLUMNS)) float64 rows of one window's
    episode."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    w = np.asarray(window)
    pts = w[:, 1:3].astype(np.float64)
    P = len(w)
    L = int(round(float(w[-1, 0]) / sce.dt)) + 1
    times = np.arange(P) * sce.dt * ((L - 1) / (P - 1))
    if L < P or not np.array_equal(times.astype(w.dtype), w[:, 0]):
        raise ValueError(f"{sce.key}: no row count gives this window's time column")
    idx = np.linspace(0, L - 1, P, dtype=int)
    k = np.arange(L)
    ego = np.column_stack([np.interp(k, idx, pts[:, 0]), np.interp(k, idx, pts[:, 1])])
    if not np.array_equal(ego[idx], pts):
        raise ValueError(f"{sce.key}: the window's points did not land on their rows")
    vel = np.diff(ego, axis=0) / sce.dt
    vel = np.vstack([vel, vel[-1:]])
    lead = ego[0] - np.arange(LEAD_IN, 0, -1)[:, None] * vel[0] * sce.dt
    end = 2 * ego[-1] - ego[-2]
    xy = np.vstack([lead, ego, end])
    v = np.vstack([np.repeat(vel[:1], LEAD_IN, 0), vel, vel[-1:]])

    col = {c: i for i, c in enumerate(COLUMNS)}
    out = np.zeros((len(xy), len(COLUMNS)))
    out[:, col["frame"]] = np.arange(len(xy))
    out[:, col["ego_x"]], out[:, col["ego_y"]] = xy[:, 0], xy[:, 1]
    out[:, col["ego_vx"]], out[:, col["ego_vy"]] = v[:, 0], v[:, 1]
    out[:, col["ego_yaw"]] = np.degrees(np.arctan2(v[:, 1], v[:, 0]))
    lead_rows, ego_rows = slice(0, LEAD_IN), slice(LEAD_IN, LEAD_IN + L)
    if sce.key == "sce4":
        out[lead_rows, col["sv1_x"]] = xy[lead_rows, 0] + 100.0
        out[lead_rows, col["sv1_y"]] = xy[lead_rows, 1]
        out[ego_rows, col["sv1_x"]] = xy[ego_rows, 0]
        out[ego_rows, col["sv1_y"]] = xy[ego_rows, 1]
    held, moving = _HOLD[sce.key]
    for rows, values in ((lead_rows, held), (ego_rows, moving), (slice(-1, None), moving)):
        for c, value in values.items():
            out[rows, col[c]] = value
    end_row = dict(zip(COLUMNS, out[-1].tolist()))
    _fire_end(sce.key, end_row)
    out[-1] = [end_row[c] for c in COLUMNS]
    return out


def _csv_text(rows: np.ndarray) -> str:
    """Header and rows; each value its shortest repr, which parses back to
    the same float64."""
    cols = []
    for c in rows.T.tolist():
        cols.append([repr(c[0])] * len(c) if c.count(c[0]) == len(c) else list(map(repr, c)))
    return "\n".join([",".join(COLUMNS)] + [",".join(r) for r in zip(*cols)]) + "\n"


def write_episodes(windows: np.ndarray, scenario, root: str) -> List[str]:
    """One episode CSV per window under ``root/<town>/<maneuver>/``; → the
    paths in window order."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    n = len(windows)
    width = len(str(n))
    paths = []
    for action, part in zip(scenarios.DATASET_ACTIONS,
                            np.array_split(np.arange(n), len(scenarios.DATASET_ACTIONS))):
        folder = os.path.join(root, sce.town, action)
        os.makedirs(folder, exist_ok=True)
        for i in part:
            name = f"exp_{i + 1:0{width}d}_control_{sce.town}_{i % 3 + 1}.csv"
            path = os.path.join(folder, name)
            with open(path, "w") as f:
                f.write(_csv_text(episode_rows(windows[i], sce)))
            paths.append(path)
    return paths


def write_fixture_trees(root: str, keys: Sequence[str] = scenarios.keys()) -> dict:
    """The episodes of each scenario's committed windows under ``root``;
    → {key: paths in window order}."""
    return {k: write_episodes(np.load(scenarios.get(k).fixture_windows), k, root)
            for k in keys}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True, help="root of the episode trees")
    ap.add_argument("--scenarios", nargs="+", default=list(scenarios.keys()))
    args = ap.parse_args(argv)
    for key, paths in write_fixture_trees(args.out, args.scenarios).items():
        print(f"{key}: {len(paths)} episodes under "
              f"{os.path.join(args.out, scenarios.get(key).town)}")


if __name__ == "__main__":
    main()
