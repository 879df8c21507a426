"""Surrogate safety metrics: TTC, PET, JERK over SUT episode CSVs.

Vectorized re-implementation of ``SUT_Testing/tools/Metrics_Calculation.py``:
per-scenario episode slicing (``:143-210``), 1-D axis TTC (``:213-249``),
ray-intersection PET (``:19-95``), and ego jerk (``:300-328``).

Port of ``defensive_model_vae_tpu/metrics/surrogate.py`` without pandas: an
episode is a ``data.csv_io.Frame`` (every column float64), and
:func:`compute_metric` returns the sliced ``Frame`` with the metric column
appended.  Host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import scenarios
from ..data.csv_io import Frame, read_csv

EPS_V = 1e-9
EPS_DET = 1e-12


# ---------------------------------------------------------------------------
# episode slicing (reference filter_* functions; note these differ from the
# dataset-extraction masks — cited per scenario below)
# ---------------------------------------------------------------------------

def _first_index(mask: np.ndarray) -> Optional[int]:
    idx = np.flatnonzero(mask)
    return int(idx[0]) if len(idx) else None


def slice_episode(df: Frame, scenario) -> Frame:
    """Per-scenario start/end slicing of one SUT episode log.

    sce1 (``filter_static_blind_town05``, ``:143-154``): start ego_y>0 and
    sv2 moving; end first ego_y>=80 (inclusive).
    sce2 (``:157-168``): start sv1_yaw<-150; end first ego_x<-186.8897.
    sce3 (``:171-188``): start ego_y<40, !=0, sv1 moving; end ego_y<-78.
    sce4 (``:191-210``): start dist<=30 and |sv1_ax|>=0.1; end
    0<|sv1_ax|<0.1 and sv1_yaw<-90 and sv1_x>15.
    """
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    i0 = _first_index(np.asarray(sce.sut_episode_start(df)))
    if i0 is None:
        raise ValueError(f"{sce.town}: no episode start row found")
    sub = df.rows(i0)
    i1 = _first_index(np.asarray(sce.sut_episode_end(sub)))
    if i1 is None:
        return sub
    return sub.rows(0, i1 + 1)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def ttc_1d(df: Frame, scenario) -> np.ndarray:
    """1-D axis time-to-collision (reference ``:213-249``):
    sce1: (sv2_y − ego_y)/(ego_vy − sv2_vy); sce2 same along x with sv2;
    sce3/sce4: y axis with sv1."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    sv, ax = sce.sut_ttc_vehicle, sce.sut_ttc_axis
    num = df[f"{sv}_{ax}"] - df[f"ego_{ax}"]
    den = df[f"ego_v{ax}"] - df[f"{sv}_v{ax}"]
    out = num / np.where(den == 0, np.nan, den)
    out = np.where(np.abs(den) > EPS_V, out, np.nan)
    return out


def pet_rays(df: Frame, scenario) -> np.ndarray:
    """Post-encroachment time via constant-velocity ray intersection
    (reference ``_pet_two_rays``, ``:19-63``): each vehicle moves along its
    yaw direction at its current speed; PET = |t1 − t2| when both reach the
    intersection forward in time, else NaN.  Partner: sv2 for sce1/sce2,
    sv1 for sce3/sce4 (``add_pet_column``, ``:277-286``)."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    sv = sce.pet_partner

    px1 = np.asarray(df["ego_x"], float)
    py1 = np.asarray(df["ego_y"], float)
    sp1 = np.hypot(np.asarray(df["ego_vx"], float), np.asarray(df["ego_vy"], float))
    th1 = np.deg2rad(np.asarray(df["ego_yaw"], float))
    px2 = np.asarray(df[f"{sv}_x"], float)
    py2 = np.asarray(df[f"{sv}_y"], float)
    sp2 = np.hypot(
        np.asarray(df[f"{sv}_vx"], float), np.asarray(df[f"{sv}_vy"], float)
    )
    th2 = np.deg2rad(np.asarray(df[f"{sv}_yaw"], float))

    v1x, v1y = sp1 * np.cos(th1), sp1 * np.sin(th1)
    v2x, v2y = sp2 * np.cos(th2), sp2 * np.sin(th2)
    dpx, dpy = px2 - px1, py2 - py1
    det = v1x * (-v2y) - (-v2x) * v1y
    with np.errstate(all="ignore"):
        t1 = (dpx * (-v2y) - dpy * (-v2x)) / det
        t2 = (v1x * dpy - v1y * dpx) / det
        pet = np.abs(t1 - t2)
    invalid = (
        (np.abs(det) < EPS_DET)
        | (sp1 < EPS_V)
        | (sp2 < EPS_V)
        | (t1 < 0)
        | (t2 < 0)
        | ~np.isfinite(t1)
        | ~np.isfinite(t2)
    )
    pet = np.asarray(pet, float)
    pet[invalid] = np.nan
    return pet


def jerk(df: Frame, scenario) -> np.ndarray:
    """Ego jerk (reference ``add_jerk_column``, ``:300-328``): d(ego_ax)/dt
    for sce2, d(ego_ay)/dt otherwise; dt from sim_time when present, else
    the scenario's default step."""
    sce = scenarios.get(scenario) if isinstance(scenario, str) else scenario
    a = np.asarray(df["ego_" + sce.sut_jerk_axis], float)
    da = np.diff(a, prepend=np.nan)
    if "sim_time" in df:
        t = np.asarray(df["sim_time"], float)
        dt = np.diff(t, prepend=np.nan)
        out = da / dt
        out = np.where(np.abs(dt) > EPS_V, out, np.nan)
    else:
        out = da / sce.dt
    return out


def compute_metric(
    csv_path: str, scenario, metric: str = "TTC"
) -> Frame:
    """Load one SUT CSV, slice the episode, and attach the metric column
    (reference ``compute_metric_from_csv``, ``:331-356``)."""
    m = metric.strip().upper()
    if m not in ("TTC", "PET", "JERK"):
        raise ValueError(f"metric must be TTC / PET / JERK, got {metric!r}")
    df = read_csv(csv_path)
    sub = slice_episode(df, scenario)
    if m == "TTC":
        sub = sub.assign(TTC=ttc_1d(sub, scenario))
    elif m == "PET":
        sub = sub.assign(PET=pet_rays(sub, scenario))
    else:
        sub = sub.assign(JERK=jerk(sub, scenario))
    return sub
