"""Velocity-distribution metrics.

Port of ``defensive_model_vae_tpu/metrics/distribution.py``: the same
numpy operations in the same order.

Re-implements the reference's velocity extraction and Jensen–Shannon
divergence (``Distribution.py:195-333``) as vectorized array ops:

- model velocities: column 3 of each tracked [x, y, theta, v] state trace
- human velocities: finite differences of [x, y, t] tracks, repeating the
  previous value across zero time steps (carried across tracks, like the
  reference's shared list) and duplicating the last value
- JS divergence: base-2, over a shared ``bins``-EDGE grid (the reference
  passes 50 to np.linspace, i.e. 49 bins) spanning the pooled min/max,
  with the reference's epsilon regularization — range [0, 1]
"""

from __future__ import annotations

from typing import Iterable, List, Sequence

import numpy as np


def extract_velocities(trajectories: Iterable[np.ndarray]) -> np.ndarray:
    """All per-step speeds of tracked [N, 4] state traces
    (reference ``extract_velocities_from_trajectories``, ``:195-210``)."""
    vs = [np.asarray(t)[:, 3] for t in trajectories]
    return np.concatenate(vs) if vs else np.array([])


def _track_velocities(traj: np.ndarray) -> np.ndarray:
    """Speeds of one [x, y, t] track, reference semantics
    (``calculate_human_velocities``, ``:248-296``): v_i over segment i; if a
    segment's dt ≤ 1e-6, repeat the previous speed (0 if none); the final
    point repeats the last segment speed."""
    t = traj[:, 2]
    dxy = np.diff(traj[:, :2], axis=0)
    dt = np.diff(t)
    seg = np.hypot(dxy[:, 0], dxy[:, 1]) / np.where(dt > 1e-6, dt, 1.0)
    valid = dt > 1e-6
    out: List[float] = []
    for v, ok in zip(seg, valid):  # small per-track loop (carries last value)
        if ok:
            out.append(float(v))
        else:
            out.append(out[-1] if out else 0.0)
    if len(traj) > 1:
        out.append(out[-1] if valid[-1] or out else 0.0)
        # reference recomputes the last segment; identical to out[-1] above
    return np.asarray(out)


def human_velocities(human_trajectories: Sequence[np.ndarray]) -> np.ndarray:
    """All tracks' speeds, reference semantics — including the quirk that
    ``calculate_human_velocities`` keeps ONE shared list across tracks
    (``Distribution.py:258-295``), so a zero-dt FIRST segment inherits the
    previous track's last speed, not 0 (per-track callers that want a
    fresh 0 carry use :func:`_track_velocities`)."""
    out: List[float] = []
    for traj in human_trajectories:
        traj = np.asarray(traj)
        if len(traj) <= 1:
            continue
        dxy = np.diff(traj[:, :2], axis=0)
        dt = np.diff(traj[:, 2])
        seg = np.hypot(dxy[:, 0], dxy[:, 1]) / np.where(dt > 1e-6, dt, 1.0)
        valid = dt > 1e-6
        for v, ok in zip(seg, valid):
            out.append(float(v) if ok else (out[-1] if out else 0.0))
        # final point repeats the last segment's value (recomputed when
        # valid — identical to the value just appended; carried otherwise)
        out.append(out[-1])
    return np.asarray(out)


def _kl(p: np.ndarray, q: np.ndarray, base: float = 2.0) -> float:
    """KL divergence with scipy.stats.entropy semantics: inputs are
    renormalized to sum to 1 before the divergence is taken."""
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum(p * (np.log(p) - np.log(q))) / np.log(base))


def velocity_js_divergence(
    generated: np.ndarray, human: np.ndarray, bins: int = 50
) -> float:
    """Base-2 JS divergence over shared bins (reference ``:299-333``).

    ``bins`` counts histogram EDGES, mirroring the reference's
    ``np.linspace(v_min, v_max, 50)`` — the default is 49 actual bins."""
    v_min = min(generated.min(), human.min())
    v_max = max(generated.max(), human.max())
    edges = np.linspace(v_min, v_max, bins)
    hg, _ = np.histogram(generated, bins=edges)
    hh, _ = np.histogram(human, bins=edges)
    hg = hg / (hg.sum() + 1e-10)
    hh = hh / (hh.sum() + 1e-10)
    m = 0.5 * (hg + hh)
    eps = 1e-10
    return 0.5 * (_kl(hg + eps, m + eps) + _kl(hh + eps, m + eps))
