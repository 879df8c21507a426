"""Drivable area (DA) and risk level (RL).

- DA (``Calculate_Drivable_Area``, ``dnda_functions.py:1620-1767``): stitch
  the collision-truncated left/right rectangle corners of the usable paths
  into one polygon and take its shoelace area.
- RL (``Calculate_RiskLevel``, ``:1771-1839``): Gaussian-curvature-weighted
  collision-free arc length vs total arc length,
  RL = 1 − Σ w(k_i)·(C_i+1)·u_i / Σ w(k_i)·(N_i+1)·u_i, with
  w(k) = pdf_N(0, σ=k_max_all/2)(k).  (The reference's inner loops apply a
  j-independent factor; they collapse to the closed form used here.)
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def shoelace_area(xs: Sequence[float], ys: Sequence[float]) -> float:
    x = np.asarray(xs, float)
    y = np.asarray(ys, float)
    return float(np.abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1))) / 2)


def drivable_area(
    usable_num: int,
    ego_rects: List[np.ndarray],
    collision_index: np.ndarray,
) -> float:
    """Polygon area of the reachable envelope.

    Corner conventions per rectangle (2, 4): column 1 = front-left chain,
    column 3 = rear-right chain, column 0 = front-right tip, column 2 =
    rear-left anchor (reference stitching rules ``:1652-1716``).

    The per-point append loops of the original formulation are expressed as
    fancy-indexed segments of the (n, 2, 4) rectangle sweeps; ``fwd``/``rev``
    take exactly the original ``range(a, b+1)`` / ``range(a, b-1, -1)``
    index sequences, so a NEGATIVE neighbor index (``ci == -1``: collision
    at the first rectangle) wraps to the last rectangle just like the
    original scalar ``rects[j]`` did — a preserved quirk — and an
    out-of-range index raises IndexError as before (frame skipped by the
    episode driver)."""
    segs: List[np.ndarray] = []  # (2, len) polygon segments, in chain order
    collided_flags = []

    def fwd(rects, a, b, col):  # rects[j][:, col] for j in a..b inclusive
        segs.append(rects[np.arange(a, b + 1), :, col].T)

    def rev(rects, a, b, col):  # rects[j][:, col] for j in a..b descending
        segs.append(rects[np.arange(a, b - 1, -1), :, col].T)

    ci = collision_index
    for i in range(usable_num):
        if ci[i] < 0:
            collided_flags.append(True)
            continue
        collided_flags.append(False)
        rects = ego_rects[i]

        if i == 0:
            if usable_num == 1:
                fwd(rects, 0, ci[i], 1)
                fwd(rects, ci[i], ci[i], 0)
                rev(rects, ci[i], 0, 3)
                continue
            fwd(rects, 0, ci[i], 1)
            fwd(rects, ci[i], ci[i], 0)
            if ci[i] > ci[i + 1]:
                rev(rects, ci[i], ci[i + 1], 3)

        if 0 < i < usable_num - 1:
            if ci[i] > ci[i - 1]:
                fwd(rects, ci[i - 1], ci[i], 0)
                if ci[i] > ci[i + 1]:
                    rev(rects, ci[i], ci[i + 1], 3)
            else:
                if ci[i] > ci[i + 1]:
                    rev(rects, ci[i], ci[i + 1], 3)
                elif ci[i] == ci[i + 1]:
                    fwd(rects, ci[i], ci[i], 3)

        if i == usable_num - 1 and usable_num > 1:
            if ci[i] > ci[i - 1]:
                fwd(rects, ci[i - 1], ci[i], 0)
            rev(rects, ci[i], 0, 3)
            fwd(rects, 0, 0, 2)

    if usable_num == 0 or all(collided_flags):
        return 0.0
    pts = np.concatenate(segs, axis=1)
    # contiguous rows: np.dot on the strided rows concatenate can return
    # (F-ordered from the .T segments) takes a different BLAS summation
    # path than the original list→asarray layout, drifting the area at
    # machine epsilon; contiguous inputs reproduce it bit-for-bit
    return shoelace_area(np.ascontiguousarray(pts[0]),
                         np.ascontiguousarray(pts[1]))


def risk_level(
    usable_paths: Sequence[int],
    k_maxes: Sequence[float],
    collision_index: np.ndarray,
    unit_arc_paths: Sequence[float],
    ego_speed: float,
    time_horizon: float,
) -> float:
    """RL ∈ [0, 1]: 1 − weighted free length / weighted total length."""
    k_all = float(np.max(k_maxes))
    sigma = k_all / 2.0
    usable = np.asarray(usable_paths)
    k = np.asarray([k_maxes[i] for i in usable])
    w = np.power(np.sqrt(2 * np.pi) * sigma, -1.0) * np.exp(-(k**2) / (2 * sigma**2))
    u = np.asarray(unit_arc_paths, float)
    non_collision = np.ceil(ego_speed * time_horizon / u).astype(int)
    total = np.sum(w * (non_collision + 1) * u)
    if total == 0.0:
        # no usable path (or fully degenerate weights): the reference's
        # Python-int division raises ZeroDivisionError here, which the
        # episode driver catches to SKIP the frame — numpy's silent 0/0
        # NaN would instead poison max() over the episode's DNDA values
        raise ZeroDivisionError("risk_level: zero weighted total length")
    free = np.sum(w * (np.asarray(collision_index) + 1) * u)
    return float((total - free) / total)
