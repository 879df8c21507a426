"""Cartesian → Frenet resampling (reference ``Cartesian_trans_Frenet``,
``dnda_functions.py:255-451``).

Port of ``defensive_model_vae_tpu/dnda/frenet.py``: the resample runs in the
native spline library (``spline.frenet_native``), which has no fallback;
:func:`cartesian_to_frenet_numpy` is its plain version, used where the native
code rejects an input and by the tests.

Algorithm (re-derived, vectorized):
1. rotate the polyline so its endpoint chord aligns with +x,
2. spline-resample y(x) at ``m_equal`` equally spaced x samples,
3. measure the chordal arc length of the resampled curve,
4. re-divide the resampled polyline into ``m_equal`` equal-arc-length
   segments (linear within chords), prepend the start point,
5. rotate back and fit FMM splines x(s), y(s) over the uniform arc grid —
   their (b, c, d) coefficients are what downstream consumers use as first/
   second derivative surrogates (``way.d1* = b``, ``way.d2* = c``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from .spline import fmm_spline_coeffs, frenet_native, spline_eval


@dataclasses.dataclass
class Way:
    """Path in arc-length parameterization (reference ``Way`` class)."""

    baseline_x: np.ndarray
    baseline_y: np.ndarray
    d1x: np.ndarray  # b coefficients of x(s) — first-derivative surrogate
    d2x: np.ndarray  # c coefficients — (half) second-derivative surrogate
    d1y: np.ndarray
    d2y: np.ndarray
    kb: np.ndarray = None  # curvature (reference formula on the surrogates)
    theta: np.ndarray = None

    def compute_curvature(self, absolute: bool = False, eps: float = 1e-10):
        self.kb, self.theta = curvature_theta(
            self.d1x, self.d2x, self.d1y, self.d2y, absolute, eps
        )
        return self


def curvature_theta(d1x, d2x, d1y, d2y, absolute: bool = False,
                    eps: float = 1e-10):
    """(kb, theta) from the derivative surrogates — elementwise over any
    leading shape, so a whole frame's path cluster batches into one call
    (bit-identical to per-path evaluation)."""
    denom = (d1x**2 + d1y**2) ** 1.5 + eps
    kb = (d1x * d2y - d2x * d1y) / denom
    if absolute:
        kb = np.abs(kb)
    theta = np.where(
        np.abs(d1x) > eps,
        np.arctan(d1y / np.where(np.abs(d1x) > eps, d1x, 1.0)),
        np.where(d1y > 0, np.pi / 2, -np.pi / 2),
    )
    return kb, theta


def _rotation(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s], [s, c]])


def cartesian_to_frenet(
    baseline_xy: np.ndarray, m_equal: int
) -> Tuple[
    float, float, np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
    np.ndarray,
]:
    """Resample a polyline at uniform arc length.

    Args:
        baseline_xy: (N, 2) polyline.
        m_equal: number of equal segments.

    Returns:
        (unit_arc, arc_len, trans_xy (m_equal+1, 2), bx, cx, by, cy, s_grid)
        where (bx, cx) / (by, cy) are the FMM coefficients of x(s) / y(s)
        (the reference's a2/a1 arrays) and s_grid = i * unit_arc.

    Runs the native C++ code (``native/dnda_spline.cpp``, ``dmv_frenet``);
    :func:`cartesian_to_frenet_numpy` is the arithmetic oracle it matches to
    the last ulp, and computes the inputs the native code rejects.
    """
    out = frenet_native(np.asarray(baseline_xy, float), m_equal)
    if out is not None:
        return out
    return cartesian_to_frenet_numpy(baseline_xy, m_equal)


def cartesian_to_frenet_numpy(baseline_xy: np.ndarray, m_equal: int):
    """Pure-numpy reference implementation (oracle for the native kernel)."""
    pts = np.asarray(baseline_xy, float)
    chord = pts[-1] - pts[0]
    rot_deg = np.arccos(
        np.clip(chord[0] / np.linalg.norm(chord), -1.0, 1.0)
    )
    if chord[1] < 0:
        rot_deg = -rot_deg
    fwd = _rotation(-rot_deg)
    p = pts @ fwd.T  # rotated so chord is +x

    x, y = p[:, 0], p[:, 1]
    u = x[0] + np.arange(m_equal) * (x[-1] - x[0]) / (m_equal - 1)
    b, c, d = fmm_spline_coeffs(x, y)
    s, _ = spline_eval(x, y, b, c, d, u)

    seg = np.hypot(np.diff(u), np.diff(s))  # (m_equal-1,)
    arc_len = float(seg.sum())
    unit_arc = arc_len / m_equal

    # equal-arc re-division over the resampled polyline; target arcs are
    # (k+1)*unit_arc.  Reference quirk (``:367``): segment lookup allows a
    # +0.001 tolerance at the far end; cumulative targets never exceed
    # total-unit_arc so a plain searchsorted on the cumulative lengths is
    # equivalent.
    cum = np.concatenate([[0.0], np.cumsum(seg)])  # (m_equal,)
    targets = (np.arange(m_equal) + 1) * unit_arc
    idx = np.searchsorted(cum, targets, side="left") - 1
    idx = np.clip(idx, 0, m_equal - 2)
    frac = targets - cum[idx]
    seg_len = seg[idx]
    with np.errstate(invalid="ignore", divide="ignore"):
        cosv = np.diff(u)[idx] / seg_len
        sinv = np.diff(s)[idx] / seg_len
    same_x = np.diff(u)[idx] == 0
    newx = np.where(same_x, u[idx], u[idx] + frac * cosv)
    newy = np.where(
        same_x,
        s[idx] + np.sign(np.diff(s)[idx] + 0.0) * frac,
        s[idx] + frac * sinv,
    )
    new_pts = np.column_stack([newx, newy])
    new_pts = np.vstack([[u[0], s[0]], new_pts])  # prepend start

    back = _rotation(rot_deg)
    trans = new_pts @ back.T  # (m_equal+1, 2)

    s_grid = np.arange(m_equal + 1) * unit_arc
    bx, cx, _ = fmm_spline_coeffs(s_grid, trans[:, 0])
    by, cy, _ = fmm_spline_coeffs(s_grid, trans[:, 1])
    return unit_arc, arc_len, trans, bx, cx, by, cy, s_grid


def way_from_baseline(baseline_xy: np.ndarray, m_equal: int, absolute_curvature=False):
    unit_arc, arc_len, trans, bx, cx, by, cy, s_grid = cartesian_to_frenet(
        baseline_xy, m_equal
    )
    way = Way(
        baseline_x=trans[:, 0],
        baseline_y=trans[:, 1],
        d1x=bx,
        d2x=cx,
        d1y=by,
        d2y=cy,
    ).compute_curvature(absolute=absolute_curvature)
    return way, unit_arc, arc_len, s_grid
